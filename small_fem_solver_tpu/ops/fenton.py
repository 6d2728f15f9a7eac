"""Fenton stream-function wave theory (fully nonlinear), pure jnp.

Capability parity with the reference's raschii ``FentonWave`` path
(`/root/reference/JacketAnalysisGUI_v2.py:234-242`), implemented from the
published method: M.M. Rienecker & J.D. Fenton, "A Fourier approximation
method for steady water waves", J. Fluid Mech. 104 (1981), as refined in
Fenton, "The numerical solution of steady water wave problems", Computers &
Geosciences 14 (1988).

Device-first design: the nonlinear collocation system is solved by a
fixed-iteration Newton method written in jnp (Jacobian via ``jax.jacfwd``,
dense solve) with wave-height continuation for steep waves — so wave *setup*
is itself jittable and vmappable over (H, T) case batches, and the result is
lowered to the same canonical :class:`FourierWave` coefficient pytree every
other model uses.  Evaluation therefore shares the one batched kinematics
kernel.

Formulation (wave frame, z measured from the sea bed, theta = k x):

    psi(x, z) = B0 z + sum_j B_j sinh(j k z)/cosh(j k d) cos(j theta)
    u_f = dpsi/dz,  w_f = -dpsi/dx,   B0 = -c  (zero mean Eulerian current,
    Stokes' first definition — the raschii default the reference relies on)

Unknowns  q = [eta_0..eta_M, B_1..B_N, B0, k, Q, R]  with M = N collocation
points over half a wavelength (theta_m = m pi / M; the wave is symmetric).
Equations:

    KFSBC   psi(x_m, eta_m) = Q                       (M+1)
    DFSBC   (u_f^2 + w_f^2)/2 + g eta_m = R           (M+1)
    mean    trapezoid mean of eta = d                  (1)
    height  eta_0 - eta_M = H                          (1)
    period  -B0 k = omega                              (1)

After the solve, the fixed-frame velocity u = u_f + c gives the canonical
coefficients U_hat_j = j k B_j, and the surface cosine coefficients E_j come
from the type-I discrete cosine transform of eta_m - d (exact for the M-mode
collocation representation).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import G_GRAV
from .dispersion import solve_dispersion
from .waves import FourierWave


def _residual(q, d, H, omega, M, g):
    """The 2M+5 collocation equations; q = [eta(M+1), B(N=M), B0, k, Q, R]."""
    eta = q[: M + 1]
    B = q[M + 1: 2 * M + 1]
    B0 = q[2 * M + 1]
    k = q[2 * M + 2]
    Q = q[2 * M + 3]
    R = q[2 * M + 4]

    j = jnp.arange(1, M + 1, dtype=q.dtype)            # [N]
    theta = jnp.pi * jnp.arange(M + 1, dtype=q.dtype) / M  # [M+1]
    cjt = jnp.cos(jnp.outer(theta, j))                 # [M+1, N]
    sjt = jnp.sin(jnp.outer(theta, j))

    # hyperbolic profiles at the (unknown) surface heights, normalized by
    # cosh(j k d) for overflow safety (eta ~ d, so the ratio is O(1))
    A = j * k * eta[:, None]
    Bd = j * k * d
    scale = jnp.exp(A - Bd) / (1.0 + jnp.exp(-2.0 * Bd))
    Cj = scale * (1.0 + jnp.exp(-2.0 * A))             # cosh(jk eta)/cosh(jkd)
    Sj = scale * (1.0 - jnp.exp(-2.0 * A))             # sinh(jk eta)/cosh(jkd)

    psi = B0 * eta + (Sj * cjt) @ B
    u_f = B0 + ((j * k) * Cj * cjt) @ B
    w_f = ((j * k) * Sj * sjt) @ B

    r_kfsbc = psi - Q
    r_dfsbc = 0.5 * (u_f**2 + w_f**2) + g * eta - R
    r_mean = (0.5 * eta[0] + jnp.sum(eta[1:M]) + 0.5 * eta[M]) / M - d
    r_height = eta[0] - eta[M] - H
    r_period = -B0 * k - omega
    return jnp.concatenate([
        r_kfsbc, r_dfsbc,
        jnp.stack([r_mean, r_height, r_period]),
    ])


def _initial_guess(H, T, d, M, dtype):
    omega = 2.0 * jnp.pi / T
    k = solve_dispersion(omega, d)
    c = omega / k
    a = H / 2.0
    theta = jnp.pi * jnp.arange(M + 1, dtype=dtype) / M
    eta = d + a * jnp.cos(theta)
    B = jnp.zeros((M,), dtype=dtype)
    # linear-theory B_1: u = a omega cosh(kz)/sinh(kd) cos -> j k B1 / cosh(kd)
    B = B.at[0].set(a * omega / (k * jnp.tanh(k * d)))
    B0 = -c
    Q = B0 * d
    R = 0.5 * B0**2 + G_GRAV * d
    return jnp.concatenate([eta, B, jnp.stack([B0, k, Q, R])])


@partial(jax.jit, static_argnames=("M", "n_newton", "n_cont"))
def _solve_fenton(H, T, d, M: int, n_newton: int = 12, n_cont: int = 10):
    """Height-continuation Newton solve; returns the unknown vector q.

    Wave height is ramped 0 -> H in ``n_cont`` steps (Rienecker & Fenton's
    recommendation for steep waves); each step runs ``n_newton`` full Newton
    iterations with the exact jacfwd Jacobian.
    """
    dtype = jnp.result_type(H, T, d, 1.0)
    H = jnp.asarray(H, dtype=dtype)
    T = jnp.asarray(T, dtype=dtype)
    d = jnp.asarray(d, dtype=dtype)
    g = jnp.asarray(G_GRAV, dtype=dtype)
    omega = 2.0 * jnp.pi / T

    q0 = _initial_guess(H / n_cont, T, d, M, dtype)

    def newton_step(q, Hi):
        r = _residual(q, d, Hi, omega, M, g)
        J = jax.jacfwd(_residual)(q, d, Hi, omega, M, g)
        return q - jnp.linalg.solve(J, r)

    def cont_step(q, i):
        Hi = H * (i + 1.0) / n_cont
        q = jax.lax.fori_loop(0, n_newton, lambda _, qq: newton_step(qq, Hi), q)
        return q, None

    q, _ = jax.lax.scan(cont_step, q0, jnp.arange(n_cont, dtype=dtype))
    return q


def fenton_wave(H, T, d, U_c=0.0, N: int = 10, n_modes: int | None = None,
                dtype=jnp.float64, n_newton: int = 12,
                n_cont: int = 10, check: bool = True) -> FourierWave:
    """Fully nonlinear stream-function wave in canonical Fourier form.

    ``N`` is the number of Fourier modes / collocation intervals (the
    reference passes raschii N=10-20 chosen from steepness,
    `JacketAnalysisGUI_v2.py:234`).  ``check=True`` verifies the collocation
    residual host-side and raises for non-converged (e.g. above-breaking)
    waves, mirroring the reference's behavior of surfacing raschii failures
    as errors; pass ``check=False`` inside jit/vmap contexts.
    """
    M = int(N)
    # The collocation Newton needs float64 (the Jacobian is ill-conditioned
    # near steep crests); run the setup solve on CPU in f64 regardless of the
    # session/backend dtype, then cast the resulting coefficients to the
    # requested evaluation dtype.  This mirrors the reference, where wave
    # setup happens once per case on the host (raschii's internal solve,
    # `JacketAnalysisGUI_v2.py:234-242`), while *evaluation* stays on-device.
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        q = _solve_fenton(jnp.asarray(float(H), dtype=jnp.float64),
                          jnp.asarray(float(T), dtype=jnp.float64),
                          jnp.asarray(float(d), dtype=jnp.float64), M,
                          n_newton=n_newton, n_cont=n_cont)
        q = np.asarray(q)
    wave = fenton_wave_from_solution(jnp.asarray(q, dtype=dtype), H, T, d,
                                     U_c, M, n_modes=n_modes, dtype=dtype)
    if check:
        g = G_GRAV
        omega = 2.0 * np.pi / float(T)
        with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
            r = np.asarray(_residual(jnp.asarray(q, dtype=jnp.float64),
                                     jnp.asarray(float(d), dtype=jnp.float64),
                                     jnp.asarray(float(H), dtype=jnp.float64),
                                     omega, M,
                                     jnp.asarray(g, dtype=jnp.float64)))
        scale = max(g * float(d), 1.0)
        if not np.isfinite(r).all() or np.abs(r).max() > 1e-6 * scale:
            raise ValueError(
                f"Fenton stream-function solve did not converge for H={H}, "
                f"T={T}, d={d} (residual {np.abs(r).max():.2e}); the wave may "
                f"exceed the breaking limit")
    return wave


def fenton_wave_batch(H, T, d, U_c=0.0, N: int = 10,
                      n_modes: int | None = None, dtype=jnp.float32,
                      n_newton: int = 12, n_cont: int = 10,
                      check: bool = True) -> FourierWave:
    """Batched Fenton setup: ONE vmapped continuation-Newton over (H, T).

    ``_solve_fenton`` is a fixed-iteration jitted Newton with wave-height
    continuation, so a (H, T) case batch vmaps straight through it — a
    1,000-case storm population is one compiled float64 program instead of
    1,000 sequential host solves (the round-2 ``make_wave_batch('fenton')``
    looped host-side; the reference performs raschii's internal solve once
    per case, `/root/reference/JacketAnalysisGUI_v2.py:234-242`).

    ``d`` and ``U_c`` may be scalars or per-case arrays.  ``check=True``
    verifies all collocation residuals in one batched evaluation and raises
    naming the non-converged case indices (e.g. above-breaking waves).
    Returns a batched :class:`FourierWave` (leading case axis) ready for
    ``design_envelope`` / ``design_envelope_condensed``.
    """
    M = int(N)
    H = np.atleast_1d(np.asarray(H, np.float64))
    T = np.broadcast_to(np.asarray(T, np.float64), H.shape)
    d_b = np.broadcast_to(np.asarray(d, np.float64), H.shape)
    Uc_b = np.broadcast_to(np.asarray(U_c, np.float64), H.shape)

    # the collocation Newton runs in float64 on the host CPU (as in
    # fenton_wave — the Jacobian is ill-conditioned near steep crests);
    # only the SOLVE is batched here, evaluation happens on-device later
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        f64 = jnp.float64
        solve = jax.jit(jax.vmap(
            lambda h, t, dd: _solve_fenton(h, t, dd, M, n_newton=n_newton,
                                           n_cont=n_cont)))
        q = solve(jnp.asarray(H, f64), jnp.asarray(T, f64),
                  jnp.asarray(d_b, f64))
        q_np = np.asarray(q)
        if check:
            omega = 2.0 * np.pi / T
            res = jax.jit(jax.vmap(
                lambda qq, dd, hh, ww: _residual(
                    qq, dd, hh, ww, M, jnp.asarray(G_GRAV, f64))))(
                q, jnp.asarray(d_b, f64), jnp.asarray(H, f64),
                jnp.asarray(omega, f64))
            res = np.asarray(res)
            scale = np.maximum(G_GRAV * d_b, 1.0)
            bad = ~(np.isfinite(res).all(axis=1)
                    & (np.abs(res).max(axis=1) <= 1e-6 * scale))
            if bad.any():
                idx = np.where(bad)[0]
                raise ValueError(
                    f"Fenton stream-function solve did not converge for "
                    f"{idx.size} of {H.size} cases (indices {idx[:10]}, "
                    f"e.g. H={H[idx[0]]}, T={T[idx[0]]}, d={d_b[idx[0]]}); "
                    f"the waves may exceed the breaking limit")

    lower = jax.vmap(lambda qq, hh, tt, dd, uc: fenton_wave_from_solution(
        qq, hh, tt, dd, uc, M, n_modes=n_modes, dtype=dtype))
    return lower(jnp.asarray(q_np, dtype=dtype),
                 jnp.asarray(H, dtype=dtype), jnp.asarray(T, dtype=dtype),
                 jnp.asarray(d_b, dtype=dtype),
                 jnp.asarray(Uc_b, dtype=dtype))


def fenton_wave_from_solution(q, H, T, d, U_c, M: int,
                              n_modes: int | None = None,
                              dtype=jnp.float64) -> FourierWave:
    """Lower a collocation solution vector to the canonical FourierWave."""
    eta = q[: M + 1]
    B = q[M + 1: 2 * M + 1]
    k = q[2 * M + 2]
    omega = 2.0 * jnp.pi / jnp.asarray(T, dtype=dtype)
    c = omega / k

    # E_j: type-I DCT of eta - d over the half-wavelength collocation grid.
    # The inverse DCT-I carries a 1/2 weight on the j = M (Nyquist) term, so
    # its forward coefficient takes 1/M, not 2/M — without the halving the
    # reconstructed surface misses the collocation heights by O(mm).
    j = jnp.arange(1, M + 1, dtype=dtype)
    theta = jnp.pi * jnp.arange(M + 1, dtype=dtype) / M
    w = jnp.ones((M + 1,), dtype=dtype).at[0].set(0.5).at[M].set(0.5)
    E = (2.0 / M) * jnp.einsum("m,mj->j", w * (eta - d), jnp.cos(jnp.outer(theta, j)))
    E = E.at[-1].multiply(0.5)
    U = j * k * B

    n_modes = n_modes or M
    if n_modes > M:
        pad = jnp.zeros((n_modes - M,), dtype=dtype)
        E = jnp.concatenate([E, pad])
        U = jnp.concatenate([U, pad])
    elif n_modes < M:
        raise ValueError("n_modes must be >= N")

    return FourierWave(
        k=k, omega=omega, c=c, d=jnp.asarray(d, dtype=dtype),
        U_c=jnp.asarray(U_c, dtype=dtype), H=jnp.asarray(H, dtype=dtype),
        T=jnp.asarray(T, dtype=dtype), E=E, U=U,
        clamp_z=True, model="fenton", order=M,
    )
