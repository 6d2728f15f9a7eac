"""Stokes wave theory (orders 1-5), Fenton (1985) formulation, pure jnp.

Capability parity with the reference's raschii ``StokesWave`` path
(`/root/reference/JacketAnalysisGUI_v2.py:226-231,244-248`), implemented from
the published theory rather than by wrapping a NumPy library: J.D. Fenton,
"A fifth-order Stokes theory for steady waves", J. Waterway, Port, Coastal
and Ocean Engineering 111(2), 1985 (with the standard erratum to A44/C2).

Device-first design: the construction lowers (H, T, d) to the canonical
:class:`~small_fem_solver_tpu.ops.waves.FourierWave` coefficient pytree — a
5-mode cosine series for the surface and a 5-mode velocity series — so
evaluation shares the single batched kinematics kernel with every other wave
model, and construction itself is jit/vmap-able (the dispersion solve is a
fixed-count Newton on a smooth scalar residual) for (H, T) design sweeps.

Conventions: theta = k x - omega t; zero mean Eulerian current (Stokes first
definition of celerity), matching raschii's default used by the reference;
any uniform current is handled downstream exactly as the reference does
(added to u, `JacketAnalysisGUI_v2.py:281`).

Fenton's expansion parameter is eps = k H / 2.  Surface elevation
(Fenton 1985 eq. 14):

    k eta = kd + eps cos t + eps^2 B22 cos 2t + eps^3 B31 (cos t - cos 3t)
            + eps^4 (B42 cos 2t + B44 cos 4t)
            + eps^5 (-(B53 + B55) cos t + B53 cos 3t + B55 cos 5t)

Velocity field from the potential (eq. 12):

    u - (wave frame) = C0 sqrt(g/k) sum_j [ j sum_i eps^i A_ij ] cosh(j k Z)
                       cos(j theta) / cosh(j k d) * cosh(j k d)   (Z from bed)

so in the canonical normalized form U_hat_j = C0 sqrt(g/k) j
(sum_i eps^i A_ij) cosh(j k d).

Dispersion (eq. 15, zero current): omega/k = sqrt(g/k) (C0 + eps^2 C2
+ eps^4 C4), solved for k by Newton with the exact jnp derivative.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import G_GRAV
from .dispersion import solve_dispersion
from .waves import FourierWave


def _fenton_coefficients(kd):
    """A_ij, B_ij, C_i polynomials in S = sech(2kd) (Fenton 1985, Table 1)."""
    S = 1.0 / jnp.cosh(2.0 * kd)
    sh = jnp.sinh(kd)
    th = jnp.tanh(kd)
    cth = 1.0 / th
    Sm1 = 1.0 - S

    A = {}
    A[1, 1] = 1.0 / sh
    A[2, 2] = 3.0 * S**2 / (2.0 * Sm1**2)
    A[3, 1] = (-4.0 - 20.0 * S + 10.0 * S**2 - 13.0 * S**3) / (8.0 * sh * Sm1**3)
    A[3, 3] = (-2.0 * S**2 + 11.0 * S**3) / (8.0 * sh * Sm1**3)
    A[4, 2] = (12.0 * S - 14.0 * S**2 - 264.0 * S**3 - 45.0 * S**4
               - 13.0 * S**5) / (24.0 * Sm1**5)
    A[4, 4] = (10.0 * S**3 - 174.0 * S**4 + 291.0 * S**5
               + 278.0 * S**6) / (48.0 * (3.0 + 2.0 * S) * Sm1**5)
    A[5, 1] = (-1184.0 + 32.0 * S + 13232.0 * S**2 + 21712.0 * S**3
               + 20940.0 * S**4 + 12554.0 * S**5 - 500.0 * S**6
               - 3341.0 * S**7 - 670.0 * S**8) / (
                   64.0 * sh * (3.0 + 2.0 * S) * (4.0 + S) * Sm1**6)
    A[5, 3] = (4.0 * S + 105.0 * S**2 + 198.0 * S**3 - 1376.0 * S**4
               - 1302.0 * S**5 - 117.0 * S**6 + 58.0 * S**7) / (
                   32.0 * sh * (3.0 + 2.0 * S) * Sm1**6)
    A[5, 5] = (-6.0 * S**3 + 272.0 * S**4 - 1552.0 * S**5 + 852.0 * S**6
               + 2029.0 * S**7 + 430.0 * S**8) / (
                   64.0 * sh * (3.0 + 2.0 * S) * (4.0 + S) * Sm1**6)

    B = {}
    B[2, 2] = cth * (1.0 + 2.0 * S) / (2.0 * Sm1)
    B[3, 1] = -3.0 * (1.0 + 3.0 * S + 3.0 * S**2 + 2.0 * S**3) / (8.0 * Sm1**3)
    B[4, 2] = cth * (6.0 - 26.0 * S - 182.0 * S**2 - 204.0 * S**3
                     - 25.0 * S**4 + 26.0 * S**5) / (
                         6.0 * (3.0 + 2.0 * S) * Sm1**4)
    B[4, 4] = cth * (24.0 + 92.0 * S + 122.0 * S**2 + 66.0 * S**3
                     + 67.0 * S**4 + 34.0 * S**5) / (
                         24.0 * (3.0 + 2.0 * S) * Sm1**4)
    B[5, 3] = 9.0 * (132.0 + 17.0 * S - 2216.0 * S**2 - 5897.0 * S**3
                     - 6292.0 * S**4 - 2687.0 * S**5 + 194.0 * S**6
                     + 467.0 * S**7 + 82.0 * S**8) / (
                         128.0 * (3.0 + 2.0 * S) * (4.0 + S) * Sm1**6)
    B[5, 5] = 5.0 * (300.0 + 1579.0 * S + 3176.0 * S**2 + 2949.0 * S**3
                     + 1188.0 * S**4 + 675.0 * S**5 + 1326.0 * S**6
                     + 827.0 * S**7 + 130.0 * S**8) / (
                         384.0 * (3.0 + 2.0 * S) * (4.0 + S) * Sm1**6)

    C = {}
    C[0] = jnp.sqrt(th)
    C[2] = C[0] * (2.0 + 7.0 * S**2) / (4.0 * Sm1**2)
    C[4] = C[0] * (4.0 + 32.0 * S - 116.0 * S**2 - 400.0 * S**3
                   - 71.0 * S**4 + 146.0 * S**5) / (32.0 * Sm1**5)
    return A, B, C


def _celerity_factor(kd, eps, order: int):
    """C0 + eps^2 C2 + eps^4 C4 truncated to the requested order."""
    _, _, C = _fenton_coefficients(kd)
    fac = C[0]
    if order >= 3:
        fac = fac + eps**2 * C[2]
    if order >= 5:
        fac = fac + eps**4 * C[4]
    return fac


def solve_stokes_dispersion(H, T, d, order: int = 5, n_iter: int = 40):
    """Wavenumber k from the nonlinear dispersion relation
    omega/k = sqrt(g/k) (C0 + eps^2 C2 + eps^4 C4), eps = kH/2.

    Fixed-count Newton with the exact derivative via jax.grad — jittable and
    vmappable over (H, T, d) batches.  Starts from the linear-theory k.
    """
    H = jnp.asarray(H)
    T = jnp.asarray(T)
    d = jnp.asarray(d)
    g = jnp.asarray(G_GRAV, dtype=jnp.result_type(H, T, d))
    omega = 2.0 * jnp.pi / T

    def residual(k):
        eps = k * H / 2.0
        return jnp.sqrt(g * k) * _celerity_factor(k * d, eps, order) - omega

    k0 = solve_dispersion(omega, d)
    dres = jax.grad(lambda k: jnp.sum(residual(k)))

    def body(_, k):
        return k - residual(k) / dres(k)

    return jax.lax.fori_loop(0, n_iter, body, k0)


def stokes_wave(H, T, d, U_c=0.0, order: int = 5, n_modes: int = 5,
                dtype=jnp.float64) -> FourierWave:
    """Stokes wave of the given order (1-5) in canonical Fourier form.

    ``order`` mirrors the reference's N for raschii StokesWave (clipped to 5,
    `JacketAnalysisGUI_v2.py:245`); order 1 reduces to linear theory with the
    Airy dispersion.  The z-clamp semantics match the reference's raschii
    evaluation path (`JacketAnalysisGUI_v2.py:272`).
    """
    if not 1 <= order <= 5:
        raise ValueError(f"Stokes order must be in 1..5, got {order}")
    n_modes = max(n_modes, 5)
    H = jnp.asarray(H, dtype=dtype)
    T = jnp.asarray(T, dtype=dtype)
    d = jnp.asarray(d, dtype=dtype)
    U_c = jnp.asarray(U_c, dtype=dtype)
    g = jnp.asarray(G_GRAV, dtype=dtype)

    k = solve_stokes_dispersion(H, T, d, order=order)
    omega = 2.0 * jnp.pi / T
    c = omega / k
    kd = k * d
    eps = k * H / 2.0
    A, B, _ = _fenton_coefficients(kd)

    def ord_(n, value):
        """Include a term only if the order admits it."""
        return value if order >= n else jnp.zeros_like(value)

    # ---- surface elevation coefficients, eta = sum E_j cos(j theta) ----
    zero = jnp.zeros_like(eps)
    E1 = eps + ord_(3, eps**3 * B[3, 1]) + ord_(5, -eps**5 * (B[5, 3] + B[5, 5]))
    E2 = ord_(2, eps**2 * B[2, 2]) + ord_(4, eps**4 * B[4, 2])
    E3 = ord_(3, -eps**3 * B[3, 1]) + ord_(5, eps**5 * B[5, 3])
    E4 = ord_(4, eps**4 * B[4, 4])
    E5 = ord_(5, eps**5 * B[5, 5])
    E = jnp.stack([E1, E2, E3, E4, E5], axis=-1) / k[..., None]

    # ---- velocity coefficients (canonical, normalized by cosh(j k d)) ----
    P1 = eps * A[1, 1] + ord_(3, eps**3 * A[3, 1]) + ord_(5, eps**5 * A[5, 1])
    P2 = ord_(2, eps**2 * A[2, 2]) + ord_(4, eps**4 * A[4, 2])
    P3 = ord_(3, eps**3 * A[3, 3]) + ord_(5, eps**5 * A[5, 3])
    P4 = ord_(4, eps**4 * A[4, 4])
    P5 = ord_(5, eps**5 * A[5, 5])
    P = jnp.stack([P1, P2, P3, P4, P5], axis=-1)
    j = jnp.arange(1, 6, dtype=dtype)
    C0 = jnp.sqrt(jnp.tanh(kd))
    U = (C0 * jnp.sqrt(g / k))[..., None] * j * P * jnp.cosh(j * kd[..., None])

    if n_modes > 5:
        pad = jnp.zeros(E.shape[:-1] + (n_modes - 5,), dtype=dtype)
        E = jnp.concatenate([E, pad], axis=-1)
        U = jnp.concatenate([U, pad], axis=-1)

    return FourierWave(
        k=k, omega=omega, c=c, d=d, U_c=U_c, H=H, T=T, E=E, U=U,
        clamp_z=True, model="stokes", order=order,
    )
