"""Steady-wave kinematics as one unified, batched Fourier kernel.

Capability parity with the reference ``RaschiiWave`` facade
(`JacketAnalysisGUI_v2.py:166-296`), redesigned for an accelerator.
The reference wraps the raschii library (Airy / Stokes / Fenton objects with
scalar, per-point Python evaluation).  Here every supported wave theory is
*lowered at construction time* to a single canonical representation — a
:class:`FourierWave` pytree of fixed-size Fourier coefficient arrays — and
ONE jnp kernel evaluates surface elevation, velocities and accelerations for
any model.  Consequences:

- kinematics evaluation is shape-polymorphic and `vmap`-able over thousands
  of (member, quadrature, phase, case) points in one XLA program;
- (H, T, heading) design sweeps vmap over stacked `FourierWave` pytrees
  (coefficient arrays padded to a common mode count);
- hyperbolic depth profiles are evaluated in an overflow-safe normalized form
  so high harmonics (Fenton N up to 20) are stable even in float32.

Canonical form (theta = k*x - omega*t, z measured from MWL, d = depth):

    eta(x, t)      = sum_j E_j cos(j theta)
    u(x, z, t)     = sum_j U_j C_j(z) cos(j theta)        (+ current U_c)
    w(x, z, t)     = sum_j U_j S_j(z) sin(j theta)
    C_j = cosh(j k (z + d)) / cosh(j k d)
    S_j = sinh(j k (z + d)) / cosh(j k d)

Any irrotational steady wave on a flat bed has exactly this form (it is the
stream-function expansion used by Fenton's methods), so Airy, Stokes 5th and
Fenton stream-function waves differ only in their (E_j, U_j, k, c) values.

Reference behaviors replicated exactly (required for 1e-8 parity):

- dry points (z > eta) return zero kinematics
  (`JacketAnalysisGUI_v2.py:269-270,292-293`);
- the raschii evaluation-height clamp ``z+d in [0.01, d+eta-0.01]`` is applied
  for Stokes/Fenton-constructed waves (`:272`) but NOT for the closed-form
  Airy fallback (`:277-280`), controlled by ``clamp_z``;
- acceleration defaults to the same forward finite difference with
  dt = 1e-3, evaluated through the dry-masked velocity at both times, so the
  uniform current cancels (`:283-288`); an analytic d/dt path is provided as
  the fast/accurate alternative.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .dispersion import solve_dispersion


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FourierWave:
    """Canonical steady-wave representation (see module docstring).

    Array fields may carry a leading batch dimension for case sweeps.
    ``E`` and ``U`` have trailing dimension ``N`` (number of Fourier modes;
    zero-padded when models of different order are batched together).
    """

    k: jnp.ndarray        # wavenumber [1/m]
    omega: jnp.ndarray    # angular frequency [rad/s]
    c: jnp.ndarray        # phase speed [m/s]
    d: jnp.ndarray        # water depth [m]
    U_c: jnp.ndarray      # uniform current speed added to u [m/s]
    H: jnp.ndarray        # wave height [m]
    T: jnp.ndarray        # period [s]
    E: jnp.ndarray        # [..., N] surface-elevation cosine coefficients [m]
    U: jnp.ndarray        # [..., N] velocity coefficients [m/s]
    # --- static (non-traced) metadata ---
    clamp_z: bool = dataclasses.field(default=False, metadata=dict(static=True))
    dt_fd: float = dataclasses.field(default=1e-3, metadata=dict(static=True))
    model: str = dataclasses.field(default="airy", metadata=dict(static=True))
    order: int = dataclasses.field(default=1, metadata=dict(static=True))

    @property
    def length(self):
        return 2.0 * jnp.pi / self.k

    @property
    def steepness(self):
        return self.H / self.length

    def model_info(self) -> str:
        """Human-readable summary, mirrors ``RaschiiWave.get_model_info``
        (`JacketAnalysisGUI_v2.py:255-257`)."""
        import numpy as np
        s = float(np.asarray(self.steepness))
        return f"{self.model.capitalize()} (Order/N={self.order}), Steepness H/L={s:.4f}"


def _mode_numbers(E: jnp.ndarray) -> jnp.ndarray:
    n = E.shape[-1]
    return jnp.arange(1, n + 1, dtype=E.dtype)


def surface_elevation(wave: FourierWave, x, t):
    """eta(x, t) relative to MWL.  Batched over x/t of any shape."""
    x = jnp.asarray(x)
    t = jnp.asarray(t)
    theta = wave.k * x - wave.omega * t
    j = _mode_numbers(wave.E)
    return jnp.sum(wave.E * jnp.cos(j * theta[..., None]), axis=-1)


def surface_velocity(wave: FourierWave, x, t):
    """d(eta)/dt (x, t) — the vertical surface rise velocity.

    Exact derivative of the Fourier surface sum: with theta = k x - omega t,
    d/dt sum_j E_j cos(j theta) = sum_j E_j j omega sin(j theta).
    Used by the slamming term (the reference has no slamming concept).
    """
    x = jnp.asarray(x)
    t = jnp.asarray(t)
    theta = wave.k * x - wave.omega * t
    j = _mode_numbers(wave.E)
    return jnp.sum(wave.E * j * wave.omega * jnp.sin(j * theta[..., None]),
                   axis=-1)


def _depth_profiles(wave: FourierWave, z):
    """Overflow-safe C_j(z), S_j(z); shapes ``z.shape + (N,)``.

    cosh(A)/cosh(B) and sinh(A)/cosh(B) with A = j k (z+d), B = j k d are
    rewritten as exp(|A|-B) * (1 +/- exp(-2|A|)) / (1 + exp(-2B)) so that no
    intermediate exceeds exp(|A|-B) ~ exp(j k z) <= 1 for submerged points.
    """
    j = _mode_numbers(wave.E)
    A = j * wave.k * (jnp.asarray(z)[..., None] + wave.d)
    B = j * wave.k * wave.d
    Aa = jnp.abs(A)
    scale = jnp.exp(Aa - B) / (1.0 + jnp.exp(-2.0 * B))
    C = scale * (1.0 + jnp.exp(-2.0 * Aa))
    S = jnp.sign(A) * scale * (1.0 - jnp.exp(-2.0 * Aa))
    return C, S


def _uw_raw(wave: FourierWave, x, z, t):
    """Wave-only (no current) u, w at possibly-clamped evaluation height."""
    theta = wave.k * jnp.asarray(x) - wave.omega * jnp.asarray(t)
    j = _mode_numbers(wave.E)
    C, S = _depth_profiles(wave, z)
    ph = j * theta[..., None]
    u = jnp.sum(wave.U * C * jnp.cos(ph), axis=-1)
    w = jnp.sum(wave.U * S * jnp.sin(ph), axis=-1)
    return u, w


def _eval_height(wave: FourierWave, z, eta, stretching: str = "none"):
    """Evaluation height: optional Wheeler stretching, then the reference's
    raschii z-clamp (`JacketAnalysisGUI_v2.py:272`): z'+d clipped to
    [0.01, d + eta - 0.01].

    ``stretching='wheeler'`` maps the instantaneous water column
    [-d, eta] linearly onto [-d, 0] (Wheeler 1970), so the Fourier depth
    profiles are never extrapolated above MWL — the standard engineering
    treatment for crest kinematics (a capability beyond the reference,
    which evaluates the unstretched profiles).
    """
    z = jnp.asarray(z)
    if stretching == "wheeler":
        z = (z + wave.d) * wave.d / (wave.d + eta) - wave.d
    elif stretching != "none":
        raise ValueError(f"unknown stretching mode {stretching!r}")
    if not wave.clamp_z:
        return z
    z_abs = jnp.clip(z + wave.d, 0.01, wave.d + eta - 0.01)
    return z_abs - wave.d


def velocity(wave: FourierWave, x, z, t, stretching: str = "none"):
    """(u, w) including current, zero above the instantaneous surface.

    Semantics of ``RaschiiWave.velocity`` (`JacketAnalysisGUI_v2.py:267-281`):
    dry check against eta(x, t), optional z-clamp, current added to u only
    when submerged.
    """
    eta = surface_elevation(wave, x, t)
    dry = jnp.asarray(z) > eta
    u, w = _uw_raw(wave, x, _eval_height(wave, z, eta, stretching), t)
    zero = jnp.zeros_like(u)
    return jnp.where(dry, zero, u + wave.U_c), jnp.where(dry, zero, w)


class Kinematics(NamedTuple):
    u: jnp.ndarray
    w: jnp.ndarray
    du_dt: jnp.ndarray
    dw_dt: jnp.ndarray
    submerged: jnp.ndarray  # bool
    eta: jnp.ndarray


def kinematics(wave: FourierWave, x, z, t, accel: str = "fd",
               stretching: str = "none") -> Kinematics:
    """Full kinematics bundle, vectorized over x/z/t of any common shape.

    ``accel='fd'`` reproduces the reference finite difference
    (`JacketAnalysisGUI_v2.py:283-288`): (v(t+dt) - v(t)) / dt through the
    dry-masked velocity, so points that emerge within dt of t see the same
    (discontinuous) derivative the reference computes.  ``accel='analytic'``
    uses the exact d/dt of the Fourier series at the (clamped) evaluation
    height — smoother and cheaper (no second surface-elevation solve).

    With ``stretching='wheeler'`` the evaluation height itself moves with
    eta(t); 'fd' differentiates through that motion (the full local
    derivative), while 'analytic' holds the stretch frozen — the common
    engineering simplification.
    """
    x, z, t = jnp.broadcast_arrays(jnp.asarray(x), jnp.asarray(z), jnp.asarray(t))
    eta = surface_elevation(wave, x, t)
    dry = z > eta
    u, w = velocity(wave, x, z, t, stretching)
    if accel == "fd":
        u1, w1 = velocity(wave, x, z, t + wave.dt_fd, stretching)
        du = (u1 - u) / wave.dt_fd
        dw = (w1 - w) / wave.dt_fd
    elif accel == "analytic":
        z_eval = _eval_height(wave, z, eta, stretching)
        theta = wave.k * x - wave.omega * t
        j = _mode_numbers(wave.E)
        C, S = _depth_profiles(wave, z_eval)
        ph = j * theta[..., None]
        jw = j * wave.omega
        du = jnp.sum(wave.U * C * jw * jnp.sin(ph), axis=-1)
        dw = -jnp.sum(wave.U * S * jw * jnp.cos(ph), axis=-1)
    else:
        raise ValueError(f"unknown accel mode {accel!r}")
    zero = jnp.zeros_like(u)
    sub = jnp.logical_not(dry)
    return Kinematics(
        u=jnp.where(dry, zero, u),
        w=jnp.where(dry, zero, w),
        du_dt=jnp.where(dry, zero, du),
        dw_dt=jnp.where(dry, zero, dw),
        submerged=sub,
        eta=eta,
    )


def airy_wave(H, T, d, U_c=0.0, n_modes: int = 1, dtype=jnp.float64) -> FourierWave:
    """First-order (linear) wave, identical numerics to the reference's
    closed-form Airy fallback (`JacketAnalysisGUI_v2.py:187-196,259-281`):

        eta = (H/2) cos(theta)
        u   = (H/2) omega cosh(k(z+d))/sinh(kd) cos(theta)
        w   = (H/2) omega sinh(k(z+d))/sinh(kd) sin(theta)

    In canonical form U_1 = (H/2) omega / tanh(kd).  ``n_modes`` pads the
    coefficient arrays with zeros so Airy cases can be batched alongside
    higher-order models.
    """
    H = jnp.asarray(H, dtype=dtype)
    T = jnp.asarray(T, dtype=dtype)
    d = jnp.asarray(d, dtype=dtype)
    U_c = jnp.asarray(U_c, dtype=dtype)
    omega = 2.0 * jnp.pi / T
    k = solve_dispersion(omega, d)
    c = omega / k
    a = H / 2.0
    pad = jnp.zeros(H.shape + (n_modes - 1,), dtype=dtype) if n_modes > 1 else None
    E1 = a[..., None]
    U1 = (a * omega / jnp.tanh(k * d))[..., None]
    E = jnp.concatenate([E1, pad], axis=-1) if pad is not None else E1
    U = jnp.concatenate([U1, pad], axis=-1) if pad is not None else U1
    return FourierWave(
        k=k, omega=omega, c=c, d=d, U_c=U_c, H=H, T=T, E=E, U=U,
        clamp_z=False, model="airy", order=1,
    )
