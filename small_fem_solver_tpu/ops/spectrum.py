"""Irregular (spectral) seas: JONSWAP/PM spectra, random-sea realizations,
spectral response statistics and fatigue screening.

A capability tier beyond the reference, which analyzes exactly one
deterministic design wave per run (`/root/reference/JacketAnalysisGUI_v2.py:
1888`, its Info tab scopes the tool to regular waves).  Real design work
needs the irregular sea states behind that design wave: wave-frequency
response statistics, significant response, and fatigue damage accumulated
over a sea state — all of which require an N-component linear random sea.

Device-first design: a realization is a :class:`SpectralSea` pytree of
independent components (omega_i, k_i, a_i, phi_i).  Each component is a
linear (Airy) wave, so the kinematics of ALL components at ALL times remain
ONE separable matmul — ``cos(k_i x - omega_i t + phi_i)`` factorizes into
spatial and temporal matrices exactly like the steady-wave harmonics, and
:func:`morison_sea_batch` reuses the same engine
(`morison._morison_batch_core`).  A 1-hour, 2048-step storm realization on
the 10k-DOF condensed model is therefore one factor + one multi-RHS solve,
not 2048 analyses.

Spectra (angular-frequency form, S(omega) in m^2 s/rad):

    JONSWAP:  S = alpha g^2 w^-5 exp(-1.25 (wp/w)^4) gamma^b,
              b = exp(-(w - wp)^2 / (2 sigma^2 wp^2)),
              sigma = 0.07 (w <= wp) else 0.09
    PM:       the gamma = 1 special case.

``alpha`` is normalized NUMERICALLY on the component grid so that
m0 = sum a_i^2 / 2 = Hs^2 / 16 exactly — the discretized sea always carries
the requested significant wave height regardless of truncation.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import G_GRAV
from .dispersion import solve_dispersion

_dispersion_jit = jax.jit(solve_dispersion)
from .morison import MorisonPhaseBatch, _morison_batch_core


def jonswap_shape(omega, Tp, gamma: float = 3.3):
    """Unnormalized JONSWAP spectral SHAPE (scale fixed by the caller)."""
    omega = jnp.asarray(omega)
    wp = 2.0 * jnp.pi / Tp
    sigma = jnp.where(omega <= wp, 0.07, 0.09)
    b = jnp.exp(-((omega - wp) ** 2) / (2.0 * sigma**2 * wp**2))
    shape = omega**-5.0 * jnp.exp(-1.25 * (wp / omega) ** 4) * gamma**b
    return jnp.where(omega > 0, shape, 0.0)


def pm_shape(omega, Tp):
    """Pierson-Moskowitz shape = JONSWAP with gamma = 1."""
    return jonswap_shape(omega, Tp, gamma=1.0)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SpectralSea:
    """Linear random-sea realization: N independent Airy components.

    eta(x, t)   = sum_i a_i cos(k_i x - omega_i t + phi_i)
    u(x, z, t)  = sum_i a_i omega_i cosh(k_i (z+d))/sinh(k_i d) cos(.) + U_c
    w(x, z, t)  = sum_i a_i omega_i sinh(k_i (z+d))/sinh(k_i d) sin(.)

    ``U`` stores the canonical velocity coefficients a_i omega_i /
    tanh(k_i d) (so the shared kernel's C_i = cosh/cosh profile applies,
    exactly as for :class:`.waves.FourierWave` modes).
    """

    omega: jnp.ndarray     # [N] component angular frequencies [rad/s]
    k: jnp.ndarray         # [N] wavenumbers [1/m]
    a: jnp.ndarray         # [N] component amplitudes [m]
    phi: jnp.ndarray       # [N] phases [rad]
    E: jnp.ndarray         # [N] = a (surface cosine coefficients)
    U: jnp.ndarray         # [N] velocity coefficients [m/s]
    d: jnp.ndarray         # water depth [m]
    U_c: jnp.ndarray       # uniform current [m/s]
    Hs: jnp.ndarray        # significant wave height [m]
    Tp: jnp.ndarray        # peak period [s]
    dir_deg: object = None  # [N] per-component heading RELATIVE to the
    #   load case's wave_dir_deg (short-crested seas; None = long-crested)
    # static metadata
    spectrum: str = dataclasses.field(default="jonswap",
                                      metadata=dict(static=True))

    @property
    def m0(self):
        """Zeroth spectral moment of the realization = sum a^2 / 2."""
        return jnp.sum(self.a**2) / 2.0

    @property
    def mean_zero_crossing_period(self):
        """Tz = 2 pi sqrt(m0 / m2) of the DISCRETIZED sea."""
        m2 = jnp.sum(self.omega**2 * self.a**2) / 2.0
        return 2.0 * jnp.pi * jnp.sqrt(self.m0 / m2)


def make_random_sea(Hs, Tp, d, n_components: int = 64, seed: int = 0,
                    spectrum: str = "jonswap", gamma: float = 3.3,
                    U_c=0.0, omega_range=None, spreading_s=None,
                    dtype=jnp.float64) -> SpectralSea:
    """Discretize a JONSWAP/PM spectrum into an N-component realization.

    Equal-d(omega) grid over ``omega_range`` (default [0.5, 3.0] x the peak
    frequency — >99% of JONSWAP energy), amplitudes a_i = sqrt(2 S_i dw)
    rescaled so m0 = Hs^2/16 EXACTLY on the grid, phases drawn uniformly
    from a seeded host RNG (deterministic per seed — realizations are
    reproducible, required for resumable envelope runs).

    ``spreading_s`` enables SHORT-CRESTED (directionally spread) seas by
    the single-summation method: each component draws one heading from the
    cos^(2s)((theta)/2) spreading function (API RP 2A practice; larger s =
    more long-crested, s -> inf recovers unidirectional) via inverse-CDF
    sampling of the same seeded RNG.  Headings are stored RELATIVE to the
    load case's wave heading and cost nothing downstream — per-mode
    directions fold into the same separable Morison matmul
    (`morison._morison_batch_core`).
    """
    Hs_f, Tp_f, d_f = float(Hs), float(Tp), float(d)
    wp = 2.0 * np.pi / Tp_f
    lo, hi = omega_range if omega_range is not None else (0.5 * wp, 3.0 * wp)
    # component frequencies at interval midpoints (no zero-energy endpoint)
    edges = np.linspace(lo, hi, n_components + 1)
    om = 0.5 * (edges[:-1] + edges[1:])
    dw = np.diff(edges)

    if spectrum == "jonswap":
        shape = np.asarray(jonswap_shape(om, Tp_f, gamma))
    elif spectrum == "pm":
        shape = np.asarray(pm_shape(om, Tp_f))
    else:
        raise ValueError(f"unknown spectrum {spectrum!r} "
                         "(available: 'jonswap', 'pm')")
    a = np.sqrt(2.0 * shape * dw)
    # normalize: m0 = sum a^2/2 must equal Hs^2/16
    m0_target = Hs_f**2 / 16.0
    a = a * np.sqrt(m0_target / (np.sum(a**2) / 2.0))

    rng = np.random.default_rng(seed)
    phi = rng.uniform(0.0, 2.0 * np.pi, size=n_components)

    dir_deg = None
    if spreading_s is not None:
        s_exp = float(spreading_s)
        if s_exp <= 0:
            raise ValueError("spreading_s must be > 0 (larger = more "
                             "long-crested)")
        # inverse-CDF sampling of D(theta) ~ cos^(2s)(theta/2), theta in
        # (-pi, pi), on a fine grid (deterministic per seed)
        th = np.linspace(-np.pi, np.pi, 4097)
        pdf = np.cos(th / 2.0) ** (2.0 * s_exp)
        cdf = np.cumsum(pdf)
        cdf = (cdf - cdf[0]) / (cdf[-1] - cdf[0])
        u = rng.uniform(0.0, 1.0, size=n_components)
        dir_deg = jnp.asarray(np.degrees(np.interp(u, cdf, th)), dtype=dtype)

    om_j = jnp.asarray(om, dtype=dtype)
    # module-level jit: a fresh eagerly-traced dispersion Newton costs
    # ~200 ms PER make_random_sea call (it re-traces every time); the jit
    # cache keys on (N, dtype) so scatter sweeps pay it once
    k = _dispersion_jit(om_j, jnp.asarray(d_f, dtype))
    a_j = jnp.asarray(a, dtype=dtype)
    U = a_j * om_j / jnp.tanh(k * d_f)
    return SpectralSea(
        omega=om_j, k=k, a=a_j, phi=jnp.asarray(phi, dtype=dtype),
        E=a_j, U=U, d=jnp.asarray(d_f, dtype=dtype),
        U_c=jnp.asarray(U_c, dtype=dtype),
        Hs=jnp.asarray(Hs_f, dtype=dtype), Tp=jnp.asarray(Tp_f, dtype=dtype),
        dir_deg=dir_deg, spectrum=spectrum,
    )


def sea_surface(sea: SpectralSea, x, t, y=0.0, wave_dir_deg=0.0):
    """eta of the realization; batched over x/y/t of any common shape.

    For a LONG-CRESTED sea, ``x`` is the coordinate along the propagation
    direction (y ignored).  For a spread sea (``sea.dir_deg`` set), (x, y)
    are plan coordinates and ``wave_dir_deg`` the mean compass heading the
    relative component headings add to.
    """
    x = jnp.asarray(x)[..., None]
    t = jnp.asarray(t)[..., None]
    if sea.dir_deg is None:
        kx = sea.k * x
    else:
        th_n = jnp.deg2rad(90.0 - (wave_dir_deg + sea.dir_deg))
        y = jnp.asarray(y)[..., None]
        kx = sea.k * (x * jnp.cos(th_n) + y * jnp.sin(th_n))
    th = kx - sea.omega * t + sea.phi
    return jnp.sum(sea.a * jnp.cos(th), axis=-1)


class SeaKinematics(NamedTuple):
    u: jnp.ndarray
    w: jnp.ndarray
    du_dt: jnp.ndarray
    dw_dt: jnp.ndarray
    eta: jnp.ndarray
    submerged: jnp.ndarray


def sea_kinematics(sea: SpectralSea, x, z, t) -> SeaKinematics:
    """Pointwise linear-superposition kinematics (dry-masked, analytic
    d/dt) — the oracle for :func:`morison_sea_batch`'s matmul path.
    LONG-CRESTED seas only (u is the along-heading velocity); a spread
    sea's per-point oracle is the single-component equivalence test in
    tests/test_spectrum.py."""
    if sea.dir_deg is not None:
        raise ValueError("sea_kinematics is the long-crested 2D oracle; "
                         "spread seas resolve per-mode headings inside "
                         "morison_sea_batch")
    x, z, t = jnp.broadcast_arrays(jnp.asarray(x), jnp.asarray(z),
                                   jnp.asarray(t))
    eta = sea_surface(sea, x, t)
    th = sea.k * x[..., None] - sea.omega * t[..., None] + sea.phi
    A = sea.k * (z[..., None] + sea.d)
    B = sea.k * sea.d
    Aa = jnp.abs(A)
    scale = jnp.exp(Aa - B) / (1.0 + jnp.exp(-2.0 * B))
    C = scale * (1.0 + jnp.exp(-2.0 * Aa))
    S = jnp.sign(A) * scale * (1.0 - jnp.exp(-2.0 * Aa))
    u = jnp.sum(sea.U * C * jnp.cos(th), axis=-1)
    w = jnp.sum(sea.U * S * jnp.sin(th), axis=-1)
    du = jnp.sum(sea.U * C * sea.omega * jnp.sin(th), axis=-1)
    dw = -jnp.sum(sea.U * S * sea.omega * jnp.cos(th), axis=-1)
    dry = z > eta
    zero = jnp.zeros_like(u)
    return SeaKinematics(
        u=jnp.where(dry, zero, u + sea.U_c),
        w=jnp.where(dry, zero, w),
        du_dt=jnp.where(dry, zero, du),
        dw_dt=jnp.where(dry, zero, dw),
        eta=eta, submerged=jnp.logical_not(dry),
    )


def morison_sea_batch(
    sea: SpectralSea,
    coords: jnp.ndarray,
    conn: jnp.ndarray,
    D_m: jnp.ndarray,
    wave_dir_deg,
    current_dir_deg,
    Cd,
    Cm,
    rho_water,
    ts: jnp.ndarray,
    n_gauss: int = 15,
    current_alpha=None,
    stretching: str = "none",
) -> MorisonPhaseBatch:
    """Morison loads of the random sea at every sample time — one matmul.

    Identical engine and semantics to :func:`.morison.morison_phase_batch`
    (the steady-wave fast path); the mode set is the sea's independent
    (k_i, omega_i, phi_i) components instead of harmonics of one
    fundamental.  ``stretching='wheeler'`` is the standard treatment for
    linear irregular-sea crest kinematics (API RP 2A) and uses the same
    2nd-order Taylor frozen-stretch rows.
    """
    return _morison_batch_core(
        sea.k, sea.omega, sea.phi, sea.E, sea.U, sea.d, sea.U_c,
        coords, conn, D_m, wave_dir_deg, current_dir_deg, Cd, Cm, rho_water,
        ts, n_gauss, current_alpha, stretching,
        rel_dir_deg=sea.dir_deg)


# ---------------------------------------------------------------------------
# Spectral fatigue screening
# ---------------------------------------------------------------------------

class SpectralFatigue(NamedTuple):
    """Narrow-band (Rayleigh) + rainflow fatigue screen per member."""

    sigma_mpa: jnp.ndarray         # [M] std dev of the stress history
    nu0_hz: jnp.ndarray            # [M] mean-upcrossing rate of the history
    damage_rayleigh: jnp.ndarray   # [M] narrow-band Miner damage (exposure)
    damage_rainflow: jnp.ndarray   # [M] rainflow-counted Miner damage
    life_years_rayleigh: jnp.ndarray
    life_years_rainflow: jnp.ndarray


def _rainflow_ranges(y: np.ndarray):
    """Cycle ranges of one history by the ASTM E1049 rainflow rules
    (host-side numpy; histories come back to the host for reporting
    anyway).  Returns ``(ranges, weights)``: full cycles carry weight 1.0,
    half cycles (the residual path and the history start) weight 0.5."""
    # reduce to turning points
    dy = np.diff(y)
    keep = np.ones(y.shape[0], dtype=bool)
    keep[1:-1] = dy[:-1] * dy[1:] < 0
    tp = y[keep]
    stack: list[float] = []
    full = []
    half = []
    for x in tp:
        stack.append(float(x))
        while len(stack) >= 3:
            X = abs(stack[-2] - stack[-1])
            Y = abs(stack[-3] - stack[-2])
            if X < Y:
                break
            if len(stack) == 3:
                half.append(Y)          # half cycle at the history start
                stack.pop(0)
            else:
                full.append(Y)
                del stack[-3:-1]
    for i in range(len(stack) - 1):     # residuals count as half cycles
        half.append(abs(stack[i] - stack[i + 1]))
    return np.asarray(full + half), np.concatenate(
        [np.ones(len(full)), 0.5 * np.ones(len(half))])


def spectral_fatigue_screen(vm_history, dt: float, exposure_years: float,
                            curve: str = "D", scf: float = 1.0,
                            occurrence: float = 1.0) -> SpectralFatigue:
    """Fatigue damage per member from an irregular-sea stress history.

    ``vm_history``: [S, M] von Mises stresses (MPa) at uniform spacing
    ``dt`` over one sea-state realization (e.g.
    ``sea_scan_prepared(...).von_mises``).  Two estimates:

    - **narrow-band Rayleigh** (closed form): ranges Rayleigh-distributed
      with E[R^m] = (2 sqrt(2) sigma)^m Gamma(1 + m/2) at the measured
      mean-upcrossing rate nu0 — the classical upper-bound screen, replacing
      the one-cycle-per-period assumption of :func:`.fatigue.fatigue_screen`;
    - **rainflow** (ASTM E1049 counting on the realization, scaled to the
      exposure): the code-grade estimate; ~= the Rayleigh number for
      narrow-band response, smaller for broad-band.

    Both scale the realization's damage RATE to ``exposure_years`` x
    ``occurrence``.  S-N curves as in :mod:`.fatigue` (DNV RP-C203
    single-slope).  ``scf`` is a scalar or a per-member ``[M]`` vector
    (hot-spot workflow with project-specific joint SCFs).
    """
    from math import gamma as gamma_fn

    from .fatigue import SECONDS_PER_YEAR, SN_CURVES

    if curve not in SN_CURVES:
        raise ValueError(f"unknown S-N curve {curve!r}; "
                         f"available: {sorted(SN_CURVES)}")
    m_slope, loga = SN_CURVES[curve]
    vm = np.asarray(vm_history, dtype=np.float64) * scf      # [S, M]
    S, M = vm.shape
    T_real = S * dt
    mean = vm.mean(axis=0)
    sigma = vm.std(axis=0)
    # mean-upcrossing rate of each member's history
    above = vm > mean[None, :]
    nu0 = np.maximum((~above[:-1] & above[1:]).sum(axis=0), 1e-12) / T_real

    exposure_s = exposure_years * SECONDS_PER_YEAR * occurrence
    Kbar = 10.0**loga
    # narrow-band: D = nu0 T / K * (2 sqrt(2) sigma)^m Gamma(1 + m/2)
    d_ray = (nu0 * exposure_s / Kbar
             * (2.0 * np.sqrt(2.0) * np.maximum(sigma, 1e-12)) ** m_slope
             * gamma_fn(1.0 + m_slope / 2.0))
    d_ray = np.where(sigma > 1e-9, d_ray, 0.0)

    scale_t = exposure_s / T_real
    from ..native import rainflow_damage_sums_native
    sums = rainflow_damage_sums_native(vm, m_slope)
    if sums is not None:
        # native batched counter (one O(S) C++ pass per member; tested
        # identical to the Python stack below)
        d_rf = np.where(sigma > 1e-9, sums[0] / Kbar * scale_t, 0.0)
    else:
        d_rf = np.zeros(M)
        for j in range(M):
            if sigma[j] <= 1e-9:
                continue
            ranges, weight = _rainflow_ranges(vm[:, j])
            if ranges.size:
                d_rf[j] = np.sum(weight * ranges**m_slope) / Kbar * scale_t

    with np.errstate(divide="ignore"):
        life_ray = np.where(d_ray > 0, exposure_years / d_ray, np.inf)
        life_rf = np.where(d_rf > 0, exposure_years / d_rf, np.inf)
    return SpectralFatigue(
        sigma_mpa=jnp.asarray(sigma), nu0_hz=jnp.asarray(nu0),
        damage_rayleigh=jnp.asarray(d_ray), damage_rainflow=jnp.asarray(d_rf),
        life_years_rayleigh=jnp.asarray(life_ray),
        life_years_rainflow=jnp.asarray(life_rf),
    )
