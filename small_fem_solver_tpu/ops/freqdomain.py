"""Frequency-domain stochastic (spectral) response of the jacket.

The time-domain irregular-sea path (:func:`..api.sea_scan_prepared`) solves
the full FEM problem at thousands of sample times.  This module is the
classical frequency-domain alternative: **Borgman-linearized** Morison drag
turns the random-sea loading into a LINEAR map from each spectral component
to a load vector, so the response to the whole sea state is characterized
by 2N+1 transfer solves (one mean + cos/sin per component) instead of a
time march, and every second-order statistic of every response quantity —
stress std devs, spectral moments, mean-upcrossing rates, closed-form
fatigue damage, most-probable-maximum (MPM) storm extremes — follows in
closed form.

Device shape: the per-mode spatial coefficients are the SAME ``[P, N]``
matrices as the separable time-batch engine
(:func:`.morison._mode_spatial_coeffs`), the 2N+1 load columns ride the
same condensed multi-RHS solve as a (2N+1)-step phase scan, and the
statistics are reductions over the mode axis — no new kernel shapes
anywhere.

Modeling conventions (each the standard frequency-domain idealization; the
time-domain path stays the reference for anything outside them):

- **Borgman (1969) drag linearization**: the perpendicular-velocity
  magnitude ``|v|`` in the drag term is replaced by ``sqrt(8/pi) sigma_v``
  with ``sigma_v`` the local std dev of the perpendicular wave velocity
  (the minimum-mean-square-error linear fit for a zero-mean Gaussian
  process).  Exact for the inertia-dominated limit (Cd -> 0), accurate for
  sigma_v >> |current|; for current-DOMINATED cases use the time domain.
- **Mean-wetted-surface loading**: kinematics are integrated to the mean
  water line (``z <= 0``), the standard linear (Airy) convention — the
  time-domain path's instantaneous-wetting intermittency is a free-surface
  nonlinearity outside a linear transfer description.
- **Quasi-static transfer**: the structural transfer is the static
  stiffness (the reference's own assumption); resonance-band energy needs
  :func:`..ops.dynamics.transient_response_condensed`.
- **Fatigue stress = axial+bending normal stress** at the 8
  circumferential points (:func:`.sections.normal_stress_8pt`), the
  hot-spot convention SCFs apply to (DNV RP-C203); governed per member by
  the largest-variance point.

Cross-validation: ``tests/test_freqdomain.py`` holds the Cd=0 path to the
time-domain reconstruction at solver precision (the linearization is exact
there) and brackets the drag-linearized statistics against long
time-domain realizations.

The reference tool has no stochastic analysis of any kind (one regular
design wave, `/root/reference/JacketAnalysisGUI_v2.py:1888`).
"""
from __future__ import annotations

from math import gamma as gamma_fn
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from .morison import _mode_spatial_coeffs, gauss_legendre_01
from .sections import normal_stress_8pt


class LinearizedSeaLoads(NamedTuple):
    """Per-mode linearized nodal load coefficients (chain-ready rows)."""

    F1: jnp.ndarray        # [R, M, 3] member node-1 end forces (N)
    F2: jnp.ndarray        # [R, M, 3] member node-2 end forces
    #   row 0 = mean (linearized current drag); rows 1..N = cos(w_i t);
    #   rows N+1..2N = sin(w_i t)
    totals: jnp.ndarray    # [R, 3] global force coefficient rows (N)
    sigma_v_max: jnp.ndarray   # [] peak perpendicular-velocity std (m/s)
    c_lin_mean: jnp.ndarray    # [] wetted-average Borgman factor (m/s)
    c_damp: jnp.ndarray    # [M] member-average linearized drag damping
    #   coefficient 0.5 rho Cd D sqrt(8/pi) sigma_v  [N s/m per m length]
    totals_moment: jnp.ndarray  # [R, 3] global moment rows about the
    #   mudline origin (0, 0, -d)  [N m]


def linearized_sea_loads(sea, coords, conn, D_m, wave_dir_deg,
                         current_dir_deg, Cd, Cm, rho_water,
                         n_gauss: int = 15,
                         current_alpha=None) -> LinearizedSeaLoads:
    """Borgman-linearized Morison load coefficient rows for ``sea``.

    Same engine inputs as :func:`.spectrum.morison_sea_batch`; instead of
    contracting the per-mode spatial coefficients with sample times it
    keeps the mode axis: the drag magnitude ``|v_perp|`` is replaced by the
    local ``sqrt(8/pi) sigma_v`` so every mode's force is linear in its
    amplitude, and the lever-rule nodal split is applied per mode.
    """
    dtype = coords.dtype
    mc = _mode_spatial_coeffs(sea.k, sea.omega, sea.phi, sea.E, sea.U,
                              sea.d, coords, conn, wave_dir_deg,
                              current_dir_deg, n_gauss, "none", sea.dir_deg)
    z = mc.z
    N = sea.omega.shape[0]
    M, Q = mc.M, mc.Q

    # mean-wetted-surface mask (see module docstring)
    live = (z <= 0.0).astype(dtype)[:, None]                   # [P, 1]

    # per-(point, mode) velocity / acceleration coefficient 3-vectors
    A_u = jnp.stack([mc.Acat[1], mc.Acat[2], mc.Acat[3]], -1) * live[..., None]
    B_u = jnp.stack([mc.Bcat[1], mc.Bcat[2], mc.Bcat[3]], -1) * live[..., None]
    A_a = jnp.stack([mc.Acat[4], mc.Acat[5], mc.Acat[6]], -1) * live[..., None]
    B_a = jnp.stack([mc.Bcat[4], mc.Bcat[5], mc.Bcat[6]], -1) * live[..., None]

    e_p = jnp.repeat(mc.e, Q, axis=0)                          # [P, 3]

    def perp(v):                                   # [P, N, 3] -> [P, N, 3]
        return v - (v * e_p[:, None, :]).sum(-1, keepdims=True) \
            * e_p[:, None, :]

    A_up, B_up = perp(A_u), perp(B_u)
    A_ap, B_ap = perp(A_a), perp(B_a)

    # current mean velocity (time-independent) and its perpendicular part
    if current_alpha is None:
        Uc_pt = jnp.broadcast_to(jnp.asarray(sea.U_c, dtype), z.shape)
    else:
        frac = jnp.clip((z + sea.d) / sea.d, 0.0, 1.0)
        Uc_pt = sea.U_c * frac ** jnp.asarray(current_alpha, dtype)
    mu = jnp.stack([Uc_pt * mc.cos_c, Uc_pt * mc.sin_c,
                    jnp.zeros_like(Uc_pt)], -1) * live         # [P, 3]
    mu_p = mu - (mu * e_p).sum(-1, keepdims=True) * e_p

    # Borgman factor from the local perpendicular-velocity variance
    sigma2 = 0.5 * (jnp.sum(A_up**2, axis=(1, 2))
                    + jnp.sum(B_up**2, axis=(1, 2)))           # [P]
    sigma_v = jnp.sqrt(sigma2)
    c_lin = jnp.sqrt(8.0 / jnp.pi) * sigma_v                   # [P]

    s, w = gauss_legendre_01(n_gauss)
    s = jnp.asarray(s, dtype=dtype)
    w = jnp.asarray(w, dtype=dtype)
    Dp = jnp.repeat(D_m, Q)
    Lw = jnp.repeat(mc.L, Q) * jnp.tile(w, M)
    Cd = jnp.asarray(Cd, dtype=dtype)
    Cm = jnp.asarray(Cm, dtype=dtype)
    Cdp = jnp.repeat(Cd, Q) if Cd.ndim == 1 else Cd
    Cmp = jnp.repeat(Cm, Q) if Cm.ndim == 1 else Cm
    cd_fac = (0.5 * rho_water * Cdp * Dp * c_lin * Lw)[:, None]   # [P, 1]
    ci_fac = (rho_water * Cmp * (jnp.pi * Dp**2 / 4.0) * Lw)[:, None]

    f_mean = cd_fac * mu_p                                     # [P, 3]
    f_cos = cd_fac[..., None] * A_up + ci_fac[..., None] * A_ap   # [P, N, 3]
    f_sin = cd_fac[..., None] * B_up + ci_fac[..., None] * B_ap

    f = jnp.concatenate([
        f_mean[:, None, :],
        f_cos, f_sin,
    ], axis=1)                                                 # [P, R, 3]
    R = 1 + 2 * N
    f = jnp.moveaxis(f, 1, 0).reshape(R, M, Q, 3)

    F1 = jnp.einsum("q,rmqc->rmc", 1.0 - s, f)
    F2 = jnp.einsum("q,rmqc->rmc", s, f)
    totals = jnp.sum(f, axis=(1, 2))

    # global moment rows about the mudline origin (overturning + torsion):
    # same linear rows, so the OTM process statistics are exact too
    c1 = coords[conn[:, 0]]
    c2 = coords[conn[:, 1]]
    p = c1[:, None, :] + s[None, :, None] * (c2 - c1)[:, None, :]  # [M,Q,3]
    r_arm = p - jnp.asarray([0.0, 0.0, -1.0], dtype) * sea.d       # m
    totals_moment = jnp.sum(jnp.cross(r_arm[None], f.reshape(R, M, Q, 3)),
                            axis=(1, 2))                           # [R, 3]

    wet = live[:, 0]
    c_mean = jnp.sum(c_lin * wet) / jnp.maximum(jnp.sum(wet), 1.0)
    # member-average linearized drag-DAMPING coefficient per unit length
    # (relative-velocity drag: F = c (u - xdot); the c xdot part is the
    # hydrodynamic damping the dynamic transfer can fold into its modes)
    cd_unit = (0.5 * rho_water * Cdp * Dp * c_lin).reshape(M, Q)
    c_damp = jnp.einsum("q,mq->m", w, cd_unit)
    return LinearizedSeaLoads(F1=F1, F2=F2, totals=totals,
                              sigma_v_max=jnp.max(sigma_v),
                              c_lin_mean=c_mean, c_damp=c_damp,
                              totals_moment=totals_moment)


# ---------------------------------------------------------------------------
# Response statistics from transfer rows
# ---------------------------------------------------------------------------

class FreqDomainResponse(NamedTuple):
    """Closed-form response statistics of one sea state.

    Per-member stress statistics use the governing (largest-m0) of the 8
    circumferential normal-stress points.  ``mpm_*`` are most-probable
    maxima of the Gaussian response over ``T_storm_s``:
    mean + sigma * sqrt(2 ln(nu0 T)).
    """

    omega: jnp.ndarray             # [N] component frequencies (rad/s)
    sigma_stress: jnp.ndarray      # [M] stress std dev (MPa)
    mean_stress: jnp.ndarray       # [M] mean (static + current) stress
    nu0_hz: jnp.ndarray            # [M] mean-upcrossing rate sqrt(m2/m0)/2pi
    bandwidth_alpha2: jnp.ndarray  # [M] irregularity factor m2/sqrt(m0 m4)
    mpm_stress: jnp.ndarray        # [M] MPM |stress| over the storm (MPa)
    mpm_utilization: jnp.ndarray   # [M] mpm_stress / fy
    damage_nb: jnp.ndarray         # [M] narrow-band Rayleigh Miner damage
    damage_wl: jnp.ndarray         # [M] Wirsching-Light corrected damage
    life_years_nb: jnp.ndarray
    life_years_wl: jnp.ndarray
    sigma_disp_mm: jnp.ndarray     # [] max nodal-translation std dev
    mpm_disp_mm: jnp.ndarray       # [] MPM of that translation
    sigma_base_shear_N: jnp.ndarray   # [] std of total horizontal force
    mean_base_shear_N: jnp.ndarray
    sigma_otm_Nm: jnp.ndarray         # [] std of the resultant overturning
    mean_otm_Nm: jnp.ndarray          #    moment about the mudline
    mpm_otm_Nm: jnp.ndarray           # [] MPM of the OTM over the storm
    sigma_v_max: jnp.ndarray       # linearization diagnostics
    c_lin_mean: jnp.ndarray


def _mpm_factor(nu0, T_storm_s):
    """Most-probable-maximum peak factor sqrt(2 ln(nu0 T)) (>= 0)."""
    n_cycles = jnp.maximum(nu0 * T_storm_s, 1.0 + 1e-9)
    return jnp.sqrt(2.0 * jnp.log(n_cycles))


def spectral_stats(omega, stress_mean, stress_cos, stress_sin,
                   U_mean, U_cos, U_sin, totals, fy,
                   T_storm_s: float, exposure_years: float,
                   curve: str = "D-sea-cp", scf=1.0,
                   occurrence: float = 1.0,
                   sigma_v_max=0.0, c_lin_mean=0.0,
                   totals_moment=None) -> FreqDomainResponse:
    """Spectral moments -> fatigue + extremes, from per-mode transfer rows.

    ``stress_*``: normal stress at the 8 points, mean ``[M, 8]`` and
    per-mode cos/sin coefficient rows ``[N, M, 8]`` (MPa).  ``U_*``: the
    matching displacement rows (mm).  ``totals``: the ``[R, 3]`` global
    force coefficient rows from :func:`linearized_sea_loads`.

    Damage: narrow-band Rayleigh closed form at nu0 = sqrt(m2/m0)/2pi,
    plus the Wirsching-Light (1980) rainflow correction
    lambda = a(m) + (1 - a(m)) (1 - eps)^b(m) with eps = sqrt(1 - alpha2^2)
    — the standard wide-band fatigue estimate in the frequency domain.
    """
    from .fatigue import SECONDS_PER_YEAR, SN_CURVES

    if curve not in SN_CURVES:
        raise ValueError(f"unknown S-N curve {curve!r}; "
                         f"available: {sorted(SN_CURVES)}")
    m_slope, loga = SN_CURVES[curve]

    scf = jnp.asarray(scf, dtype=stress_cos.dtype)
    sc = stress_cos * (scf[:, None] if scf.ndim == 1 else scf)
    ss = stress_sin * (scf[:, None] if scf.ndim == 1 else scf)
    sm = stress_mean * (scf[:, None] if scf.ndim == 1 else scf)

    amp2 = 0.5 * (sc**2 + ss**2)                       # [N, M, 8]
    w2 = omega[:, None, None] ** 2
    m0 = jnp.sum(amp2, axis=0)                         # [M, 8]
    m2 = jnp.sum(amp2 * w2, axis=0)
    m4 = jnp.sum(amp2 * w2**2, axis=0)

    # governing circumferential point per member: largest variance
    pt = jnp.argmax(m0, axis=-1)                       # [M]
    take = lambda a: jnp.take_along_axis(a, pt[:, None], axis=-1)[:, 0]
    m0g, m2g, m4g = take(m0), take(m2), take(m4)
    mean_g = take(sm)

    eps_num = 1e-30
    sigma = jnp.sqrt(jnp.maximum(m0g, 0.0))
    nu0 = jnp.sqrt(jnp.maximum(m2g, 0.0)
                   / jnp.maximum(m0g, eps_num)) / (2.0 * jnp.pi)
    alpha2 = m2g / jnp.sqrt(jnp.maximum(m0g * m4g, eps_num))
    alpha2 = jnp.clip(alpha2, 0.0, 1.0)

    # ---- closed-form fatigue ----
    exposure_s = exposure_years * SECONDS_PER_YEAR * occurrence
    Kbar = 10.0 ** loga
    d_nb = (nu0 * exposure_s / Kbar
            * (2.0 * jnp.sqrt(2.0) * jnp.maximum(sigma, 1e-12)) ** m_slope
            * gamma_fn(1.0 + m_slope / 2.0))
    d_nb = jnp.where(sigma > 1e-9, d_nb, 0.0)
    # Wirsching-Light: nu_p = sqrt(m4/m2)/2pi peaks; damage = lambda * NB
    eps_band = jnp.sqrt(jnp.maximum(1.0 - alpha2**2, 0.0))
    a_wl = 0.926 - 0.033 * m_slope
    b_wl = 1.587 * m_slope - 2.323
    lam = a_wl + (1.0 - a_wl) * (1.0 - eps_band) ** b_wl
    d_wl = lam * d_nb

    life_nb = jnp.where(d_nb > 0, exposure_years / d_nb, jnp.inf)
    life_wl = jnp.where(d_wl > 0, exposure_years / d_wl, jnp.inf)

    # ---- extremes (Gaussian MPM about the mean) ----
    g_peak = _mpm_factor(nu0, T_storm_s)
    mpm = jnp.abs(mean_g) + sigma * g_peak
    util = mpm / fy

    # displacement: per-DOF variance, governing translation DOF
    var_U = 0.5 * jnp.sum(U_cos**2 + U_sin**2, axis=0)     # [n_dof]
    n_nodes = var_U.shape[0] // 6
    var_t = var_U.reshape(n_nodes, 6)[:, :3]
    mean_t = U_mean.reshape(n_nodes, 6)[:, :3]
    # the MPM of the resultant is bounded by mean + g * sigma of the
    # largest-variance component; report that governing component
    i_flat = jnp.argmax(var_t)
    sig_d = jnp.sqrt(var_t.reshape(-1)[i_flat])
    mu_d = jnp.abs(mean_t.reshape(-1)[i_flat])
    # upcrossing rate of the governing displacement DOF
    Uc_f = U_cos.reshape(U_cos.shape[0], -1)[:, 6 * (i_flat // 3)
                                             + (i_flat % 3)]
    Us_f = U_sin.reshape(U_sin.shape[0], -1)[:, 6 * (i_flat // 3)
                                             + (i_flat % 3)]
    a2d = 0.5 * (Uc_f**2 + Us_f**2)
    nu0_d = jnp.sqrt(jnp.sum(a2d * omega**2)
                     / jnp.maximum(jnp.sum(a2d), eps_num)) / (2 * jnp.pi)
    mpm_d = mu_d + sig_d * _mpm_factor(nu0_d, T_storm_s)

    # base shear (total horizontal hydro force): exact from the load rows
    N = omega.shape[0]
    tc, ts_ = totals[1:1 + N], totals[1 + N:]
    fx2 = 0.5 * (tc[:, 0]**2 + ts_[:, 0]**2)
    fy2 = 0.5 * (tc[:, 1]**2 + ts_[:, 1]**2)
    sig_bs = jnp.sqrt(jnp.sum(fx2 + fy2))
    mean_bs = jnp.sqrt(totals[0, 0]**2 + totals[0, 1]**2)

    # overturning moment about the mudline (resultant of Mx, My): the
    # moment rows are linear in the components too, so sigma is exact
    if totals_moment is None:
        totals_moment = jnp.zeros_like(totals)
    mc_, ms_ = totals_moment[1:1 + N], totals_moment[1 + N:]
    m2_rows = 0.5 * (mc_[:, 0]**2 + ms_[:, 0]**2
                     + mc_[:, 1]**2 + ms_[:, 1]**2)
    sig_otm = jnp.sqrt(jnp.sum(m2_rows))
    mean_otm = jnp.sqrt(totals_moment[0, 0]**2 + totals_moment[0, 1]**2)
    nu0_otm = jnp.sqrt(jnp.sum(m2_rows * omega**2)
                       / jnp.maximum(jnp.sum(m2_rows), eps_num)) \
        / (2.0 * jnp.pi)
    mpm_otm = mean_otm + sig_otm * _mpm_factor(nu0_otm, T_storm_s)

    return FreqDomainResponse(
        omega=omega, sigma_stress=sigma, mean_stress=mean_g, nu0_hz=nu0,
        bandwidth_alpha2=alpha2, mpm_stress=mpm, mpm_utilization=util,
        damage_nb=d_nb, damage_wl=d_wl, life_years_nb=life_nb,
        life_years_wl=life_wl, sigma_disp_mm=sig_d, mpm_disp_mm=mpm_d,
        sigma_base_shear_N=sig_bs, mean_base_shear_N=mean_bs,
        sigma_otm_Nm=sig_otm, mean_otm_Nm=mean_otm, mpm_otm_Nm=mpm_otm,
        sigma_v_max=jnp.asarray(sigma_v_max),
        c_lin_mean=jnp.asarray(c_lin_mean))
