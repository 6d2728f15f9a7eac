"""Seismic response-spectrum analysis: modal superposition with CQC.

Beyond-reference capability: the reference's Info tab lists dynamics and
seismic actions among its exclusions (`JacketAnalysisGUI_v2.py:1544-1799`)
and defers them to other tools.  This module runs the standard
design-office earthquake check on any model the framework can build:

1. real modes of the (spring-supported, added-mass) structure
   (:func:`ops.dynamics.modal_analysis` machinery, mass-orthonormal
   shapes, so every modal mass m_i = 1 t);
2. an elastic design acceleration spectrum — the Eurocode 8 Type-1
   parametric shape with ground classes A-E (a Newmark-Hall-style
   plateau/1/T/1/T^2 form, damping correction eta = sqrt(10/(5+xi%))),
   or any site-specific (T, Sa) table;
3. peak modal responses q_i = Gamma_i Sa(T_i) / omega_i^2 per excitation
   direction, with participation Gamma_i = phi_i^T M r;
4. CQC modal combination (Der Kiureghian correlation, equal damping) or
   SRSS, applied to every response quantity (displacements, member end
   forces, base shear);
5. direction combination: SRSS over the excitation directions or the
   100/40/40 percent rule.

Everything is one batched linear-algebra pipeline over the mode axis —
no per-mode Python loops.  Units follow the package convention: K in
N/mm and M in tonnes make omega^2 come out in 1/s^2 directly; spectral
accelerations are converted m/s^2 -> mm/s^2 so modal displacements are mm.

The eigensolves run on the device in f32 and f64 alike.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .beams import internal_forces
from .sections import von_mises_8pt

# Eurocode 8 Type-1 horizontal elastic spectrum parameters per ground
# class: (S, T_B, T_C, T_D) [s].
_EC8_TYPE1 = {
    "A": (1.00, 0.15, 0.4, 2.0),
    "B": (1.20, 0.15, 0.5, 2.0),
    "C": (1.15, 0.20, 0.6, 2.0),
    "D": (1.35, 0.20, 0.8, 2.0),
    "E": (1.40, 0.15, 0.5, 2.0),
}
# EC8 vertical elastic spectrum: avg/ag ratio and corner periods
# (Type 1), ground-class independent.
_EC8_VERTICAL = (0.90, 0.05, 0.15, 1.0)

_G = 9.80665  # m/s^2 per g


def ec8_spectrum(T, pga_g: float, ground: str = "A", zeta: float = 0.05,
                 vertical: bool = False):
    """Elastic design acceleration spectrum Sa(T) [m/s^2], EC8 Type-1 shape.

    ``T`` may be any array of periods [s].  ``pga_g`` is the design peak
    ground acceleration in g on rock (a_g); ``ground`` picks the soil
    factor S and corner periods; ``zeta`` is the damping ratio entering
    the correction eta = sqrt(10 / (5 + 100 zeta)) >= 0.55.
    ``vertical=True`` uses the vertical spectrum (a_vg = 0.9 a_g, its own
    corner periods, S = 1).
    """
    if ground not in _EC8_TYPE1:
        raise ValueError(f"ground must be one of {sorted(_EC8_TYPE1)} "
                         f"(got {ground!r})")
    if pga_g < 0 or zeta <= 0:
        raise ValueError("ec8_spectrum needs pga_g >= 0 and zeta > 0 "
                         f"(got pga_g={pga_g}, zeta={zeta})")
    if vertical:
        ratio, T_B, T_C, T_D = _EC8_VERTICAL
        S = 1.0
        ag = ratio * pga_g * _G
    else:
        S, T_B, T_C, T_D = _EC8_TYPE1[ground]
        ag = pga_g * _G
    eta = max(np.sqrt(10.0 / (5.0 + 100.0 * zeta)), 0.55)
    T = jnp.asarray(T)
    plateau = 2.5 * eta
    Sa = jnp.where(
        T <= T_B, 1.0 + T / T_B * (plateau - 1.0),
        jnp.where(T <= T_C, plateau,
                  jnp.where(T <= T_D, plateau * T_C / jnp.maximum(T, 1e-9),
                            plateau * T_C * T_D / jnp.maximum(T, 1e-9) ** 2)))
    return ag * S * Sa


def table_spectrum(T, T_table, Sa_table):
    """Site-specific spectrum: linear interpolation of an (T, Sa) table
    [s, m/s^2], clamped at the table ends."""
    return jnp.interp(jnp.asarray(T), jnp.asarray(T_table),
                      jnp.asarray(Sa_table))


def cqc_correlation(omega, zeta: float):
    """Der Kiureghian CQC correlation matrix rho_ij for equal damping.

    rho_ij = 8 zeta^2 (1 + b) b^1.5 / ((1 - b^2)^2 + 4 zeta^2 b (1+b)^2),
    b = omega_i / omega_j — symmetric, 1 on the diagonal, -> 0 for
    well-separated frequencies.  Zero-frequency (clipped) modes get the
    identity row so they combine as independent.
    """
    w = jnp.asarray(omega)
    safe = jnp.where(w > 0, w, 1.0)
    b = safe[:, None] / safe[None, :]
    num = 8.0 * zeta**2 * (1.0 + b) * b**1.5
    den = (1.0 - b**2) ** 2 + 4.0 * zeta**2 * b * (1.0 + b) ** 2
    rho = num / den
    live = (w > 0)
    mask = live[:, None] & live[None, :]
    eye = jnp.eye(w.shape[0], dtype=w.dtype)
    return jnp.where(mask, rho, eye)


def _combine(rho, r_modes):
    """Peak of a response with per-mode values ``r_modes`` [n_modes, ...]
    under correlation ``rho``: sqrt(sum_ij rho_ij r_i r_j), elementwise
    over the trailing axes."""
    quad = jnp.einsum("ij,i...,j...->...", rho, r_modes, r_modes)
    return jnp.sqrt(jnp.maximum(quad, 0.0))


class SpectrumResults(NamedTuple):
    """Peak (unsigned) seismic demands from the response-spectrum run."""

    periods_s: jnp.ndarray        # [n_modes]
    frequencies_hz: jnp.ndarray   # [n_modes]
    Sa_ms2: jnp.ndarray           # [n_dirs, n_modes] spectral accel (m/s^2)
    participation: jnp.ndarray    # [n_dirs, n_modes] Gamma_i (sqrt(t) units)
    effective_mass_t: jnp.ndarray  # [n_dirs, n_modes] Gamma_i^2 [t]
    total_mass_t: jnp.ndarray     # structural + topside mass [t]
    U_peak: jnp.ndarray           # [n_dof] combined peak displacement (mm)
    F1_local: jnp.ndarray         # [M, 6] combined peak member end forces
    F2_local: jnp.ndarray         # [M, 6] (N, N*mm; unsigned)
    von_mises: jnp.ndarray        # [M] peak-estimate von Mises (MPa)
    utilization: jnp.ndarray      # [M] von_mises / fy
    base_shear_kN: jnp.ndarray    # [n_dirs] per-direction CQC base shear
    max_displacement_mm: jnp.ndarray
    directions: np.ndarray        # [n_dirs, 3] unit excitation vectors
    mode_shapes: jnp.ndarray      # [n_modes, n_dof] mass-orthonormal


def response_spectrum(model, pga_g: float, ground: str = "A",
                      zeta: float = 0.05, n_modes: int = 10,
                      E: float = 210000.0, nu: float = 0.3,
                      fy: float = 355.0,
                      topside_mass_t: float = 0.0,
                      support_stiffness=None,
                      added_mass_Ca=None, rho_water: float = 1025.0,
                      directions: Sequence[Sequence[float]] = ((1.0, 0.0, 0.0),
                                                               (0.0, 1.0, 0.0)),
                      spectrum=None,
                      vertical_spectrum: bool = True,
                      combination: str = "cqc",
                      dir_rule: str = "srss") -> SpectrumResults:
    """Response-spectrum earthquake analysis of a jacket model.

    ``directions`` are excitation unit vectors (default the two horizontal
    axes; add ``(0, 0, 1)`` for vertical — it automatically uses the EC8
    vertical spectrum when ``vertical_spectrum`` is True).  ``spectrum``
    overrides the parametric shape with a site-specific ``(T_table,
    Sa_table)`` tuple ([s], [m/s^2]) applied to every direction.
    ``combination`` is ``"cqc"`` (default) or ``"srss"`` over modes;
    ``dir_rule`` is ``"srss"`` or ``"100-40-40"`` over directions.
    Supports the same topside-mass / foundation-spring / added-mass options
    as :func:`ops.dynamics.modal_analysis`.

    Returns unsigned peak demands — member forces are CQC-combined per
    component and the von Mises / utilization figures are the standard
    (conservative) evaluation of the stress formula on those peaks.
    """
    if combination not in ("cqc", "srss"):
        raise ValueError("combination must be 'cqc' or 'srss' "
                         f"(got {combination!r})")
    if dir_rule not in ("srss", "100-40-40"):
        raise ValueError("dir_rule must be 'srss' or '100-40-40' "
                         f"(got {dir_rule!r})")
    from .dynamics import _build_km, _modal_from_ff
    from .solve import ground_with_springs

    dtype = model.coords.dtype
    dirs = np.asarray(directions, dtype=np.float64)
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)

    with jax.default_matmul_precision("highest"):
        K, M, free, (K_local, T_rot, L_m) = _build_km(
            model, E, nu, topside_mass_t, added_mass_Ca, rho_water)
        if support_stiffness is not None:
            K, free = ground_with_springs(K, model.fixed_mask,
                                          support_stiffness, dtype)
        K_ff = K[jnp.ix_(free, free)]
        M_ff = M[jnp.ix_(free, free)]
        n_modes = min(n_modes, K_ff.shape[0])
        omega, shapes = _modal_from_ff(K_ff, M_ff, free, model.n_dof,
                                       n_modes, dtype)

        # participation per direction: Gamma = phi^T M iota over ALL DOFs
        # (shapes are mass-orthonormal, so m_i = 1 t and M_eff,i =
        # Gamma_i^2).  The influence vector iota is the full rigid ground
        # translation INCLUDING the fixed supports: with a consistent mass
        # matrix the free-fixed coupling block M_fc iota_c carries ~1% of
        # the effective force and must not be dropped (Chopra's
        # p_eff = -(M_ff iota_f + M_fc iota_c) u''_g).
        r_full = jnp.zeros((dirs.shape[0], model.n_dof), dtype=dtype)
        for c in range(3):
            r_full = r_full.at[:, c::6].set(
                jnp.asarray(dirs[:, c], dtype=dtype)[:, None])
        gamma = jnp.einsum("mn,dn->dm", shapes @ M, r_full)

        core = _spectrum_core(
            model.conn, model.sections, model.sect_id, omega, shapes, gamma,
            K_local, T_rot, pga_g, ground, zeta, dirs, spectrum,
            vertical_spectrum, combination, dir_rule, fy, dtype)

    mass_per_m = model.sections.mass_per_m[model.sect_id]
    total_mass = jnp.sum(mass_per_m * L_m) / 1000.0 + topside_mass_t
    return core._replace(total_mass_t=total_mass)


def _spectrum_core(conn, sections, sect_id, omega, shapes, gamma,
                   K_local, T_rot, pga_g, ground, zeta, dirs, spectrum,
                   vertical_spectrum, combination, dir_rule, fy,
                   dtype) -> SpectrumResults:
    """Shared spectrum/combination pipeline for the dense and condensed
    paths: Sa lookup, modal peaks, per-mode member forces, CQC/SRSS over
    modes, direction rule, stresses and base shear.  ``shapes`` are
    mass-orthonormal over whatever DOF layout ``conn`` indexes (the dense
    mesh or the CB-expanded refined mesh).  ``total_mass_t`` is left at 0
    for the caller to fill."""
    periods = jnp.where(omega > 0, 2.0 * jnp.pi / jnp.maximum(omega, 1e-30),
                        jnp.inf)

    # spectral acceleration per direction/mode (mm/s^2 for mm results)
    Sa_rows = []
    for d in range(dirs.shape[0]):
        is_vert = vertical_spectrum and abs(dirs[d, 2]) > 0.99
        if spectrum is not None:
            Sa_d = table_spectrum(periods, spectrum[0], spectrum[1])
        else:
            Sa_d = ec8_spectrum(periods, pga_g, ground, zeta,
                                vertical=is_vert)
        Sa_rows.append(jnp.where(omega > 0, Sa_d, 0.0))
    Sa = jnp.stack(Sa_rows)                              # [n_dirs, n_modes]

    w2_safe = jnp.where(omega > 0, omega, 1.0) ** 2
    q = gamma * (Sa * 1e3) / w2_safe                     # [n_dirs, n_modes]
    q = jnp.where(omega > 0, q, 0.0)

    if combination == "cqc":
        rho = cqc_correlation(omega, zeta)
    else:
        rho = jnp.eye(omega.shape[0], dtype=dtype)

    # per-mode responses, batched over the mode axis
    dofs = jnp.concatenate([6 * conn[:, 0:1] + jnp.arange(6),
                            6 * conn[:, 1:2] + jnp.arange(6)], axis=-1)
    u_elem_modes = shapes[:, dofs]                       # [n_modes, M, 12]
    F1_m, F2_m = jax.vmap(internal_forces, in_axes=(None, None, 0))(
        K_local, T_rot, u_elem_modes)                    # [n_modes, M, 6]

    def per_direction(qd):
        U = _combine(rho, qd[:, None] * shapes)          # [n_dof]
        F1 = _combine(rho, qd[:, None, None] * F1_m)     # [M, 6]
        F2 = _combine(rho, qd[:, None, None] * F2_m)
        return U, F1, F2

    U_d, F1_d, F2_d = jax.vmap(per_direction)(q)

    # direction combination
    if dir_rule == "srss":
        U_peak = jnp.sqrt(jnp.sum(U_d**2, axis=0))
        F1 = jnp.sqrt(jnp.sum(F1_d**2, axis=0))
        F2 = jnp.sqrt(jnp.sum(F2_d**2, axis=0))
    else:  # 100/40/40 on unsigned peaks: max over which axis is at 100%
        n_d = dirs.shape[0]
        w = 0.4 + 0.6 * jnp.eye(n_d, dtype=dtype)        # rows: 100% axis
        U_peak = jnp.max(w @ U_d.reshape(n_d, -1), axis=0)
        F1 = jnp.max(jnp.einsum("kd,dmc->kmc", w, F1_d), axis=0)
        F2 = jnp.max(jnp.einsum("kd,dmc->kmc", w, F2_d), axis=0)

    vm = von_mises_8pt(sections, sect_id,
                       F1[:, 0], F1[:, 1], F1[:, 2],
                       F1[:, 3], F1[:, 4], F1[:, 5])

    # CQC base shear per direction: modal base shear V_i = Gamma_i^2 Sa_i
    # [t * m/s^2 = kN] — combine with the same correlation.
    V = jax.vmap(lambda gd, sd: _combine(rho, gd**2 * sd))(gamma, Sa)

    disp = jnp.linalg.norm(U_peak.reshape(-1, 6)[:, :3], axis=-1)
    return SpectrumResults(
        periods_s=periods,
        frequencies_hz=jnp.where(omega > 0, omega / (2.0 * jnp.pi), 0.0),
        Sa_ms2=Sa,
        participation=gamma,
        effective_mass_t=gamma**2,
        total_mass_t=jnp.zeros((), dtype=dtype),
        U_peak=U_peak,
        F1_local=F1, F2_local=F2,
        von_mises=vm,
        utilization=vm / fy,
        base_shear_kN=V,
        max_displacement_mm=jnp.max(disp),
        directions=dirs,
        mode_shapes=shapes,
    )


def response_spectrum_condensed(coarse, refined, n_seg: int, pga_g: float,
                                ground: str = "A", zeta: float = 0.05,
                                n_modes: int = 10,
                                E: float = 210000.0, nu: float = 0.3,
                                fy: float = 355.0,
                                topside_mass_t: float = 0.0,
                                n_chain_modes: int = 12,
                                support_stiffness=None,
                                added_mass_Ca=None,
                                rho_water: float = 1025.0,
                                directions: Sequence[Sequence[float]] = (
                                    (1.0, 0.0, 0.0), (0.0, 1.0, 0.0)),
                                spectrum=None,
                                vertical_spectrum: bool = True,
                                combination: str = "cqc",
                                dir_rule: str = "srss") -> SpectrumResults:
    """Response-spectrum analysis of a chain-refined mesh via the
    Craig-Bampton reduction (:func:`ops.dynamics.modal_analysis_condensed`).

    The eigenproblem and the modal combination run on the reduced basis
    (size independent of refinement); member demands are recovered on the
    FULL refined mesh through the expansion v = Psi u_b + Phi q, so the
    peak-stress screen covers every refined element.  A rigid ground
    translation lies exactly in the CB subspace (the constraint modes are
    the exact static condensation), so the participation factors computed
    from the reduced mass matrix are exact, not approximate.
    Same spectra/combination options as :func:`response_spectrum`.
    """
    if combination not in ("cqc", "srss"):
        raise ValueError("combination must be 'cqc' or 'srss' "
                         f"(got {combination!r})")
    if dir_rule not in ("srss", "100-40-40"):
        raise ValueError("dir_rule must be 'srss' or '100-40-40' "
                         f"(got {dir_rule!r})")
    from .dynamics import _cb_expand, _cb_reduce, _modal_from_ff

    dtype = refined.coords.dtype
    dirs = np.asarray(directions, dtype=np.float64)
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)

    cb = _cb_reduce(coarse, refined, n_seg, E, nu, topside_mass_t,
                    n_chain_modes, support_stiffness=support_stiffness,
                    added_mass_Ca=added_mass_Ca, rho_water=rho_water)
    with jax.default_matmul_precision("highest"):
        K_ff = cb.K_red[jnp.ix_(cb.free, cb.free)]
        M_ff = cb.M_red[jnp.ix_(cb.free, cb.free)]
        n_modes = min(n_modes, K_ff.shape[0])
        omega, shapes_r = _modal_from_ff(K_ff, M_ff, cb.free, cb.n_red,
                                         n_modes, dtype)

        # participation on the reduced basis: the influence vector of a
        # rigid translation has ALL interface translations set (including
        # fixed supports — the consistent-mass coupling block, see the
        # dense path) and ZERO generalized coordinates (fixed-interface
        # modes vanish at a rigidly translated boundary).
        r_red = jnp.zeros((dirs.shape[0], cb.n_red), dtype=dtype)
        for c in range(3):
            r_red = r_red.at[:, c:6 * cb.nc:6].set(
                jnp.asarray(dirs[:, c], dtype=dtype)[:, None])
        gamma = jnp.einsum("mn,dn->dm", shapes_r @ cb.M_red, r_red)

        shapes = _cb_expand(cb, shapes_r)       # [n_modes, n_dof_refined]
        core = _spectrum_core(
            refined.conn, refined.sections, refined.sect_id, omega, shapes,
            gamma, cb.K_local, cb.T, pga_g, ground, zeta, dirs, spectrum,
            vertical_spectrum, combination, dir_rule, fy, dtype)

    mass_per_m = refined.sections.mass_per_m[refined.sect_id]
    total_mass = jnp.sum(mass_per_m * cb.L_m) / 1000.0 + topside_mass_t
    return core._replace(total_mass_t=total_mass)
