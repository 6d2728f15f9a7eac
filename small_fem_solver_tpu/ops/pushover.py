"""Pushover analysis and Reserve Strength Ratio (RSR).

Beyond-reference capability: the reference is strictly linear-elastic
(`JacketAnalysisGUI_v2.py:438-533`) and reports only first-yield
utilization; the industry ULS metric for jackets is the RESERVE STRENGTH
RATIO — the factor on the environmental load at which the structure
collapses, found by a pushover: gravity held constant, wave+current+wind
scaled by lambda, members allowed to yield and shed load until a
mechanism forms.

Model: elastic-perfectly-plastic AXIAL member behavior (the dominant
nonlinearity of brace-governed jackets): tension capacity A fy,
compression capacity min(A fy, pi^2 E I / (K L)^2) (Euler with
``k_factor``; no post-buckling degradation — documented simplification,
so compression RSRs are upper bounds for stocky braces and the
``residual`` factor lets users impose a Marshall-style post-peak
plateau).  Bending stays elastic (no plastic hinges): leg-bending-
governed collapse modes are NOT captured — check ``n_yielded`` at the
reported RSR; if legs govern, treat the RSR as an axial-mechanism bound.

Solution: the classical secant (load-shedding) iteration — each member's
axial stiffness coefficient is scaled by s_m = min(1, cap/|N_m|) and the
system re-solved until every yielded member carries exactly its capacity
(convergence is judged on the PHYSICAL capacity violation, not the
fixed-point increment — multi-member redistribution converges slowly in
increments while the violation is already < 0.1%).  Device shape: the
axial term separates from the element pattern (K_local = K_rest +
(EA/L) P0), so one iteration = a batched congruence + dense assembly +
Jacobi-scaled Cholesky, and the WHOLE lambda grid runs as one vmapped
device program — the full pushover curve in a single jit call.

Collapse definition: with elastic bending, continuous-leg frames rarely
form a TRUE mechanism (the measured default jacket still finds
equilibrium at 64 m displacement) — they soften.  The RSR is therefore
the first lambda where the global load-displacement tangent exceeds
``collapse_ratio`` (default 20x) times the elastic slope, or where the
state diverges (NaN / capacity violation), whichever comes first — the
standard practical-collapse reading of a pushover curve.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .assembly import assemble_dense
from .beams import congruence, element_stiffness, internal_forces
from .morison import hydro_members, morison_loads
from .sections import von_mises_8pt
from .solve import factor_dense, free_fixed_dofs, solve_factored


class PushoverResults(NamedTuple):
    """Pushover curve over the lambda grid (+ bisection-refined RSR)."""

    lambdas: jnp.ndarray        # [L] environmental load factors
    converged: jnp.ndarray      # [L] bool: secant fixed point reached
    max_displacement_mm: jnp.ndarray  # [L]
    n_yielded: jnp.ndarray      # [L] members at capacity
    max_util: jnp.ndarray       # [L] peak von Mises utilization (capped)
    axial_N: jnp.ndarray        # [L, M] member axial force (+ compression)
    capacity_N: jnp.ndarray     # [M] axial capacity (+ compression side)
    first_yield_lambda: jnp.ndarray  # first lambda with any yielded member
    rsr: jnp.ndarray            # reserve strength ratio (last stable lambda)
    F_perm: jnp.ndarray         # [n_dof] constant (gravity) loads
    F_env: jnp.ndarray          # [n_dof] unit environmental loads


def _split_loads(model, wave, case, n_gauss, accel):
    """(F_perm, F_env): permanent/operational vs environmental actions.

    Environmental (scaled by lambda): Morison wave+current drag/inertia,
    wind (member + topside block), topside interface SHEAR and overturning
    moment (lateral actions).  Permanent (constant): topside axial load,
    self-weight, buoyancy.
    """
    import dataclasses

    from ..api import assemble_loads

    conn_h, D_m, Cd_h, Cm_h = hydro_members(model, case.marine_growth_mm,
                                            case.Cd, case.Cm)
    mor = morison_loads(wave, model.coords, conn_h, D_m, case.wave_dir_deg,
                        case.current_dir_deg, Cd_h, Cm_h, case.rho_water,
                        case.t_analysis, n_gauss=n_gauss, accel=accel,
                        slam_cs=case.slam_cs)
    _, _, _, L = model.member_geometry()
    perm_case = dataclasses.replace(case, F_shear_kN=0.0, M_moment_kNm=0.0,
                                    M_torsion_kNm=0.0, wind_speed_ms=0.0,
                                    wind_topside_area_m2=0.0)
    env_case = dataclasses.replace(case, F_axial_kN=0.0, sw_mode="none",
                                   buoyancy="none")
    F_perm = assemble_loads(model, perm_case,
                            jnp.zeros((model.n_nodes, 3), model.coords.dtype),
                            L)
    F_env = assemble_loads(model, env_case, mor.nodal_forces, L)
    return F_perm, F_env


def _make_curves_fn(model, case, n_iter, k_factor, residual, tol,
                    support_stiffness):
    """(curves(F_perm, F_env, lambdas) -> per-lambda arrays, cap_c).

    The pure computational core: element data, capacities and BCs are
    closed over once; the returned function is vmappable over an extra
    leading F_env axis (the sharded pushover rose)."""
    dtype = model.coords.dtype
    G = case.E / (2.0 * (1.0 + case.nu))
    Kg, K_local, T, L_m = element_stiffness(
        model.coords, model.conn, model.sections, model.sect_id,
        case.E, G, release=model.release)

    # axial split: K_local = K_rest + (EA/L) P0 (releases leave the
    # axial rows untouched, so the split commutes with them)
    P0 = np.zeros((12, 12))
    P0[0, 0] = P0[6, 6] = 1.0
    P0[0, 6] = P0[6, 0] = -1.0
    P0 = jnp.asarray(P0, dtype=dtype)
    k_ax = K_local[:, 0, 0]                          # EA/L [N/mm]
    K_rest = K_local - k_ax[:, None, None] * P0[None]

    # capacities [N]: tension A fy; compression min(A fy, Euler)
    A = model.sections.Ax[model.sect_id]
    Iy = model.sections.Iy[model.sect_id]
    P_y = A * case.fy
    P_e = jnp.pi**2 * case.E * Iy / (k_factor * L_m * 1000.0) ** 2
    cap_t = P_y
    cap_c = jnp.minimum(P_y, P_e)

    if support_stiffness is not None:
        from .solve import support_spring_nodes
        ks = jnp.asarray(support_spring_nodes(
            model.fixed_mask, support_stiffness).reshape(-1), dtype)
        free = jnp.arange(model.n_dof)
    else:
        ks = None
        free_np, _ = free_fixed_dofs(model.fixed_mask)
        free = jnp.asarray(free_np)

    dofs = jnp.concatenate([6 * model.conn[:, 0:1] + jnp.arange(6),
                            6 * model.conn[:, 1:2] + jnp.arange(6)],
                           axis=-1)
    res_fac = jnp.asarray(residual, dtype)

    def curves(F_perm, F_env, lambdas):
        def solve_state(lam, s):
            """One secant state: scaled K, solve, member axials."""
            K_loc = K_rest + (s * k_ax)[:, None, None] * P0[None]
            K = assemble_dense(congruence(T, K_loc), model.conn, model.n_dof)
            if ks is not None:
                idx = jnp.arange(model.n_dof)
                K = K.at[idx, idx].add(ks)
            fac = factor_dense(K, free)
            U = solve_factored(fac, F_perm + lam * F_env)
            u_elem = U[dofs]
            # elastic TRIAL axial force (unscaled stiffness): the secant
            # update drives s so the carried force s*N_trial hits capacity
            u_loc = jnp.einsum("mij,mj->mi", T, u_elem)
            N_trial = k_ax * (u_loc[:, 6] - u_loc[:, 0])  # + tension
            return U, u_elem, N_trial

        def fixed_point(lam):
            s0 = jnp.ones_like(k_ax)

            def body(s, _):
                U, u_elem, N_trial = solve_state(lam, s)
                cap = jnp.where(N_trial >= 0, cap_t, cap_c) * res_fac
                absN = jnp.abs(N_trial)
                s_new = jnp.where(absN > cap,
                                  cap / jnp.maximum(absN, 1e-30), 1.0)
                # damped update stabilizes alternating load shedding
                return 0.5 * (s + s_new), None

            s, _ = jax.lax.scan(body, s0, None, length=n_iter)
            U, u_elem, N_trial = solve_state(lam, s)
            cap = jnp.where(N_trial >= 0, cap_t, cap_c) * res_fac
            carried = jnp.abs(N_trial) * s
            viol = jnp.max(jnp.maximum(carried - cap, 0.0) / cap)
            K_loc = K_rest + (s * k_ax)[:, None, None] * P0[None]
            F1, _ = internal_forces(K_loc, T, u_elem)
            vm = von_mises_8pt(model.sections, model.sect_id,
                               F1[:, 0], F1[:, 1], F1[:, 2],
                               F1[:, 3], F1[:, 4], F1[:, 5])
            disp = jnp.max(jnp.linalg.norm(U.reshape(-1, 6)[:, :3], axis=-1))
            finite = jnp.isfinite(disp)
            conv = jnp.logical_and(viol < tol, finite)
            n_yield = jnp.sum(s < 1.0 - 1e-9)
            return (conv, disp, n_yield, jnp.max(vm) / case.fy,
                    -carried * jnp.sign(N_trial))

        return jax.vmap(fixed_point)(lambdas)

    return curves, cap_c


def pushover(model, wave, case, lambda_max: float = 4.0, n_lambda: int = 33,
             n_iter: int = 100, k_factor: float = 1.0,
             residual: float = 1.0, n_gauss: int = 15,
             accel: str = "analytic", support_stiffness=None,
             collapse_ratio: float = 20.0,
             tol: float = 1e-2) -> PushoverResults:
    """Vmapped pushover: gravity + lambda * environment, EPP axial yield.

    ``residual`` scales the capacity a member retains AFTER reaching it
    (1.0 = elastic-perfectly-plastic; < 1 approximates post-buckling
    degradation on the compression side).  ``support_stiffness`` runs the
    pushover on foundation springs (see :func:`api.analyze_ssi`).
    ``tol`` is the allowed relative capacity violation at convergence;
    ``collapse_ratio`` defines practical collapse on the curve (see module
    docstring).  Returns the full curve plus the RSR.
    """
    if lambda_max <= 0 or n_lambda < 2:
        raise ValueError("pushover needs lambda_max > 0 and n_lambda >= 2 "
                         f"(got {lambda_max}, {n_lambda})")
    if not 0.0 < residual <= 1.0:
        raise ValueError(f"residual must be in (0, 1] (got {residual})")
    dtype = model.coords.dtype
    with jax.default_matmul_precision("highest"):
        curves, cap_c = _make_curves_fn(model, case, n_iter, k_factor,
                                        residual, tol, support_stiffness)
        F_perm, F_env = _split_loads(model, wave, case, n_gauss, accel)
        lambdas = jnp.linspace(0.0, lambda_max, n_lambda).astype(dtype)
        conv, disp, n_yield, util, axial = curves(F_perm, F_env, lambdas)

    first_yield, rsr = _rsr_from_curve(np.asarray(lambdas), np.asarray(conv),
                                       np.asarray(disp), np.asarray(n_yield),
                                       collapse_ratio)
    return PushoverResults(
        lambdas=lambdas, converged=conv,
        max_displacement_mm=disp, n_yielded=n_yield, max_util=util,
        axial_N=axial,
        capacity_N=cap_c,
        first_yield_lambda=jnp.asarray(first_yield, dtype),
        rsr=jnp.asarray(float(rsr), dtype),
        F_perm=F_perm, F_env=F_env,
    )


def _rsr_from_curve(lam_np, conv_np, disp_np, ny_np, collapse_ratio):
    """(first_yield, rsr) from one pushover curve: practical collapse =
    first interval whose tangent d(disp)/d(lambda) exceeds
    collapse_ratio x the elastic slope, or the first non-converged /
    non-finite state."""
    yielded = ny_np > 0
    first_yield = lam_np[yielded][0] if yielded.any() else np.inf
    slopes = np.diff(disp_np) / np.maximum(np.diff(lam_np), 1e-12)
    s_el = slopes[0] if len(slopes) and slopes[0] > 0 else np.inf
    rsr = lam_np[-1]
    for i in range(len(lam_np)):
        if not conv_np[i] or not np.isfinite(disp_np[i]):
            rsr = lam_np[max(i - 1, 0)]
            break
        if i < len(slopes) and np.isfinite(s_el) \
                and slopes[i] > collapse_ratio * s_el:
            rsr = lam_np[i]
            break
    return first_yield, rsr


def pushover_rose(model, wave, case, headings_deg, mesh=None, **kw):
    """Directional pushover: the RSR for every storm heading.

    The design reserve is the MINIMUM over headings (a jacket's weakest
    wave direction is rarely the design-storm one).  The wave AND current
    rotate together (their relative angle is preserved).

    ``mesh=None``: one vmapped single-heading :func:`pushover` per heading
    (host loop).  ``mesh`` = a 1-D `jax.sharding.Mesh`: the heading axis
    SHARDS across the devices — per-heading environmental load vectors are
    placed with a NamedSharding and the whole [headings x lambdas]
    nonlinear pushover grid runs as one GSPMD program with zero
    cross-device communication until the host-side reduction (each
    heading's secant iteration is independent).  Returns
    ``(headings_deg, rsr[n], first_yield[n], results)`` — ``results`` is
    the per-heading PushoverResults list (host path) or the raw stacked
    curve arrays (sharded path).
    """
    import dataclasses

    headings = np.asarray(headings_deg, dtype=np.float64)
    rel = case.current_dir_deg - case.wave_dir_deg
    if mesh is None:
        out = []
        for h in headings:
            c = dataclasses.replace(case, wave_dir_deg=float(h),
                                    current_dir_deg=float(h) + rel)
            out.append(pushover(model, wave, c, **kw))
        rsr = np.array([float(r.rsr) for r in out])
        fy = np.array([float(r.first_yield_lambda) for r in out])
        return headings, rsr, fy, out

    from jax.sharding import NamedSharding, PartitionSpec as P

    dtype = model.coords.dtype
    lambda_max = kw.pop("lambda_max", 4.0)
    n_lambda = kw.pop("n_lambda", 33)
    n_gauss = kw.pop("n_gauss", 15)
    accel = kw.pop("accel", "analytic")
    collapse_ratio = kw.pop("collapse_ratio", 20.0)
    curves, _ = _make_curves_fn(model, case,
                                kw.pop("n_iter", 100),
                                kw.pop("k_factor", 1.0),
                                kw.pop("residual", 1.0),
                                kw.pop("tol", 1e-2),
                                kw.pop("support_stiffness", None))
    if kw:
        raise TypeError(f"unknown pushover_rose options {sorted(kw)}")
    h_arr = jnp.asarray(headings, dtype=dtype)

    def env_of(h):
        c = dataclasses.replace(case, wave_dir_deg=h,
                                current_dir_deg=h + rel)
        return _split_loads(model, wave, c, n_gauss, accel)

    with jax.default_matmul_precision("highest"):
        F_perm, _ = env_of(jnp.asarray(case.wave_dir_deg, dtype))
        F_env = jax.vmap(lambda h: env_of(h)[1])(h_arr)   # [H, n_dof]
        axis = mesh.axis_names[0]
        F_env = jax.device_put(F_env, NamedSharding(mesh, P(axis)))
        lambdas = jnp.linspace(0.0, lambda_max, n_lambda).astype(dtype)
        grid = jax.jit(jax.vmap(curves, in_axes=(None, 0, None)))
        conv, disp, ny, util, axial = grid(F_perm, F_env, lambdas)

    lam_np = np.asarray(lambdas)
    fy = np.empty(len(headings))
    rsr = np.empty(len(headings))
    for i in range(len(headings)):
        fy[i], rsr[i] = _rsr_from_curve(lam_np, np.asarray(conv[i]),
                                        np.asarray(disp[i]),
                                        np.asarray(ny[i]), collapse_ratio)
    return headings, rsr, fy, (conv, disp, ny, util, axial)
