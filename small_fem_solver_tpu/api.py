"""End-to-end analysis driver: wave -> Morison -> FEM -> stresses.

Capability parity with the reference orchestrator
``JacketAnalysisGUI.run_analysis`` (`JacketAnalysisGUI_v2.py:1827-2082`),
redesigned for an accelerator: the whole pipeline — hydrodynamic loading,
interface loads, self-weight, assembly, solve, reactions, member internal
forces and von Mises utilization — is ONE jitted XLA program.  Phase scans
vmap the time axis over a single stiffness factorization (K does not depend
on t), and design sweeps vmap over batched wave-case pytrees.

Load application parity:

- topside interface loads distributed equally over the top nodes, shear along
  the wave heading, axial as -Z, torsion/overturning moments split per node
  (`JacketAnalysisGUI_v2.py:1962-1977`);
- Morison nodal forces enter translation DOFs only (`:1986-1989`);
- self-weight: 'calculated' lumps half of each member's weight to each end
  node's -Z (`:1995-2007`); 'custom' spreads (tonnes * 1000 * g) / n_nodes to
  every node (`:2008-2013`); 'none' skips (`:2014-2015`).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .constants import G_GRAV
from .models.model import JacketModel
from .ops import condense as condense_mod
from .ops import solve as solve_mod
from .ops.assembly import (assemble_bcsr, assemble_dense, bcsr_block_diagonal,
                           bcsr_matvec, build_bcsr_pattern)
from .ops.beams import (element_stiffness, internal_forces, matmul12,
                        matvec12)
from .ops.morison import (MorisonLoads, hydro_diameter_m, hydro_members,
                          morison_loads, morison_phase_batch)
from .ops.sections import von_mises_8pt
from .ops.waves import FourierWave


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LoadCase:
    """Scalar load-case parameters (traced; a pytree so cases batch/vmap).

    Mirrors the GUI's Material/Wave/Loads tab fields
    (`JacketAnalysisGUI_v2.py:1835-1863`); the wave itself is carried
    separately as a :class:`FourierWave`.
    """

    E: jnp.ndarray = 210000.0            # MPa
    nu: jnp.ndarray = 0.3
    fy: jnp.ndarray = 355.0              # MPa
    rho_water: jnp.ndarray = 1025.0      # kg/m^3
    wave_dir_deg: jnp.ndarray = 0.0      # compass, deg from North clockwise
    current_dir_deg: jnp.ndarray = 0.0
    Cd: jnp.ndarray = 0.7
    Cm: jnp.ndarray = 2.0
    F_axial_kN: jnp.ndarray = 0.0        # topside axial (compression +down)
    F_shear_kN: jnp.ndarray = 0.0        # topside shear along wave heading
    M_moment_kNm: jnp.ndarray = 0.0      # overturning moment
    M_torsion_kNm: jnp.ndarray = 0.0     # torsion
    custom_sw_tonnes: jnp.ndarray = 0.0  # used when sw_mode == 'custom'
    t_analysis: jnp.ndarray = 0.0        # wave phase time [s]
    marine_growth_mm: jnp.ndarray = 0.0  # radial growth thickness (API RP
    #   2A practice): adds 2*t to the HYDRODYNAMIC diameter only (loads),
    #   not to the structural section. 0 = reference semantics.
    # static:
    sw_mode: str = dataclasses.field(default="custom", metadata=dict(static=True))
    buoyancy: str = dataclasses.field(default="none", metadata=dict(static=True))
    #   'none' (reference semantics) | 'sealed' (air-filled members displace
    #   their full pi D^2/4 volume) | 'flooded' (free-flooding members
    #   displace only the steel annulus) | 'legs-flooded' (flooded legs,
    #   sealed braces — the usual jacket design assumption).  Still-water
    #   wetted span, applied as nodal uplift at the wetted-span centroid.
    slam_cs: float = dataclasses.field(default=0.0, metadata=dict(static=True))
    #   wave-slamming coefficient Cs (0 = off, reference semantics).
    #   Recommended pi (API RP 2A commentary) to 5.15 (DNV-RP-C205 8.6).
    #   Quasi-static splash-zone slam on the POINTWISE kinematics paths
    #   only; the separable fast paths raise (the crossing-band impact
    #   term does not separate over the phase matmul).
    # -- wind (beyond the reference: it only takes a hand-typed topside
    #    shear).  Static scalars — wind is steady per case, and envelopes
    #    share one wind state across the case batch. --
    wind_speed_ms: float = dataclasses.field(default=0.0,
                                             metadata=dict(static=True))
    #   1-hour mean at 10 m (0 = off); see ops/wind.py for the profile.
    wind_dir_deg: float = dataclasses.field(default=0.0,
                                            metadata=dict(static=True))
    wind_Cs: float = dataclasses.field(default=0.5,
                                       metadata=dict(static=True))
    #   member shape coefficient (API: 0.5 cylindrical sections)
    wind_topside_area_m2: float = dataclasses.field(default=0.0,
                                                    metadata=dict(static=True))
    wind_topside_Cs: float = dataclasses.field(default=1.0,
                                               metadata=dict(static=True))

    _STATIC_FIELDS = ("sw_mode", "buoyancy", "slam_cs", "wind_speed_ms",
                      "wind_dir_deg", "wind_Cs", "wind_topside_area_m2",
                      "wind_topside_Cs")

    def cast(self, dtype):
        vals = {f.name: jnp.asarray(getattr(self, f.name), dtype=dtype)
                for f in dataclasses.fields(self)
                if f.name not in LoadCase._STATIC_FIELDS}
        return dataclasses.replace(self, **vals)


class AnalysisResults(NamedTuple):
    """Full result pytree of one analysis (units noted per field)."""

    U: jnp.ndarray                 # [n_dof] displacements, mm / rad
    reactions: jnp.ndarray         # [n_fixed_nodes, 6] N / N*mm
    F_applied: jnp.ndarray         # [n_dof] assembled load vector, N / N*mm
    F1_local: jnp.ndarray          # [M, 6] member end forces at node1 (local), N / N*mm
    F2_local: jnp.ndarray          # [M, 6] member end forces at node2 (local)
    von_mises: jnp.ndarray         # [M] max over 8 points at node1, MPa
    utilization: jnp.ndarray       # [M] von_mises / fy
    length_m: jnp.ndarray          # [M]
    morison: MorisonLoads
    max_displacement_mm: jnp.ndarray
    max_displacement_node: jnp.ndarray  # int index
    total_reaction: jnp.ndarray    # [6] sums of reaction components
    # iterative-solver diagnostics (None for direct solvers)
    solver_iters: jnp.ndarray | None = None
    solver_residual: jnp.ndarray | None = None  # relative ||r||/||b||
    # second-order diagnostics (analyze_pdelta only)
    pdelta_amplification: jnp.ndarray | None = None  # max |U2|/|U1| ratio


# ---------------------------------------------------------------------------
# Load assembly
# ---------------------------------------------------------------------------

def _topside_per_node(case: LoadCase, top_mask, dtype) -> jnp.ndarray:
    """Per-top-node interface load [6] (N / N*mm), `:1962-1977` semantics."""
    top = top_mask.astype(dtype)
    # guard n_top = 0 (e.g. a JSON model without top nodes): interface loads
    # have nowhere to go, so they are dropped instead of producing 0/0 NaNs
    n_top = jnp.maximum(jnp.sum(top), 1.0)
    theta = jnp.deg2rad(90.0 - case.wave_dir_deg)
    F_axial_N = case.F_axial_kN * 1000.0
    F_shear_N = case.F_shear_kN * 1000.0
    M_moment = case.M_moment_kNm * 1e6
    M_torsion = case.M_torsion_kNm * 1e6
    return jnp.stack([
        F_shear_N * jnp.cos(theta) / n_top,
        F_shear_N * jnp.sin(theta) / n_top,
        -F_axial_N / n_top,
        M_torsion / n_top,
        M_moment / n_top,
        jnp.zeros_like(theta),
    ])


def _member_buoyancy(coords, conn, sec, sect_id, member_types, rho_water,
                     mode, L_m):
    """Still-water buoyant uplift per member.

    Returns (F_b [M] in N, c [M] wetted-span centroid in [0, 1] from node
    1).  Displaced area: full pi D^2/4 for 'sealed' members, the steel
    annulus for 'flooded' ones ('legs-flooded' mixes by member type).
    Marine growth displaces no credit-worthy volume (API practice) — the
    bare steel OD is used.  Beyond the reference (its loads stop at
    Morison + self-weight, `/root/reference/JacketAnalysisGUI_v2.py:1995`).
    """
    dtype = coords.dtype
    D_m = sec.D_outer[sect_id] / 1000.0
    A_sealed = jnp.pi * D_m**2 / 4.0                       # m^2
    A_flooded = sec.Ax[sect_id] * 1e-6
    if mode == "sealed":
        A = A_sealed
    elif mode == "flooded":
        A = A_flooded
    elif mode == "legs-flooded":
        types = member_types or ("brace",) * conn.shape[0]
        is_leg = jnp.asarray(np.array([t == "leg" for t in types]))
        A = jnp.where(is_leg, A_flooded, A_sealed)
    else:
        raise ValueError(f"unknown buoyancy mode {mode!r}; use "
                         "'none', 'sealed', 'flooded' or 'legs-flooded'")

    # wetted parameter span [a, b] of z(t) < 0, t from node 1 to node 2
    z1 = coords[conn[:, 0], 2]
    z2 = coords[conn[:, 1], 2]
    slope = z2 - z1
    near0 = jnp.abs(slope) < 1e-9
    t0 = -z1 / jnp.where(near0, 1.0, slope)
    a = jnp.where(near0, 0.0,
                  jnp.where(slope > 0, 0.0, jnp.clip(t0, 0.0, 1.0)))
    b = jnp.where(near0, (z1 < 0.0).astype(dtype),
                  jnp.where(slope > 0, jnp.clip(t0, 0.0, 1.0), 1.0))
    wet = jnp.maximum(b - a, 0.0)
    c = jnp.where(wet > 0, (a + b) / 2.0, 0.5)
    F_b = rho_water * G_GRAV * A * L_m * wet               # N, +up
    return F_b.astype(dtype), c.astype(dtype)


def assemble_loads(model: JacketModel, case: LoadCase, morison_nodal: jnp.ndarray,
                   L_m: jnp.ndarray) -> jnp.ndarray:
    """Global load vector [n_dof] in N / N*mm."""
    dtype = model.coords.dtype
    n_nodes = model.n_nodes
    F = jnp.zeros((n_nodes, 6), dtype=dtype)

    # -- topside interface loads (`:1962-1977`) --
    top = model.top_mask.astype(dtype)
    per_top = _topside_per_node(case, model.top_mask, dtype)
    F = F + top[:, None] * per_top[None, :]

    # -- Morison nodal forces, translations only (`:1986-1989`) --
    F = F.at[:, :3].add(morison_nodal)

    # -- self-weight (`:1995-2013`) --
    if case.sw_mode == "calculated":
        mass_per_m = model.sections.mass_per_m[model.sect_id]
        member_weight = mass_per_m * G_GRAV * L_m          # N
        half = member_weight / 2.0
        contrib = jnp.concatenate([half, half])
        nodes = jnp.concatenate([model.conn[:, 0], model.conn[:, 1]])
        wz = jax.ops.segment_sum(contrib, nodes, num_segments=n_nodes)
        F = F.at[:, 2].add(-wz)
    elif case.sw_mode == "custom":
        total = case.custom_sw_tonnes * 1000.0 * G_GRAV
        F = F.at[:, 2].add(-total / n_nodes)
    elif case.sw_mode != "none":
        raise ValueError(f"unknown self-weight mode {case.sw_mode!r}")

    # -- still-water buoyancy (beyond the reference) --
    if case.buoyancy != "none":
        F_b, c = _member_buoyancy(model.coords, model.conn, model.sections,
                                  model.sect_id, model.member_types,
                                  case.rho_water, case.buoyancy, L_m)
        contrib = jnp.concatenate([F_b * (1.0 - c), F_b * c])
        nodes = jnp.concatenate([model.conn[:, 0], model.conn[:, 1]])
        bz = jax.ops.segment_sum(contrib, nodes, num_segments=n_nodes)
        F = F.at[:, 2].add(bz)

    # -- wind (beyond the reference: API profile member drag + topside
    #    block; steady, so one case-constant contribution) --
    if case.wind_speed_ms:
        from .ops.wind import wind_member_forces, wind_topside_force
        D_struct = model.sections.D_outer[model.sect_id] / 1000.0
        w_nodal, _ = wind_member_forces(model.coords, model.conn, D_struct,
                                        case.wind_speed_ms,
                                        case.wind_dir_deg, Cs=case.wind_Cs)
        F = F.at[:, :3].add(w_nodal)
        if case.wind_topside_area_m2:
            top = model.top_mask.astype(dtype)
            n_top = jnp.maximum(jnp.sum(top), 1.0)
            z_top = jnp.sum(model.coords[:, 2] * top) / n_top
            Fw = wind_topside_force(case.wind_speed_ms,
                                    case.wind_topside_area_m2, z_top,
                                    Cs=case.wind_topside_Cs)
            th = jnp.deg2rad(jnp.asarray(90.0 - case.wind_dir_deg,
                                         dtype=dtype))
            per = Fw / n_top
            F = F.at[:, 0].add(top * per * jnp.cos(th))
            F = F.at[:, 1].add(top * per * jnp.sin(th))

    return F.reshape(-1)


# ---------------------------------------------------------------------------
# Core pipeline
# ---------------------------------------------------------------------------

def _recover(model: JacketModel, case: LoadCase, K, U, F, fixed_dofs,
             K_local, T, L_m, mor) -> AnalysisResults:
    """Reactions, member forces, stresses (`:492-533`)."""
    dofs = jnp.concatenate([6 * model.conn[:, 0:1] + jnp.arange(6),
                            6 * model.conn[:, 1:2] + jnp.arange(6)], axis=-1)
    u_elem = U[dofs]                                        # [M, 12]
    F1, F2 = internal_forces(K_local, T, u_elem)

    # von Mises from node-1 forces only, as the reference does (`:514-519`)
    vm = von_mises_8pt(model.sections, model.sect_id,
                       F1[:, 0], F1[:, 1], F1[:, 2],
                       F1[:, 3], F1[:, 4], F1[:, 5])
    util = vm / case.fy

    R = K @ U - F
    reac = R[jnp.asarray(fixed_dofs)].reshape(-1, 6)

    disp = jnp.linalg.norm(U.reshape(-1, 6)[:, :3], axis=-1)
    imax = jnp.argmax(disp)

    return AnalysisResults(
        U=U, reactions=reac, F_applied=F,
        F1_local=F1, F2_local=F2,
        von_mises=vm, utilization=util, length_m=L_m,
        morison=mor,
        max_displacement_mm=disp[imax], max_displacement_node=imax,
        total_reaction=jnp.sum(reac, axis=0),
    )


# The BCSR sparsity pattern depends only on the (static) mesh connectivity;
# rebuilding it host-side on every analyze(solver='pcg') call is wasteful in
# loops, so memoize on the connectivity bytes (bounded: meshes are few).
_PATTERN_CACHE: dict = {}
_AGG_CACHE: dict = {}


_SPLAN_CACHE: dict = {}


def _cached_structured_plan(pattern):
    """Host-side band/irregular classification of the BCSR pattern for the
    entry-major chunked-PCG path (ops/structured.py), memoized per
    pattern.  None for meshes without dominant tridiagonal structure."""
    from .ops.structured import plan_structured
    key = (pattern.n_nodes, np.asarray(pattern.block_rows).tobytes(),
           np.asarray(pattern.block_cols).tobytes())
    if key not in _SPLAN_CACHE:
        if len(_SPLAN_CACHE) >= 8:
            _SPLAN_CACHE.clear()
        _SPLAN_CACHE[key] = plan_structured(pattern)
    return _SPLAN_CACHE[key]


def _cached_aggregates(pattern, target_size: int = 32):
    """Host-side rigid-body-aggregate partition + sparse-prolongator slot
    plan for the two-level PCG preconditioner, memoized per pattern (the
    graph traversal is O(n) but pure Python).  Returns (agg, n_agg, plan)."""
    from .ops.coarse import aggregates_from_pattern, plan_sparse_p
    key = (pattern.n_nodes, target_size,
           np.asarray(pattern.block_rows).tobytes(),
           np.asarray(pattern.block_cols).tobytes())
    hit = _AGG_CACHE.get(key)
    if hit is None:
        if len(_AGG_CACHE) >= 8:
            _AGG_CACHE.clear()
        agg = aggregates_from_pattern(pattern, target_size)
        n_agg = int(agg.max()) + 1
        plan = plan_sparse_p(pattern, agg, n_agg)
        hit = (jnp.asarray(agg), n_agg, plan)
        _AGG_CACHE[key] = hit
    return hit


def _cached_bcsr_pattern(conn, n_nodes: int):
    key = (n_nodes, np.asarray(conn).tobytes())
    pat = _PATTERN_CACHE.get(key)
    if pat is None:
        if len(_PATTERN_CACHE) >= 8:
            _PATTERN_CACHE.clear()
        pat = build_bcsr_pattern(conn, n_nodes)
        _PATTERN_CACHE[key] = pat
    return pat


def analyze(model: JacketModel, wave: FourierWave, case: LoadCase,
            solver: str = "chol", n_gauss: int = 15, accel: str = "fd",
            pcg_tol: float = 1e-10, pcg_maxiter: int = 2000,
            pcg_precond: str = "auto", pcg_chunk: int = 0,
            lstsq_fallback: bool = False, mesh=None,
            stretching: str = "none", current_alpha=None,
            _jit: bool = True) -> AnalysisResults:
    """Single linear static analysis — the reference RUN-ANALYSIS pipeline
    (`JacketAnalysisGUI_v2.py:1827-2082`) as one compiled program.

    solver: 'lu' (reference-identical dense LU), 'chol' (dense Cholesky,
    SPD fast path), 'pcg' (matrix-free block-Jacobi PCG on BCSR; scales to
    1e5+ DOF where dense assembly is impossible).

    With ``mesh`` (a 1-D ``jax.sharding.Mesh``, any axis name) and
    ``solver='pcg'``, the linear solve runs as the DISTRIBUTED row-sharded
    PCG (`parallel/pcg_dist.py`): K's 6x6 node-block rows are partitioned
    across the mesh and the CG iteration runs inside ``shard_map`` with
    ``all_gather`` mat-vecs and ``psum`` reductions across devices.  Loads
    and recovery stay replicated (they are O(n) and trivially cheap next to
    the solve).

    ``pcg_precond``: 'block_jacobi' (the 6x6 nodal smoother) or
    'two_level' (block-Jacobi + a rigid-body-aggregate coarse correction,
    ops/coarse.py — cuts iteration counts ~5x on refined slender frames).
    'auto' picks 'two_level' for meshes above ~120 nodes.

    ``pcg_chunk`` (>0): run the CG loop in bounded segments of that many
    iterations per device program, checking convergence on the host
    between segments.  Required for ~100k-DOF f64 solves on hardware
    whose runtime watchdog kills multi-10s single programs (the result is
    iteration-for-iteration identical to the single-program path — same
    while_loop body, re-entered).
    """
    free_np, fixed_np = solve_mod.free_fixed_dofs(model.fixed_mask)
    free, fixed = jnp.asarray(free_np), jnp.asarray(fixed_np)
    if pcg_precond == "auto":
        pcg_precond = "two_level" if model.n_nodes >= 120 else "block_jacobi"
    if pcg_precond not in ("block_jacobi", "two_level"):
        raise ValueError(f"unknown pcg_precond {pcg_precond!r}")
    if mesh is not None:
        if solver != "pcg":
            raise ValueError("mesh-distributed analyze requires solver='pcg'")
        return _analyze_pcg_dist(model, wave, case.cast(model.coords.dtype),
                                 n_gauss, accel, fixed, mesh, pcg_tol,
                                 pcg_maxiter, stretching, current_alpha,
                                 pcg_precond)
    if solver == "pcg" and pcg_chunk:
        return _analyze_pcg_chunked(model, wave,
                                    case.cast(model.coords.dtype),
                                    n_gauss, accel, fixed, pcg_tol,
                                    pcg_maxiter, pcg_chunk, stretching,
                                    current_alpha, pcg_precond)
    if solver == "pcg":
        pattern = _cached_bcsr_pattern(model.conn, model.n_nodes)
        agg, n_agg, plan = (_cached_aggregates(pattern)
                            if pcg_precond == "two_level"
                            else (None, None, None))
    else:
        pattern, agg, n_agg, plan = None, None, None, None
    fn = _analyze_jit if _jit else _analyze_impl
    res = fn(model, wave, case.cast(model.coords.dtype), solver, n_gauss,
             accel, free, fixed, pattern, pcg_tol, pcg_maxiter,
             lstsq_fallback, stretching, current_alpha, agg, n_agg, plan)
    if solver == "pcg" and res.solver_residual is not None:
        rel = float(res.solver_residual)
        if not rel <= pcg_tol:  # catches NaN too
            import warnings
            warnings.warn(
                f"PCG did not converge: relative residual {rel:.2e} > "
                f"tol {pcg_tol:.1e} after {int(res.solver_iters)} iterations "
                f"(maxiter {pcg_maxiter}); results may be inaccurate",
                stacklevel=2)
    return res


@partial(jax.jit, static_argnames=("n_gauss", "accel", "stretching",
                                   "current_alpha"))
def _pcg_dist_prep(model, wave, case, pattern, n_gauss, accel, stretching,
                   current_alpha):
    with jax.default_matmul_precision("highest"):
        G = case.E / (2.0 * (1.0 + case.nu))
        conn_h, D_m, Cd_h, Cm_h = hydro_members(model, case.marine_growth_mm,
                                                case.Cd, case.Cm)
        mor = morison_loads(wave, model.coords, conn_h, D_m,
                            case.wave_dir_deg, case.current_dir_deg,
                            Cd_h, Cm_h, case.rho_water,
                            case.t_analysis, n_gauss=n_gauss, accel=accel,
                            stretching=stretching,
                            current_alpha=current_alpha,
                            slam_cs=case.slam_cs)
        Kg, K_local, T, L_m = element_stiffness(
            model.coords, model.conn, model.sections, model.sect_id,
            case.E, G, release=model.release)
        F = assemble_loads(model, case, mor.nodal_forces, L_m)
        A = assemble_bcsr(Kg, pattern)
        return mor, K_local, T, L_m, F, A


@jax.jit
def _pcg_dist_recover(model, case, A, U, F, fixed, K_local, T, L_m, mor,
                      n_iter, resid):
    with jax.default_matmul_precision("highest"):
        R = bcsr_matvec(A, U) - F
        return _recover_sparse(model, case, U, F, R, fixed,
                               K_local, T, L_m, mor,
                               solver_iters=n_iter, solver_residual=resid)


def _analyze_pcg_dist(model, wave, case, n_gauss, accel, fixed, mesh,
                      pcg_tol, pcg_maxiter, stretching="none",
                      current_alpha=None, pcg_precond="two_level"):
    """Distributed-PCG variant of the single-analysis pipeline.

    The jitted prep/recovery programs are module-level (compiled once per
    mesh topology, not per call)."""
    from .parallel.pcg_dist import distributed_pcg

    pattern = _cached_bcsr_pattern(model.conn, model.n_nodes)
    axis = mesh.axis_names[0]

    mor, K_local, T, L_m, F, A = _pcg_dist_prep(
        model, wave, case, pattern, n_gauss, accel, stretching,
        current_alpha)
    coarse = None
    if pcg_precond == "two_level":
        from .ops.coarse import build_coarse_space
        agg, n_agg, plan = _cached_aggregates(pattern)
        coarse = build_coarse_space(A, model.coords, model.fixed_mask,
                                    agg=agg, n_agg=n_agg, plan=plan)
    U, n_iter, resid = distributed_pcg(A, F, model.fixed_mask, mesh,
                                       axis=axis, tol=pcg_tol,
                                       maxiter=pcg_maxiter, coarse=coarse)
    U = U.astype(F.dtype)

    res = _pcg_dist_recover(model, case, A, U, F, fixed, K_local, T, L_m,
                            mor, n_iter, resid)
    rel = float(res.solver_residual)
    if not rel <= pcg_tol:
        import warnings
        warnings.warn(
            f"distributed PCG did not converge: relative residual "
            f"{rel:.2e} > tol {pcg_tol:.1e} after {int(res.solver_iters)} "
            f"iterations", stacklevel=3)
    return res


# --- chunked (host-segmented) PCG: the large-mesh single-chip route --------
#
# Written for an accelerator whose runtime watchdog killed a ~600-iteration
# f64 CG at ~100k DOF run as ONE device program; kept until measured on the
# GPU.  The chunked route reuses the distributed path's split programs
# (prep / solve / recover) and runs the CG while_loop in bounded segments,
# carrying the CG state across dispatches; the host checks convergence
# between segments.  It is also the only route to the entry-major band
# operators (ops/structured.py).

@partial(jax.jit, static_argnames=("n_agg",))
def _coarse_build_jit(A, coords, fixed_mask, agg, n_agg, plan):
    from .ops.coarse import build_coarse_space
    with jax.default_matmul_precision("highest"):
        return build_coarse_space(A, coords, fixed_mask, agg=agg,
                                  n_agg=n_agg, plan=plan)


def _chunk_ops(A, Dinv, coarse, fmask):
    op = solve_mod.projected_operator(lambda x: bcsr_matvec(A, x), fmask)
    pre = solve_mod.block_jacobi_apply(Dinv)
    if coarse is not None:
        from .ops.coarse import two_level_preconditioner
        pre = two_level_preconditioner(pre, coarse)
    return op, pre


@jax.jit
def _pcg_chunk_init(A, F, fixed_mask):
    with jax.default_matmul_precision("highest"):
        fmask = solve_mod.dof_free_mask(fixed_mask).astype(F.dtype)
        Dinv = solve_mod.block_jacobi_inverse(bcsr_block_diagonal(A), fmask)
        return fmask, Dinv


@jax.jit
def _pcg_chunk_start(A, Dinv, coarse, fmask, F):
    with jax.default_matmul_precision("highest"):
        b = fmask * F
        op, pre = _chunk_ops(A, Dinv, coarse, fmask)
        state = solve_mod.pcg_init(op, b, pre)
        return state, solve_mod.pcg_bnorm(b)


@jax.jit
def _pcg_chunk_run(A, Dinv, coarse, fmask, state, bnorm, tol, it_stop):
    with jax.default_matmul_precision("highest"):
        op, pre = _chunk_ops(A, Dinv, coarse, fmask)
        state = solve_mod.pcg_run(op, pre, state, bnorm, tol, it_stop)
        rel = jnp.linalg.norm(state[1]) / bnorm
        return state, rel


@jax.jit
def _pcg_chunk_build_em(A, plan, Dinv, coarse, fmask, F):
    """Entry-major repack + initial CG state in [6, n] layout
    (ops/structured.py; one device program per solve)."""
    from .ops import structured
    with jax.default_matmul_precision("highest"):
        sop = structured.build_structured(A, plan, Dinv, fmask, coarse)
        b = sop.fmask2 * F.reshape(-1, 6).T
        state = solve_mod.pcg_init(lambda X: structured.projected_matvec(sop, X),
                                   b, lambda R: structured.precond(sop, R))
        return sop, state, solve_mod.pcg_bnorm(b)


@jax.jit
def _pcg_chunk_run_em(sop, state, bnorm, tol, it_stop):
    from .ops import structured
    with jax.default_matmul_precision("highest"):
        state = solve_mod.pcg_run(
            lambda X: structured.projected_matvec(sop, X),
            lambda R: structured.precond(sop, R), state, bnorm, tol, it_stop)
        rel = jnp.linalg.norm(state[1]) / bnorm
        return state, rel


def _analyze_pcg_chunked(model, wave, case, n_gauss, accel, fixed,
                         pcg_tol, pcg_maxiter, pcg_chunk,
                         stretching="none", current_alpha=None,
                         pcg_precond="two_level"):
    """Single-device PCG analysis with the CG loop segmented into
    ``pcg_chunk``-iteration device programs (see module comment above)."""
    pattern = _cached_bcsr_pattern(model.conn, model.n_nodes)
    mor, K_local, T, L_m, F, A = _pcg_dist_prep(
        model, wave, case, pattern, n_gauss, accel, stretching,
        current_alpha)
    coarse = None
    if pcg_precond == "two_level":
        agg, n_agg, plan = _cached_aggregates(pattern)
        coarse = _coarse_build_jit(A, model.coords, model.fixed_mask, agg,
                                   n_agg=n_agg, plan=plan)
    fmask, Dinv = _pcg_chunk_init(A, F, model.fixed_mask)
    splan = _cached_structured_plan(pattern)
    tol_a = jnp.asarray(pcg_tol, F.dtype)
    done = 0
    rel = None
    if splan is not None:
        # chain-tridiagonal mesh: entry-major gather-free iteration
        # (ops/structured.py)
        sop, state, bnorm = _pcg_chunk_build_em(A, splan, Dinv, coarse,
                                                fmask, F)
        while done < pcg_maxiter:
            stop = min(done + int(pcg_chunk), pcg_maxiter)
            state, rel = _pcg_chunk_run_em(sop, state, bnorm, tol_a,
                                           jnp.asarray(stop))
            if int(state[4]) < stop or float(rel) <= pcg_tol:
                break
            done = stop
        U = (sop.fmask2 * state[0]).T.reshape(-1)
    else:
        state, bnorm = _pcg_chunk_start(A, Dinv, coarse, fmask, F)
        while done < pcg_maxiter:
            stop = min(done + int(pcg_chunk), pcg_maxiter)
            state, rel = _pcg_chunk_run(A, Dinv, coarse, fmask, state,
                                        bnorm, tol_a, jnp.asarray(stop))
            if int(state[4]) < stop or float(rel) <= pcg_tol:
                break
            done = stop
        U = fmask * state[0]
    res = _pcg_dist_recover(model, case, A, U, F, fixed, K_local, T, L_m,
                            mor, state[4], rel)
    relf = float(res.solver_residual)
    if not relf <= pcg_tol:
        import warnings
        warnings.warn(
            f"PCG did not converge: relative residual {relf:.2e} > tol "
            f"{pcg_tol:.1e} after {int(res.solver_iters)} iterations "
            f"(maxiter {pcg_maxiter}); results may be inaccurate",
            stacklevel=3)
    return res


@partial(jax.jit, static_argnames=("solver", "n_gauss", "accel",
                                   "pcg_tol", "pcg_maxiter",
                                   "lstsq_fallback", "stretching",
                                   "current_alpha", "n_agg"))
def _analyze_jit(model, wave, case, solver, n_gauss, accel, free, fixed,
                 pattern, pcg_tol, pcg_maxiter, lstsq_fallback=False,
                 stretching="none", current_alpha=None, agg=None,
                 n_agg=None, coarse_plan=None):
    # An accelerator may run f32 matmuls at reduced input precision by
    # default (TF32 on the GPU), which is catastrophic for stiffness
    # algebra; force full-precision products for everything inside the
    # solver pipeline.
    with jax.default_matmul_precision("highest"):
        return _analyze_impl(model, wave, case, solver, n_gauss, accel, free,
                             fixed, pattern, pcg_tol, pcg_maxiter,
                             lstsq_fallback, stretching, current_alpha,
                             agg, n_agg, coarse_plan)


def _analyze_impl(model, wave, case, solver, n_gauss, accel, free, fixed,
                  pattern, pcg_tol, pcg_maxiter, lstsq_fallback=False,
                  stretching="none", current_alpha=None, agg=None,
                  n_agg=None, coarse_plan=None):
    G = case.E / (2.0 * (1.0 + case.nu))                    # (`:443`)
    conn_h, D_m, Cd_h, Cm_h = hydro_members(model, case.marine_growth_mm,
                                            case.Cd, case.Cm)    # (`:610`)

    mor = morison_loads(wave, model.coords, conn_h, D_m,
                        case.wave_dir_deg, case.current_dir_deg,
                        Cd_h, Cm_h, case.rho_water, case.t_analysis,
                        n_gauss=n_gauss, accel=accel, stretching=stretching,
                        current_alpha=current_alpha, slam_cs=case.slam_cs)

    Kg, K_local, T, L_m = element_stiffness(
        model.coords, model.conn, model.sections, model.sect_id, case.E, G,
        release=model.release)

    F = assemble_loads(model, case, mor.nodal_forces, L_m)

    if solver in ("lu", "chol"):
        K = assemble_dense(Kg, model.conn, model.n_dof)
        if solver == "lu":
            # lstsq_fallback replicates the reference's singular-matrix
            # recovery (`JacketAnalysisGUI_v2.py:484-487`)
            U = solve_mod.solve_dense(K, F, free,
                                      lstsq_fallback=lstsq_fallback)
        else:
            fac = solve_mod.factor_dense(K, free)
            U = solve_mod.solve_factored(fac, F)
        return _recover(model, case, K, U, F, fixed,
                        K_local, T, L_m, mor)
    elif solver == "pcg":
        A = assemble_bcsr(Kg, pattern)
        fmask = solve_mod.dof_free_mask(model.fixed_mask).astype(F.dtype)
        op = solve_mod.projected_operator(lambda x: bcsr_matvec(A, x), fmask)
        pre = solve_mod.block_jacobi_preconditioner(bcsr_block_diagonal(A), fmask)
        if agg is not None:
            from .ops.coarse import (build_coarse_space,
                                     two_level_preconditioner)
            cs = build_coarse_space(A, model.coords, model.fixed_mask,
                                    agg=agg, n_agg=n_agg, plan=coarse_plan)
            pre = two_level_preconditioner(pre, cs)
        res = solve_mod.pcg(op, fmask * F, precond=pre, tol=pcg_tol,
                            maxiter=pcg_maxiter)
        U = fmask * res.x
        R = bcsr_matvec(A, U) - F
        return _recover_sparse(model, case, U, F, R, fixed,
                               K_local, T, L_m, mor,
                               solver_iters=res.n_iter,
                               solver_residual=res.residual)
    else:
        raise ValueError(f"unknown solver {solver!r}")


def _recover_sparse(model, case, U, F, R, fixed_dofs, K_local, T, L_m, mor,
                    solver_iters=None, solver_residual=None):
    dofs = jnp.concatenate([6 * model.conn[:, 0:1] + jnp.arange(6),
                            6 * model.conn[:, 1:2] + jnp.arange(6)], axis=-1)
    u_elem = U[dofs]
    F1, F2 = internal_forces(K_local, T, u_elem)
    vm = von_mises_8pt(model.sections, model.sect_id,
                       F1[:, 0], F1[:, 1], F1[:, 2],
                       F1[:, 3], F1[:, 4], F1[:, 5])
    util = vm / case.fy
    reac = R[fixed_dofs].reshape(-1, 6)
    disp = jnp.linalg.norm(U.reshape(-1, 6)[:, :3], axis=-1)
    imax = jnp.argmax(disp)
    return AnalysisResults(
        U=U, reactions=reac, F_applied=F,
        F1_local=F1, F2_local=F2,
        von_mises=vm, utilization=util, length_m=L_m,
        morison=mor,
        max_displacement_mm=disp[imax], max_displacement_node=imax,
        total_reaction=jnp.sum(reac, axis=0),
        solver_iters=solver_iters, solver_residual=solver_residual,
    )


def analyze_ssi(model: JacketModel, wave: FourierWave, case: LoadCase,
                support_stiffness, n_gauss: int = 15, accel: str = "fd",
                stretching: str = "none",
                current_alpha=None) -> AnalysisResults:
    """Linear soil-structure interaction: supports on foundation springs.

    Replaces the rigid clamp at the support nodes (the reference's only
    boundary condition, `JacketAnalysisGUI_v2.py:473-479`; SSI is on its
    exclusion list) with a 6-DOF linear spring at each fixed node:
    ``K + diag(k)`` is solved over ALL DOFs and the spring forces
    ``-k u_support`` become the reactions.  ``support_stiffness`` is a
    [6] vector (every support identical) or [n_fixed, 6], in N/mm for
    translations and N*mm/rad for rotations — e.g. pile-head stiffnesses
    from a geotechnical pushover.  As k -> inf the clamped solution is
    recovered (tested); softer springs lengthen the load path and grow
    displacements monotonically.

    Dense path (the spring-grounded K stays SPD): use on the coarse model
    or mild refinements, like :func:`analyze`'s dense solvers.
    """
    ks = solve_mod.support_spring_nodes(model.fixed_mask, support_stiffness)
    fixed_nodes = np.where(np.asarray(model.fixed_mask))[0]
    dtype = model.coords.dtype
    k = jnp.asarray(ks[fixed_nodes]).astype(dtype)
    return _analyze_ssi_jit(model, wave, case.cast(dtype), k, n_gauss,
                            accel, stretching, current_alpha,
                            jnp.asarray(fixed_nodes))


@partial(jax.jit, static_argnames=("n_gauss", "accel", "stretching",
                                   "current_alpha"))
def _analyze_ssi_jit(model, wave, case, k_nodes, n_gauss, accel,
                     stretching, current_alpha, fixed_nodes):
    with jax.default_matmul_precision("highest"):
        G = case.E / (2.0 * (1.0 + case.nu))
        conn_h, D_m, Cd_h, Cm_h = hydro_members(model, case.marine_growth_mm,
                                                case.Cd, case.Cm)
        mor = morison_loads(wave, model.coords, conn_h, D_m,
                            case.wave_dir_deg, case.current_dir_deg,
                            Cd_h, Cm_h, case.rho_water,
                            case.t_analysis, n_gauss=n_gauss, accel=accel,
                            stretching=stretching,
                            current_alpha=current_alpha,
                            slam_cs=case.slam_cs)
        Kg, K_local, T, L_m = element_stiffness(
            model.coords, model.conn, model.sections, model.sect_id,
            case.E, G, release=model.release)
        F = assemble_loads(model, case, mor.nodal_forces, L_m)
        K = assemble_dense(Kg, model.conn, model.n_dof)
        sdofs = (6 * fixed_nodes[:, None] + jnp.arange(6)).reshape(-1)
        K2 = K.at[sdofs, sdofs].add(k_nodes.reshape(-1))
        fac = solve_mod.factor_dense(K2, jnp.arange(model.n_dof))
        U = solve_mod.solve_factored(fac, F)
        # reactions through the SPRINGLESS K: (K U - F) at the support DOFs
        # equals exactly -k u_support (the spring force), zero elsewhere —
        # the same recovery expression as the clamped path
        return _recover(model, case, K, U, F, sdofs, K_local, T, L_m, mor)


def analyze_pdelta(model: JacketModel, wave: FourierWave, case: LoadCase,
                   n_iter: int = 3, n_gauss: int = 15, accel: str = "fd",
                   stretching: str = "none", current_alpha=None,
                   support_stiffness=None) -> AnalysisResults:
    """Second-order (P-delta) static analysis.

    Equilibrium on the deformed geometry, linearized through the consistent
    geometric stiffness: solve ``(K - K_G(N)) U = F`` where ``N`` are the
    member axial forces (positive in compression), fixed-point iterated
    ``n_iter`` times from the linear solution (N converges in 1-2 rounds
    for load factors comfortably below buckling; the default 3 is
    conservative).  This is the classic amplification effect the reference
    explicitly excludes (`JacketAnalysisGUI_v2.py:1544-1799` exclusion
    list: "no P-delta") — for a member/system at axial load P the lateral
    response amplifies by ~1/(1 - P/P_cr).

    The corrected system loses positive definiteness when the applied case
    exceeds the elastic buckling load (lambda_cr < 1 in
    :func:`buckling_analysis`); the Cholesky then produces NaNs, which is
    the honest signal that a second-order STATIC equilibrium does not
    exist.  Results carry ``pdelta_amplification`` = max nodal displacement
    ratio vs the first-order solution.

    ``support_stiffness`` combines P-delta with foundation springs (see
    :func:`analyze_ssi`): the corrected system is ``K + diag(k) - K_G``.
    """
    free_np, fixed_np = solve_mod.free_fixed_dofs(model.fixed_mask)
    ks_diag = None
    if support_stiffness is not None:
        ks = solve_mod.support_spring_nodes(model.fixed_mask,
                                            support_stiffness)
        ks_diag = jnp.asarray(ks.reshape(-1)).astype(model.coords.dtype)
        free_np = np.arange(model.n_dof)
    return _analyze_pdelta_jit(model, wave, case.cast(model.coords.dtype),
                               n_iter, n_gauss, accel, stretching,
                               current_alpha, ks_diag, jnp.asarray(free_np),
                               jnp.asarray(fixed_np))


@partial(jax.jit, static_argnames=("n_iter", "n_gauss", "accel",
                                   "stretching", "current_alpha"))
def _analyze_pdelta_jit(model, wave, case, n_iter, n_gauss, accel,
                        stretching, current_alpha, ks_diag, free, fixed):
    from .ops.buckling import element_geometric_stiffness

    with jax.default_matmul_precision("highest"):
        G = case.E / (2.0 * (1.0 + case.nu))
        conn_h, D_m, Cd_h, Cm_h = hydro_members(model, case.marine_growth_mm,
                                                case.Cd, case.Cm)
        mor = morison_loads(wave, model.coords, conn_h, D_m,
                            case.wave_dir_deg, case.current_dir_deg,
                            Cd_h, Cm_h, case.rho_water,
                            case.t_analysis, n_gauss=n_gauss, accel=accel,
                            stretching=stretching,
                            current_alpha=current_alpha,
                            slam_cs=case.slam_cs)
        Kg, K_local, T, L_m = element_stiffness(
            model.coords, model.conn, model.sections, model.sect_id,
            case.E, G, release=model.release)
        W_rel = None
        if model.release is not None:
            from .ops.beams import release_W
            W_rel = release_W(model.coords, model.conn, model.sections,
                              model.sect_id, case.E, G, model.release)
        F = assemble_loads(model, case, mor.nodal_forces, L_m)
        K = assemble_dense(Kg, model.conn, model.n_dof)

        U = solve_mod.solve_factored(_spring_dfac(K, ks_diag, free), F)
        dofs = jnp.concatenate([6 * model.conn[:, 0:1] + jnp.arange(6),
                                6 * model.conn[:, 1:2] + jnp.arange(6)],
                               axis=-1)
        disp1 = jnp.linalg.norm(U.reshape(-1, 6)[:, :3], axis=-1)
        K2 = K
        for _ in range(n_iter):
            # axial force sign convention: see buckling.member_axial_forces
            F1, _ = internal_forces(K_local, T, U[dofs])
            N = -F1[:, 0]
            KGg = element_geometric_stiffness(model.coords, model.conn, N,
                                              W=W_rel)
            K2 = K - assemble_dense(KGg, model.conn, model.n_dof)
            U = solve_mod.solve_factored(_spring_dfac(K2, ks_diag, free), F)
        res = _recover(model, case, K2, U, F, fixed, K_local, T, L_m, mor)
        disp2 = jnp.linalg.norm(U.reshape(-1, 6)[:, :3], axis=-1)
        amp = jnp.max(jnp.where(disp1 > 0, disp2 / jnp.where(disp1 > 0,
                                                             disp1, 1.0),
                                1.0))
        return res._replace(pdelta_amplification=amp)


def analyze_phase_batch(model: JacketModel, wave: FourierWave, case: LoadCase,
                        n_steps: int = 36, n_gauss: int = 15,
                        accel: str = "analytic") -> tuple[jnp.ndarray, AnalysisResults]:
    """Solve the FULL structural problem at every phase of one wave period.

    This is the capability upgrade over the reference: its phase scan
    (`JacketAnalysisGUI_v2.py:684-724`) only tracks total Morison force and
    the subsequent FEM solve still uses the user's single ``t``; here the
    stiffness is factored ONCE and all ``n_steps`` phases are solved as one
    multi-RHS triangular solve, so displacements/stresses at the true
    critical phase come for free.

    ``accel`` defaults to 'analytic' here (unlike ``analyze``, whose 'fd'
    default replicates the reference's single-solve semantics): the
    reference's dt=1e-3 finite difference produces an O(u/dt) inertia SPIKE
    at any phase where a quadrature point emerges from the water inside the
    dt window, and densely sampled phase batches WILL hit such phases
    (measured: a 72-step storm batch reports a spurious 192% utilization at
    one phase under 'fd' vs 24% under 'analytic').  Pass ``accel='fd'``
    explicitly for bit-level reference semantics.

    Returns (ts [S], batched AnalysisResults with leading phase axis).
    """
    free_np, fixed_np = solve_mod.free_fixed_dofs(model.fixed_mask)
    return _phase_batch_jit(model, wave, case.cast(model.coords.dtype),
                            n_steps, n_gauss, accel,
                            jnp.asarray(free_np), jnp.asarray(fixed_np))


@partial(jax.jit, static_argnames=("n_steps", "n_gauss", "accel"))
def _phase_batch_jit(model, wave, case, n_steps, n_gauss, accel, free, fixed):
    with jax.default_matmul_precision("highest"):
        return _phase_batch_impl(model, wave, case, n_steps, n_gauss, accel,
                                 free, fixed)


def _phase_batch_impl(model, wave, case, n_steps, n_gauss, accel, free, fixed):
    G = case.E / (2.0 * (1.0 + case.nu))
    conn_h, D_m, Cd_h, Cm_h = hydro_members(model, case.marine_growth_mm,
                                            case.Cd, case.Cm)
    dtype = model.coords.dtype
    ts = jnp.arange(n_steps, dtype=dtype) * wave.T / n_steps

    Kg, K_local, T, L_m = element_stiffness(
        model.coords, model.conn, model.sections, model.sect_id, case.E, G,
        release=model.release)
    K = assemble_dense(Kg, model.conn, model.n_dof)
    fac = solve_mod.factor_dense(K, free)

    def loads_at(t):
        mor = morison_loads(wave, model.coords, conn_h, D_m,
                            case.wave_dir_deg, case.current_dir_deg,
                            Cd_h, Cm_h, case.rho_water, t,
                            n_gauss=n_gauss, accel=accel,
                            slam_cs=case.slam_cs)
        return assemble_loads(model, case, mor.nodal_forces, L_m), mor

    F_batch, mor_batch = jax.vmap(loads_at)(ts)            # [S, n_dof]
    U_batch = solve_mod.solve_factored(fac, F_batch)        # [S, n_dof]

    def recover(U, F, mor):
        return _recover(model, case, K, U, F, fixed,
                        K_local, T, L_m, mor)

    results = jax.vmap(recover)(U_batch, F_batch, mor_batch)
    return ts, results


def _check_no_slam(case: LoadCase, path: str) -> None:
    """Separable/spectral matmul paths cannot carry the slam term."""
    if case.slam_cs:
        raise ValueError(
            f"{path} uses the separable phase/spectral kinematics matmul; "
            "slamming (slam_cs > 0) runs on the pointwise paths only "
            "(analyze, analyze_phase_batch, design_sweep, "
            "phase_scan_condensed(kinematics='pointwise'))")


def _check_shared_material(cases: LoadCase) -> None:
    """Envelope solvers factor K once, so E/nu must not vary across cases."""
    for name in ("E", "nu"):
        v = np.asarray(getattr(cases, name))
        if v.ndim > 0 and not np.all(v == v.flat[0]):
            raise ValueError(
                f"design envelopes share one stiffness factorization: "
                f"case field {name!r} must be identical across the batch")


def _check_refined_layout(coarse: JacketModel, refined: JacketModel,
                          n_seg: int) -> None:
    """The condensation solver requires refine_model's member-major layout."""
    Mc = coarse.n_members
    if refined.n_members != Mc * n_seg or             refined.n_nodes != coarse.n_nodes + Mc * (n_seg - 1):
        raise ValueError(
            "refined model does not match refine_model(coarse, n_seg) sizes")
    rc = np.asarray(refined.conn)
    cc = np.asarray(coarse.conn)
    if not (np.array_equal(rc[::n_seg, 0], cc[:, 0])
            and np.array_equal(rc[n_seg - 1::n_seg, 1], cc[:, 1])):
        raise ValueError(
            "refined model connectivity is not in refine_model's "
            "member-major chain layout")


class CondensedScanResults(NamedTuple):
    """Results of a condensed multi-phase scan (leading axis = phase)."""

    ts: jnp.ndarray               # [S] phase times
    U: jnp.ndarray                # [S, n_dof_refined] displacements (mm/rad)
    von_mises: jnp.ndarray        # [S, M_refined] MPa
    utilization: jnp.ndarray      # [S, M_refined]
    reactions: jnp.ndarray        # [S, n_fixed, 6]
    total_morison: jnp.ndarray    # [S, 3] N
    critical_index: jnp.ndarray   # argmax_s max_m utilization


def phase_scan_condensed(coarse: JacketModel, refined: JacketModel,
                         n_seg: int, wave, case: LoadCase,
                         n_steps: int = 360, n_gauss: int = 15,
                         accel: str = "analytic",
                         kinematics: str = "separable",
                         chain_solver: str = "auto",
                         solve_dtype=jnp.float64,
                         refine_steps: int = 1,
                         stretching: str = "none",
                         current_alpha=None,
                         support_stiffness=None) -> CondensedScanResults:
    """Full FEM phase scan of a refined jacket via exact chain condensation.

    The flagship large-mesh path (see ops/condense.py): interior DOFs of all
    refined member chains are eliminated exactly, so each phase's solve acts
    on the original interface DOFs only.  Hydrodynamic loads are evaluated in
    the model dtype (float32 on the fast path — bandwidth-heavy,
    precision-insensitive)
    while the condensation/solve/recovery chain runs in ``solve_dtype``
    (float64 by default — negligible FLOPs, and immune to the
    refinement-induced conditioning that breaks float32 dense solvers).

    ``kinematics='separable'`` evaluates all phases' wave kinematics through
    one harmonic matmul (see ``morison_phase_batch``; analytic acceleration,
    no surface clamp); ``'pointwise'`` re-evaluates per phase with the
    reference's exact semantics (``accel`` applies there).

    ``refined`` must come from ``refine_model(coarse, n_seg)`` (member-major
    interior node layout).

    ``refine_steps`` rounds of iterative refinement (element-level residual
    matvec + one more condensed solve, O(n) each) run after the direct
    solve; with the default 1 round the float32 path measures ~4e-5 relative
    displacement error vs float64 at the flagship 9.6k-DOF scale (without it
    the f32 chain sweeps carry ~4e-3 — see tests/test_condense.py).

    ``support_stiffness`` puts the supports on 6-DOF foundation springs
    (soil-structure interaction; see :func:`analyze_ssi`) — every phase is
    then solved on the sprung system and the reactions are spring forces.

    Repeated calls with the SAME model objects and material reuse the
    case-independent factorization automatically (a bounded
    identity-keyed cache of :func:`prepare_condensed` handles, up to 4
    models); use :func:`prepare_condensed` + :func:`phase_scan_prepared`
    to manage the handle lifetime explicitly.
    """
    _check_refined_layout(coarse, refined, n_seg)
    # Repeated one-shot scans of the SAME model objects auto-reuse the
    # case-independent factorization (the chain factor depends only on
    # (model, E, nu, springs) — the exact quantity prepare_condensed
    # exposes).  Keyed on OBJECT IDENTITY of the model pytrees, with strong
    # references held by the cache so ids stay valid while cached; a user
    # who rebuilds the model gets a fresh factorization.  The pointwise
    # kinematics path is excluded: it predates the chain-layout loads and
    # runs through the original single program (golden-parity path).
    if kinematics == "separable":
        prep = _cached_prepared(coarse, refined, n_seg, case, chain_solver,
                                solve_dtype, support_stiffness)
        return _phase_scan_prepared_jit(prep, wave, case.cast(solve_dtype),
                                        n_steps, n_gauss, accel, kinematics,
                                        refine_steps, stretching,
                                        current_alpha)
    ks_nodes, free_np, fixed_np = _ssi_spring_nodes(coarse,
                                                    support_stiffness,
                                                    solve_dtype)
    return _phase_scan_condensed_jit(
        coarse, refined, wave, case.cast(solve_dtype), n_seg, n_steps,
        n_gauss, accel, kinematics, chain_solver, solve_dtype, refine_steps,
        stretching, current_alpha, ks_nodes, jnp.asarray(free_np),
        jnp.asarray(fixed_np))


_PREP_CACHE: dict = {}


def _cached_prepared(coarse, refined, n_seg, case, chain_solver, solve_dtype,
                     support_stiffness) -> "CondensedPrepared":
    """prepare_condensed memoized on model identity + material + solver
    config (bounded; holds strong model refs so the id keys stay valid)."""
    ss_key = None if support_stiffness is None \
        else np.asarray(support_stiffness, np.float64).tobytes()
    key = (id(coarse), id(refined), n_seg, float(np.asarray(case.E)),
           float(np.asarray(case.nu)), chain_solver,
           jnp.dtype(solve_dtype).name, ss_key)
    hit = _PREP_CACHE.get(key)
    if hit is None:
        if len(_PREP_CACHE) >= 4:
            _PREP_CACHE.clear()
        prep = prepare_condensed(coarse, refined, n_seg, E=case.E,
                                 nu=case.nu, chain_solver=chain_solver,
                                 solve_dtype=solve_dtype,
                                 support_stiffness=support_stiffness)
        hit = (coarse, refined, prep)     # strong refs pin the id keys
        _PREP_CACHE[key] = hit
    return hit[2]


_CB_CACHE: dict = {}


def _cached_cb_reduce(coarse, refined, n_seg, E, nu, topside_mass_t,
                      n_chain_modes, support_stiffness, added_mass_Ca,
                      rho_water):
    """Craig-Bampton reduction memoized on model identity + parameters —
    the reduction is sea-state-independent, so scatter sweeps pay the
    eigen-factorization once (same bounded identity-key pattern as
    :data:`_PREP_CACHE`)."""
    from .ops.dynamics import _cb_reduce

    ss_key = None if support_stiffness is None \
        else np.asarray(support_stiffness, np.float64).tobytes()
    ca_key = None if added_mass_Ca is None \
        else np.asarray(added_mass_Ca, np.float64).tobytes()
    key = (id(coarse), id(refined), n_seg, float(E), float(nu),
           float(topside_mass_t), int(n_chain_modes), ss_key, ca_key,
           float(rho_water))
    hit = _CB_CACHE.get(key)
    if hit is None:
        if len(_CB_CACHE) >= 4:
            _CB_CACHE.clear()
        cb = _cb_reduce(coarse, refined, n_seg, E, nu, topside_mass_t,
                        n_chain_modes, support_stiffness=support_stiffness,
                        added_mass_Ca=added_mass_Ca, rho_water=rho_water)
        hit = (coarse, refined, cb)       # strong refs pin the id keys
        _CB_CACHE[key] = hit
    return hit[2]


@partial(jax.jit, static_argnames=("n_seg", "n_steps", "n_gauss", "accel",
                                   "kinematics", "chain_solver",
                                   "solve_dtype", "refine_steps",
                                   "stretching", "current_alpha"))
def _phase_scan_condensed_jit(coarse, refined, wave, case, n_seg, n_steps,
                              n_gauss, accel, kinematics, chain_solver,
                              solve_dtype, refine_steps, stretching,
                              current_alpha, ks_nodes, free, fixed):
    with jax.default_matmul_precision("highest"):
        return _phase_scan_condensed_impl(coarse, refined, wave, case, n_seg,
                                          n_steps, n_gauss, accel, kinematics,
                                          chain_solver, solve_dtype,
                                          refine_steps, stretching,
                                          current_alpha, ks_nodes, free,
                                          fixed)


def _resolve_chain_solver(n_seg: int, chain_solver: str) -> str:
    """Resolve 'auto' to a concrete chain-solver name (host-side, static).

    'auto': 'nested' when the chain is deep enough for the scan depth to
    dominate (n_seg >= 16) and n_seg is composite, else 'thomas' (nested
    shrinks the sequential factor scan of the flagship n_seg=32 from 31 to
    7+3 steps, and its shallower chains are slightly MORE float32-accurate
    — both solvers are exact direct methods).
    """
    if chain_solver == "auto":
        chain_solver = "thomas"
        if n_seg >= 16:
            try:
                condense_mod.nested_split(n_seg)
            except ValueError:
                pass  # prime depth: no balanced split, keep thomas
            else:
                chain_solver = "nested"
    if chain_solver not in ("thomas", "nested"):
        raise ValueError(f"unknown chain_solver {chain_solver!r}")
    return chain_solver


def _chain_fns(chain_solver: str):
    """(factor_fn, condense_fn, backsub_fn) for a RESOLVED chain solver."""
    if chain_solver == "thomas":
        return (condense_mod.factor_chains,
                condense_mod.condense_loads,
                condense_mod.back_substitute)
    return (condense_mod.factor_chains_nested,
            condense_mod.condense_loads_nested,
            condense_mod.back_substitute_nested)


def _chain_factor(Kg, n_seg: int, chain_solver: str):
    """(factor, condense_fn, backsub_fn) for the requested chain solver.

    'thomas': flat block-Thomas scans (scan depth n_seg); 'nested':
    two-level condensation (scan depth ~2 sqrt(n_seg); float32-stable at
    deep refinement, where 'thomas' needs float64 past ~100 segments).
    (A PCR chain solver was built and retired: its factor cost was never
    repaid and it was f32-unstable; docs/ARCHITECTURE.md section 8.)
    """
    chain_solver = _resolve_chain_solver(n_seg, chain_solver)
    factor_fn, condense_fn, backsub_fn = _chain_fns(chain_solver)
    return factor_fn(Kg, n_seg), condense_fn, backsub_fn


def _chain_layout_loads(coarse: JacketModel, refined: JacketModel,
                        case: LoadCase, F1, F2, L_m, n_seg: int):
    """Load vectors for the condensed solver, built DIRECTLY in its chain
    layout — no [S, n_dof] scatter/reshape ever materializes.

    Semantics identical to ``assemble_loads`` + the reshape/swapaxes in the
    condensed scan: the member-major chain layout makes every interior
    node's load a slice sum (chain node p joins element p-1's far end and
    element p's near end), and only the 2*Mc chain ends need a (tiny)
    scatter onto the coarse interface nodes.

    ``F1``/``F2``: [S, Mr, 3] Morison member end forces (N) — or
    [S, Mr + A, 3] when the model carries A appurtenances (hydro-only
    rows appended by :func:`..ops.morison.hydro_members`; their end
    forces land directly on the coarse interface nodes below);
    ``L_m``: [Mr] refined element lengths in metres.
    Returns (F_I_nodes [S, nc, 6], g [S, n_int, Mc, 6]).
    """
    dtype = F1.dtype
    nc, Mc = coarse.n_nodes, coarse.n_members
    n_int = n_seg - 1
    S = F1.shape[0]
    Mr = Mc * n_seg
    F1a, F2a = F1[:, Mr:], F2[:, Mr:]                   # [S, A, 3] (A >= 0)
    F1c = F1[:, :Mr].reshape(S, Mc, n_seg, 3)
    F2c = F2[:, :Mr].reshape(S, Mc, n_seg, 3)

    # -- interior chain nodes --
    g3 = F2c[:, :, :-1] + F1c[:, :, 1:]                 # [S, Mc, n_int, 3]
    g = jnp.concatenate([g3, jnp.zeros_like(g3)], axis=-1)

    # -- interface (coarse) nodes --
    per_top = _topside_per_node(case, coarse.top_mask, dtype)
    top = coarse.top_mask.astype(dtype)
    F_I = jnp.broadcast_to(top[:, None] * per_top[None, :],
                           (S, nc, 6)).astype(dtype)
    ends = jnp.concatenate([F1c[:, :, 0], F2c[:, :, -1]], axis=1)  # [S, 2Mc, 3]
    nodes = jnp.concatenate([coarse.conn[:, 0], coarse.conn[:, 1]])
    end_nodes = nodes
    if F1a.shape[1] > 0:  # appurtenance end forces -> their guide nodes
        ends = jnp.concatenate([ends, F1a, F2a], axis=1)
        end_nodes = jnp.concatenate([nodes, coarse.app_conn[:, 0],
                                     coarse.app_conn[:, 1]])
    nodal = jax.vmap(lambda c: jax.ops.segment_sum(
        c, end_nodes, num_segments=nc))(ends)
    F_I = F_I.at[..., :3].add(nodal)

    # -- self-weight (`:1995-2013`), distributed over the REFINED mesh --
    if case.sw_mode == "calculated":
        mass_per_m = refined.sections.mass_per_m[refined.sect_id]
        half = (mass_per_m.astype(dtype) * G_GRAV
                * L_m.astype(dtype) / 2.0).reshape(Mc, n_seg)   # N
        g = g.at[..., 2].add(-(half[:, :-1] + half[:, 1:]))
        wI = jax.ops.segment_sum(
            jnp.concatenate([half[:, 0], half[:, -1]]), nodes, num_segments=nc)
        F_I = F_I.at[..., 2].add(-wI)
    elif case.sw_mode == "custom":
        per_node = case.custom_sw_tonnes * 1000.0 * G_GRAV / refined.n_nodes
        g = g.at[..., 2].add(-per_node)
        F_I = F_I.at[..., 2].add(-per_node)
    elif case.sw_mode != "none":
        raise ValueError(f"unknown self-weight mode {case.sw_mode!r}")

    # -- still-water buoyancy over the refined mesh (beyond the reference) --
    if case.buoyancy != "none":
        F_b, cw = _member_buoyancy(refined.coords, refined.conn,
                                   refined.sections, refined.sect_id,
                                   refined.member_types, case.rho_water,
                                   case.buoyancy, L_m)
        w1 = (F_b * (1.0 - cw)).reshape(Mc, n_seg).astype(dtype)
        w2 = (F_b * cw).reshape(Mc, n_seg).astype(dtype)
        g = g.at[..., 2].add(w2[:, :-1] + w1[:, 1:])
        bI = jax.ops.segment_sum(
            jnp.concatenate([w1[:, 0], w2[:, -1]]), nodes, num_segments=nc)
        F_I = F_I.at[..., 2].add(bI)

    # -- wind over the refined mesh (beyond the reference; steady, so one
    #    S-independent contribution folded like the Morison end forces) --
    if case.wind_speed_ms:
        from .ops.wind import wind_member_ends, wind_topside_force
        D_struct = (refined.sections.D_outer[refined.sect_id]
                    / 1000.0).astype(dtype)
        F1w, F2w = wind_member_ends(refined.coords.astype(dtype),
                                    refined.conn, D_struct,
                                    case.wind_speed_ms, case.wind_dir_deg,
                                    Cs=case.wind_Cs)
        w1 = F1w.reshape(Mc, n_seg, 3)
        w2 = F2w.reshape(Mc, n_seg, 3)
        g = g.at[..., :3].add(w2[:, :-1] + w1[:, 1:])
        wI = jax.ops.segment_sum(
            jnp.concatenate([w1[:, 0], w2[:, -1]]), nodes, num_segments=nc)
        F_I = F_I.at[..., :3].add(wI)
        if case.wind_topside_area_m2:
            top = coarse.top_mask.astype(dtype)
            n_top = jnp.maximum(jnp.sum(top), 1.0)
            z_top = jnp.sum(coarse.coords[:, 2].astype(dtype) * top) / n_top
            Fw = wind_topside_force(case.wind_speed_ms,
                                    case.wind_topside_area_m2, z_top,
                                    Cs=case.wind_topside_Cs)
            th = jnp.deg2rad(jnp.asarray(90.0 - case.wind_dir_deg,
                                         dtype=dtype))
            per = Fw.astype(dtype) / n_top
            F_I = F_I.at[..., 0].add(top * per * jnp.cos(th))
            F_I = F_I.at[..., 1].add(top * per * jnp.sin(th))

    return F_I, g.swapaxes(1, 2)


def _condensed_solve(F_I_nodes, g, fac, dfac, _condense, _backsub,
                     node1, node2):
    """One full condensed direct solve in the chain layout.

    ``F_I_nodes``: [S, nc, 6] interface loads; ``g``: [S, n_int, Mc, 6]
    interior loads.  Returns (U_In [S, nc, 6], v [S, n_int, Mc, 6],
    F_cond_flat [S, 6 nc], U_I [S, 6 nc]).
    """
    S, nc = F_I_nodes.shape[:2]
    fI, fJ, v_g = _condense(fac, g)
    F_cond = F_I_nodes.at[:, node1].add(fI).at[:, node2].add(fJ)
    F_cond_flat = F_cond.reshape(S, -1)
    U_I = solve_mod.solve_factored(dfac, F_cond_flat)      # [S, 6 nc]
    U_In = U_I.reshape(S, nc, 6)
    v = _backsub(fac, v_g, U_In[:, node1], U_In[:, node2])
    return U_In, v, F_cond_flat, U_I


def _refine_condensed(Kg, n_seg, conn_coarse, fixed_free_mask, solve_once,
                      F_I_nodes, g, U_In, v, U_I, refine_steps,
                      ks_nodes=None):
    """Iterative refinement in the chain layout: residual via
    ``chain_matvec`` (no refined-DOF gather/scatter), one more condensed
    solve per round.  ``ks_nodes`` ([nc, 6] foundation-spring diagonal,
    SSI mode) joins the residual: the solved operator is K + diag(ks).
    Returns updated (U_In, v, U_I)."""
    for _ in range(refine_steps):
        y_I, y_int = condense_mod.chain_matvec(Kg, n_seg, conn_coarse,
                                               U_In, v)
        r_I = F_I_nodes - y_I
        if ks_nodes is not None:
            r_I = r_I - ks_nodes * U_In
        r_I = r_I * fixed_free_mask                        # fixed rows -> 0
        r_int = g - y_int
        dU_In, dv, _, dU_I = solve_once(r_I, r_int)
        U_In = U_In + dU_In
        v = v + dv
        U_I = U_I + dU_I
    return U_In, v, U_I


def _ssi_spring_nodes(coarse, support_stiffness, solve_dtype):
    """Foundation-spring prep shared by the condensed SSI entry points.

    Returns ``(ks_nodes, free_np, fixed_np)``: the per-coarse-node spring
    diagonal ([nc, 6], zero off the supports; None when unsprung), and the
    free/fixed DOF index arrays — ALL DOFs are free in SSI mode (the
    springs ground the structure).
    """
    free_np, fixed_np = solve_mod.free_fixed_dofs(coarse.fixed_mask)
    if support_stiffness is None:
        return None, free_np, fixed_np
    ks = solve_mod.support_spring_nodes(coarse.fixed_mask, support_stiffness)
    return (jnp.asarray(ks).astype(solve_dtype),
            np.arange(6 * coarse.n_nodes), fixed_np)


def _spring_dfac(K_I, ks_nodes, free):
    """Factor the interface system, grounded through foundation springs in
    SSI mode.  K_I itself stays springless so the reaction recovery
    ``R = K_I U - F`` yields the spring forces exactly."""
    if ks_nodes is None:
        return solve_mod.factor_dense(K_I, free)
    idx = jnp.arange(K_I.shape[0])
    return solve_mod.factor_dense(
        K_I.at[idx, idx].add(ks_nodes.reshape(-1)), free)


def _refine_mask(coarse, ks_nodes, solve_dtype):
    """Free-equation mask for the refinement residual: clamped rows are
    zeroed; in SSI mode nothing is clamped."""
    if ks_nodes is None:
        return solve_mod.dof_free_mask(coarse.fixed_mask) \
            .astype(solve_dtype).reshape(coarse.n_nodes, 6)
    return jnp.ones((coarse.n_nodes, 6)).astype(solve_dtype)


def _phase_scan_condensed_impl(coarse, refined, wave, case, n_seg, n_steps,
                               n_gauss, accel, kinematics, chain_solver,
                               solve_dtype, refine_steps, stretching,
                               current_alpha, ks_nodes, free, fixed):
    chain_solver = _resolve_chain_solver(n_seg, chain_solver)
    G = case.E / (2.0 * (1.0 + case.nu))

    # ---- element stiffness + chain factorization (solve precision) ----
    # Everything in this block depends only on (model, E, nu) — NOT on the
    # wave/case/phase count.  prepare_condensed() computes exactly this
    # block once and phase_scan_prepared() skips it; the one-shot scan
    # pays it per call.
    coords64 = refined.coords.astype(solve_dtype)
    Kg, K_local, T, L_m = element_stiffness(
        coords64, refined.conn, jax.tree.map(lambda x: x.astype(solve_dtype),
                                             refined.sections),
        refined.sect_id, case.E, G, release=refined.release)
    fac = _chain_fns(chain_solver)[0](Kg, n_seg)

    # interface stiffness on the coarse connectivity
    K_I = assemble_dense(fac.K_super, coarse.conn, 6 * coarse.n_nodes)
    dfac = _spring_dfac(K_I, ks_nodes, free)
    KT6 = -matmul12(K_local, T)[:, :6, :]                  # [Mr, 6, 12]

    return _condensed_scan_body(coarse, refined, wave, case, n_seg, n_steps,
                                n_gauss, accel, kinematics, chain_solver,
                                solve_dtype, refine_steps, stretching,
                                current_alpha, ks_nodes, fixed,
                                Kg, KT6, L_m, fac, dfac, K_I)


def _condensed_scan_body(coarse, refined, wave, case, n_seg, n_steps,
                         n_gauss, accel, kinematics, chain_solver,
                         solve_dtype, refine_steps, stretching,
                         current_alpha, ks_nodes, fixed,
                         Kg, KT6, L_m, fac, dfac, K_I):
    """Per-scan (wave/case-dependent) work of the condensed phase scan,
    given the case-independent factorization pieces."""
    nc = coarse.n_nodes
    Mc = coarse.n_members
    n_int = n_seg - 1

    # ---- loads at all phases (model dtype), then condense ----
    with jax.named_scope("loads"):
        ldtype = refined.coords.dtype
        ts = jnp.arange(n_steps, dtype=ldtype) \
            * wave.T.astype(ldtype) / n_steps

        case_l = case.cast(ldtype)
        conn_h, D_m, Cd_h, Cm_h = hydro_members(
            refined, case_l.marine_growth_mm, case_l.Cd, case_l.Cm)
        if kinematics == "separable":
            if case_l.slam_cs:
                raise ValueError(
                    "slamming (slam_cs > 0) runs on the pointwise kinematics "
                    "paths only — the crossing-band impact term does not "
                    "separate over the phase matmul. Use "
                    "kinematics='pointwise'.")
            mb = morison_phase_batch(wave, refined.coords, conn_h, D_m,
                                     case_l.wave_dir_deg,
                                     case_l.current_dir_deg,
                                     Cd_h, Cm_h, case_l.rho_water,
                                     ts, n_gauss=n_gauss,
                                     current_alpha=current_alpha,
                                     stretching=stretching)
            total_morison = mb.total_morison
        elif kinematics == "pointwise":
            def loads_at(t):
                mor = morison_loads(wave, refined.coords, conn_h, D_m,
                                    case_l.wave_dir_deg,
                                    case_l.current_dir_deg,
                                    Cd_h, Cm_h, case_l.rho_water, t,
                                    n_gauss=n_gauss, accel=accel,
                                    stretching=stretching,
                                    current_alpha=current_alpha,
                                    slam_cs=case_l.slam_cs)
                F = assemble_loads(refined, case_l, mor.nodal_forces,
                                   L_m.astype(ldtype))
                return F, mor.total_morison

            F_all, total_morison = jax.vmap(loads_at)(ts)  # [S, n_dof_ref]
        else:
            raise ValueError(f"unknown kinematics mode {kinematics!r}")
        if kinematics == "separable":
            # loads built directly in the chain layout — the [S, n_dof]
            # global load vector never materializes on the fast path
            F_I_nodes, g = _chain_layout_loads(coarse, refined, case_l,
                                               mb.F1, mb.F2,
                                               L_m.astype(ldtype), n_seg)
            F_I_nodes = F_I_nodes.astype(solve_dtype)
            g = g.astype(solve_dtype)
        else:
            F_all = F_all.astype(solve_dtype)
            Fn = F_all.reshape(n_steps, -1, 6)
            F_I_nodes = Fn[:, :nc]                             # [S, nc, 6]
            g = Fn[:, nc:].reshape(n_steps, Mc, n_int, 6).swapaxes(1, 2)
    return _condensed_tail(coarse, refined, case, n_seg, ts, chain_solver,
                           solve_dtype, refine_steps, ks_nodes, fixed,
                           Kg, KT6, fac, dfac, K_I, F_I_nodes, g,
                           total_morison)


def _condensed_rows(coarse, n_seg, chain_solver, solve_dtype, refine_steps,
                    ks_nodes, Kg, KT6, fac, dfac, K_I, F_I_nodes, g):
    """Condensed multi-RHS solve + LINEAR recovery from chain-layout load
    rows: full displacement vectors, member node-1 end forces and the
    interface reaction rows.  The rows are time samples for the scans and
    per-mode coefficient columns for the frequency-domain path — the
    algebra is identical."""
    n_steps = F_I_nodes.shape[0]
    node1 = coarse.conn[:, 0]
    node2 = coarse.conn[:, 1]
    _condense, _backsub = _chain_fns(chain_solver)[1:]
    solve_once = partial(_condensed_solve, fac=fac, dfac=dfac,
                         _condense=_condense, _backsub=_backsub,
                         node1=node1, node2=node2)
    U_In, v, F_cond_flat, U_I = solve_once(F_I_nodes, g)

    # ---- iterative refinement (restores ~4e-5 rel accuracy in float32;
    # fixed DOFs carry the reaction, so the residual is masked to free
    # equations before re-entering the factorization) ----
    if refine_steps > 0:
        free_I = _refine_mask(coarse, ks_nodes, solve_dtype)
        U_In, v, U_I = _refine_condensed(Kg, n_seg, coarse.conn, free_I,
                                         solve_once, F_I_nodes, g,
                                         U_In, v, U_I, refine_steps,
                                         ks_nodes=ks_nodes)

    U = jnp.concatenate([
        U_In.reshape(n_steps, -1),
        v.swapaxes(1, 2).reshape(n_steps, -1),
    ], axis=1)                                             # [S, n_dof_ref]

    # ---- recovery on every refined element ----
    # von Mises needs only the node-1 end forces F1 = -(K_local T u)[:6]
    # (`JacketAnalysisGUI_v2.py:514-519`); KT6 = -(K_local @ T)[:6] was
    # folded once at factor time, and the element displacement vectors are
    # read straight from the chain layout (no [S, n_dof] gather)
    vext = jnp.concatenate([U_In[:, node1][:, None], v,
                            U_In[:, node2][:, None]], axis=1)
    u_e = jnp.concatenate([vext[:, :-1], vext[:, 1:]], axis=-1)
    u_elem = u_e.swapaxes(1, 2).reshape(n_steps, -1, 12)   # member-major
    F1 = matvec12(KT6, u_elem)                             # [S, Mr, 6]

    # ---- reactions from the condensed interface system (exact) ----
    R = U_I @ K_I.T - F_cond_flat                          # [S, 6 nc]
    return U, F1, R


def _condensed_tail(coarse, refined, case, n_seg, ts, chain_solver,
                    solve_dtype, refine_steps, ks_nodes, fixed,
                    Kg, KT6, fac, dfac, K_I, F_I_nodes, g, total_morison):
    """Condensed solve + recovery from chain-layout loads — shared by the
    steady-wave phase scans and the irregular-sea time scans."""
    n_steps = ts.shape[0]
    with jax.named_scope("solve"):
        U, F1, R = _condensed_rows(coarse, n_seg, chain_solver, solve_dtype,
                                   refine_steps, ks_nodes, Kg, KT6, fac,
                                   dfac, K_I, F_I_nodes, g)
    with jax.named_scope("stress"):
        vm = von_mises_8pt(jax.tree.map(lambda x: x.astype(solve_dtype),
                                        refined.sections), refined.sect_id,
                           F1[..., 0], F1[..., 1], F1[..., 2],
                           F1[..., 3], F1[..., 4], F1[..., 5])
    util = vm / case.fy
    reac = R[:, fixed].reshape(n_steps, -1, 6)

    crit = jnp.argmax(jnp.max(util, axis=1))
    return CondensedScanResults(
        ts=ts, U=U, von_mises=vm, utilization=util, reactions=reac,
        total_morison=total_morison, critical_index=crit,
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CondensedPrepared:
    """Case-independent factorization handle for repeated condensed scans.

    Produced by :func:`prepare_condensed`; consumed by
    :func:`phase_scan_prepared`.  Holds everything in the condensed
    pipeline that depends only on (model, E, nu): the refined element
    stiffness, the chain factorization, the grounded interface Cholesky and
    the folded stress-recovery operator.  A pytree (all arrays live on
    device), so passing it to a jitted scan costs nothing.
    """

    coarse: JacketModel
    refined: JacketModel
    Kg: jnp.ndarray          # [Mr, 12, 12] element stiffness (solve dtype)
    KT: jnp.ndarray          # [Mr, 12, 12] K_local @ T recovery fold
    #   (scans use -KT[:, :6] for node-1 forces; analyze_prepared recovers
    #    both member end-force sets from it)
    L_m: jnp.ndarray         # [Mr] refined element lengths [m]
    fac: object              # ChainFactor / NestedFactor pytree
    dfac: object             # DenseFactor of the grounded interface system
    K_I: jnp.ndarray         # [6 nc, 6 nc] springless interface stiffness
    ks_nodes: object         # [nc, 6] foundation-spring diagonal or None
    free: jnp.ndarray
    fixed: jnp.ndarray
    E: jnp.ndarray
    nu: jnp.ndarray
    # static:
    n_seg: int = dataclasses.field(metadata=dict(static=True))
    chain_solver: str = dataclasses.field(metadata=dict(static=True))


def prepare_condensed(coarse: JacketModel, refined: JacketModel, n_seg: int,
                      E=210000.0, nu=0.3, chain_solver: str = "auto",
                      solve_dtype=jnp.float64,
                      support_stiffness=None) -> CondensedPrepared:
    """Factor the case-independent part of the condensed scan ONCE.

    The chain factorization + interface Cholesky + element stiffness inside
    :func:`phase_scan_condensed` depend only on (model, E, nu), not on the
    wave, the load case or the phase count — yet the one-shot scan recomputes
    them every call.  This split pays that cost once, so repeated
    single-case scans through :func:`phase_scan_prepared` do only the
    per-case work.  The reference
    re-runs its entire solver from scratch on every analysis
    (`/root/reference/JacketAnalysisGUI_v2.py:485`).

    ``support_stiffness`` bakes foundation springs (SSI) into the interface
    factorization, as in :func:`phase_scan_condensed`.
    """
    _check_refined_layout(coarse, refined, n_seg)
    ks_nodes, free_np, fixed_np = _ssi_spring_nodes(coarse,
                                                    support_stiffness,
                                                    solve_dtype)
    resolved = _resolve_chain_solver(n_seg, chain_solver)
    free = jnp.asarray(free_np)
    fixed = jnp.asarray(fixed_np)
    E = jnp.asarray(E, dtype=solve_dtype)
    nu = jnp.asarray(nu, dtype=solve_dtype)
    Kg, KT, L_m, fac, dfac, K_I = _prepare_condensed_jit(
        coarse, refined, E, nu, n_seg, resolved, solve_dtype, ks_nodes, free)
    return CondensedPrepared(
        coarse=coarse, refined=refined, Kg=Kg, KT=KT, L_m=L_m, fac=fac,
        dfac=dfac, K_I=K_I, ks_nodes=ks_nodes, free=free, fixed=fixed,
        E=E, nu=nu, n_seg=n_seg, chain_solver=resolved)


@partial(jax.jit, static_argnames=("n_seg", "chain_solver", "solve_dtype"))
def _prepare_condensed_jit(coarse, refined, E, nu, n_seg, chain_solver,
                           solve_dtype, ks_nodes, free):
    with jax.default_matmul_precision("highest"):
        G = E / (2.0 * (1.0 + nu))
        coords_s = refined.coords.astype(solve_dtype)
        sec_s = jax.tree.map(lambda x: x.astype(solve_dtype),
                             refined.sections)
        Kg, K_local, T, L_m = element_stiffness(
            coords_s, refined.conn, sec_s, refined.sect_id, E, G,
            release=refined.release)
        fac = _chain_fns(chain_solver)[0](Kg, n_seg)
        K_I = assemble_dense(fac.K_super, coarse.conn, 6 * coarse.n_nodes)
        dfac = _spring_dfac(K_I, ks_nodes, free)
        KT = matmul12(K_local, T)
        return Kg, KT, L_m, fac, dfac, K_I


def phase_scan_prepared(prep: CondensedPrepared, wave, case: LoadCase,
                        n_steps: int = 360, n_gauss: int = 15,
                        accel: str = "analytic",
                        kinematics: str = "separable",
                        refine_steps: int = 1,
                        stretching: str = "none",
                        current_alpha=None) -> CondensedScanResults:
    """Condensed phase scan using a :func:`prepare_condensed` handle.

    Identical results to :func:`phase_scan_condensed` (a test pins them to
    solver precision), but the per-call work is only the wave/case-dependent
    part: kinematics matmul, load condensation, multi-RHS triangular solves
    and recovery — the factorization is read from ``prep``.

    The case's material must match the prepared factorization: ``case.E``
    and ``case.nu`` are checked against the handle (raises on mismatch).
    """
    solve_dtype = prep.K_I.dtype
    for name in ("E", "nu"):
        # compare in the handle's dtype (a f64 case value of 0.3 against an
        # f32 handle must not trip on representation rounding)
        if not np.allclose(
                np.asarray(getattr(case, name)).astype(np.asarray(
                    getattr(prep, name)).dtype),
                np.asarray(getattr(prep, name)), rtol=1e-6):
            raise ValueError(
                f"case.{name} ({np.asarray(getattr(case, name))!r}) does not "
                f"match the prepared factorization's {name} "
                f"({np.asarray(getattr(prep, name))!r}); re-run "
                f"prepare_condensed for a new material")
    return _phase_scan_prepared_jit(prep, wave, case.cast(solve_dtype),
                                    n_steps, n_gauss, accel, kinematics,
                                    refine_steps, stretching, current_alpha)


@partial(jax.jit, static_argnames=("n_steps", "n_gauss", "accel",
                                   "kinematics", "refine_steps",
                                   "stretching", "current_alpha"))
def _phase_scan_prepared_jit(prep, wave, case, n_steps, n_gauss, accel,
                             kinematics, refine_steps, stretching,
                             current_alpha):
    with jax.default_matmul_precision("highest"):
        return _condensed_scan_body(
            prep.coarse, prep.refined, wave, case, prep.n_seg, n_steps,
            n_gauss, accel, kinematics, prep.chain_solver, prep.K_I.dtype,
            refine_steps, stretching, current_alpha, prep.ks_nodes,
            prep.fixed, prep.Kg, -prep.KT[:, :6, :], prep.L_m, prep.fac,
            prep.dfac, prep.K_I)


def analyze_prepared(prep: CondensedPrepared, wave, case: LoadCase,
                     n_gauss: int = 15, accel: str = "analytic",
                     refine_steps: int = 1) -> AnalysisResults:
    """Single-phase condensed analysis through a prepared handle.

    Same results as :func:`analyze_condensed` (the ~100k-DOF end-to-end
    path) but the case-independent factorization is read from ``prep`` —
    repeated large-mesh analyses across waves/cases pay only loads +
    condense + one interface solve + recovery per call.  The reference
    re-runs its entire solver every analysis
    (`/root/reference/JacketAnalysisGUI_v2.py:485`).
    """
    solve_dtype = prep.K_I.dtype
    for name in ("E", "nu"):
        if not np.allclose(
                np.asarray(getattr(case, name)).astype(np.asarray(
                    getattr(prep, name)).dtype),
                np.asarray(getattr(prep, name)), rtol=1e-6):
            raise ValueError(
                f"case.{name} does not match the prepared factorization; "
                f"re-run prepare_condensed for a new material")
    return _analyze_prepared_jit(prep, wave, case.cast(solve_dtype),
                                 n_gauss, accel, refine_steps)


@partial(jax.jit, static_argnames=("n_gauss", "accel", "refine_steps"))
def _analyze_prepared_jit(prep, wave, case, n_gauss, accel, refine_steps):
    with jax.default_matmul_precision("highest"):
        coarse, refined = prep.coarse, prep.refined
        n_seg = prep.n_seg
        solve_dtype = prep.K_I.dtype
        nc = coarse.n_nodes
        Mc = coarse.n_members
        n_int = n_seg - 1

        ldtype = refined.coords.dtype
        case_l = case.cast(ldtype)
        conn_h, D_m, Cd_h, Cm_h = hydro_members(
            refined, case_l.marine_growth_mm, case_l.Cd, case_l.Cm)
        mor = morison_loads(wave, refined.coords, conn_h, D_m,
                            case_l.wave_dir_deg, case_l.current_dir_deg,
                            Cd_h, Cm_h, case_l.rho_water,
                            case_l.t_analysis, n_gauss=n_gauss, accel=accel,
                            slam_cs=case_l.slam_cs)
        F = assemble_loads(refined, case_l, mor.nodal_forces,
                           prep.L_m.astype(ldtype))
        F = F.astype(solve_dtype)

        node1 = coarse.conn[:, 0]
        node2 = coarse.conn[:, 1]
        Fn = F.reshape(1, -1, 6)
        F_I_nodes = Fn[:, :nc]
        g = Fn[:, nc:].reshape(1, Mc, n_int, 6).swapaxes(1, 2)
        _condense, _backsub = _chain_fns(prep.chain_solver)[1:]
        solve_once = partial(_condensed_solve, fac=prep.fac, dfac=prep.dfac,
                             _condense=_condense, _backsub=_backsub,
                             node1=node1, node2=node2)
        U_In, v, F_cond_flat, U_I = solve_once(F_I_nodes, g)
        if refine_steps > 0:
            free_I = _refine_mask(coarse, prep.ks_nodes, solve_dtype)
            U_In, v, U_I = _refine_condensed(prep.Kg, n_seg, coarse.conn,
                                             free_I, solve_once, F_I_nodes,
                                             g, U_In, v, U_I, refine_steps,
                                             ks_nodes=prep.ks_nodes)
        U = jnp.concatenate([U_In.reshape(1, -1),
                             v.swapaxes(1, 2).reshape(1, -1)], axis=1)[0]

        # recovery via the prepared K_local@T fold (reference sign
        # convention: F1 = -(K_local T u)[:6], F2 = +[6:])
        dofs = jnp.concatenate([6 * refined.conn[:, 0:1] + jnp.arange(6),
                                6 * refined.conn[:, 1:2] + jnp.arange(6)],
                               axis=-1)
        F_loc = matvec12(prep.KT, U[dofs])
        F1, F2 = -F_loc[:, :6], F_loc[:, 6:]
        sec_s = jax.tree.map(lambda x: x.astype(solve_dtype),
                             refined.sections)
        vm = von_mises_8pt(sec_s, refined.sect_id,
                           F1[:, 0], F1[:, 1], F1[:, 2],
                           F1[:, 3], F1[:, 4], F1[:, 5])
        util = vm / case.fy
        R = U_I @ prep.K_I.T - F_cond_flat
        reac = R[0, prep.fixed].reshape(-1, 6)
        disp = jnp.linalg.norm(U.reshape(-1, 6)[:, :3], axis=-1)
        imax = jnp.argmax(disp)
        return AnalysisResults(
            U=U, reactions=reac, F_applied=F,
            F1_local=F1, F2_local=F2,
            von_mises=vm, utilization=util, length_m=prep.L_m,
            morison=mor,
            max_displacement_mm=disp[imax], max_displacement_node=imax,
            total_reaction=jnp.sum(reac, axis=0),
        )


def sea_scan_prepared(prep: CondensedPrepared, sea, case: LoadCase,
                      ts, n_gauss: int = 15, refine_steps: int = 1,
                      stretching: str = "none",
                      current_alpha=None) -> CondensedScanResults:
    """Irregular-sea time-history response on a prepared condensed model.

    Solves the FULL refined FEM problem at every sample time of a random-sea
    realization (:func:`.ops.spectrum.make_random_sea`): the kinematics of
    all N spectral components at all S times are one separable matmul
    (:func:`.ops.spectrum.morison_sea_batch`), the loads condense onto the
    interface system factored once in ``prep``, and all S quasi-static
    solves are one multi-RHS triangular solve.  A 2048-step half-hour
    realization at the flagship 9.6k-DOF shape is ONE device program —
    irregular seas are entirely outside the reference's scope (its Info tab
    limits the tool to one regular design wave,
    `/root/reference/JacketAnalysisGUI_v2.py:1888`).

    ``ts``: [S] sample times (uniform spacing recommended — the spectral
    fatigue screen assumes it).  ``stretching='wheeler'`` is the standard
    crest-kinematics treatment for linear irregular seas (API RP 2A).
    Feed the returned von Mises history to
    :func:`.ops.spectrum.spectral_fatigue_screen`.
    """
    _check_no_slam(case, "sea_scan_prepared")
    solve_dtype = prep.K_I.dtype
    ldtype = prep.refined.coords.dtype
    return _sea_scan_prepared_jit(prep, sea, case.cast(solve_dtype),
                                  jnp.asarray(ts, dtype=ldtype), n_gauss,
                                  refine_steps, stretching, current_alpha)


@partial(jax.jit, static_argnames=("n_gauss", "refine_steps", "stretching",
                                   "current_alpha"))
def _sea_scan_prepared_jit(prep, sea, case, ts, n_gauss, refine_steps,
                           stretching, current_alpha):
    from .ops.spectrum import morison_sea_batch

    with jax.default_matmul_precision("highest"):
        coarse, refined = prep.coarse, prep.refined
        solve_dtype = prep.K_I.dtype
        ldtype = refined.coords.dtype
        case_l = case.cast(ldtype)
        conn_h, D_m, Cd_h, Cm_h = hydro_members(
            refined, case_l.marine_growth_mm, case_l.Cd, case_l.Cm)
        mb = morison_sea_batch(sea, refined.coords, conn_h, D_m,
                               case_l.wave_dir_deg, case_l.current_dir_deg,
                               Cd_h, Cm_h, case_l.rho_water, ts,
                               n_gauss=n_gauss, current_alpha=current_alpha,
                               stretching=stretching)
        F_I_nodes, g = _chain_layout_loads(coarse, refined, case_l,
                                           mb.F1, mb.F2,
                                           prep.L_m.astype(ldtype),
                                           prep.n_seg)
        return _condensed_tail(coarse, refined, case, prep.n_seg, ts,
                               prep.chain_solver, solve_dtype, refine_steps,
                               prep.ks_nodes, prep.fixed, prep.Kg,
                               -prep.KT[:, :6, :], prep.fac, prep.dfac,
                               prep.K_I, F_I_nodes.astype(solve_dtype),
                               g.astype(solve_dtype), mb.total_morison)


def spectral_response_prepared(prep: CondensedPrepared, sea, case: LoadCase,
                               T_storm_s: float = 3.0 * 3600.0,
                               exposure_years: float = 1.0,
                               curve: str = "D-sea-cp", scf=1.0,
                               occurrence: float = 1.0, n_gauss: int = 15,
                               refine_steps: int = 1, current_alpha=None):
    """FREQUENCY-DOMAIN stochastic response of one sea state — closed-form
    statistics instead of a time march.

    Borgman-linearized Morison drag (see :mod:`.ops.freqdomain`) makes each
    of the sea's N spectral components excite the structure LINEARLY, so
    2N+1 condensed multi-RHS solves (mean + cos/sin per component — the
    same device program as a (2N+1)-step :func:`phase_scan_prepared`)
    characterize the full response process: per-member stress std devs and
    spectral moments, mean-upcrossing rates, narrow-band + Wirsching-Light
    fatigue damage, and most-probable-maximum storm extremes
    (:class:`.ops.freqdomain.FreqDomainResponse`).

    Complements :func:`sea_scan_prepared` (time domain): the frequency
    domain is exact in the inertia-dominated limit and ~100x cheaper per
    sea state (no realization length to converge), the time domain carries
    the full drag nonlinearity and intermittent wetting.  Agreement between
    the two is itself a model check (``tests/test_freqdomain.py``).

    ``T_storm_s``: storm duration for the MPM extremes (default 3 h).
    ``exposure_years`` x ``occurrence``: fatigue exposure, as in
    :func:`.ops.spectrum.spectral_fatigue_screen`.  ``scf``: scalar or
    per-refined-member [Mr] stress concentration factors.

    Wind, topside loads, self-weight and buoyancy are STATIC and enter the
    mean row only; the component rows carry pure wave loading.
    """
    from .ops.freqdomain import spectral_stats

    tr = spectral_transfer_prepared(prep, sea, case, n_gauss=n_gauss,
                                    refine_steps=refine_steps,
                                    current_alpha=current_alpha)
    solve_dtype = prep.K_I.dtype
    return spectral_stats(
        tr.omega, tr.stress_mean, tr.stress_cos, tr.stress_sin,
        tr.U_mean, tr.U_cos, tr.U_sin, tr.totals,
        jnp.asarray(case.fy, solve_dtype),
        jnp.asarray(T_storm_s, solve_dtype),
        jnp.asarray(exposure_years, solve_dtype), curve=curve,
        scf=jnp.asarray(scf, solve_dtype),
        occurrence=jnp.asarray(occurrence, solve_dtype),
        sigma_v_max=tr.sigma_v_max, c_lin_mean=tr.c_lin_mean,
        totals_moment=tr.totals_moment)


class FreqTransfer(NamedTuple):
    """Per-spectral-component transfer rows of a prepared condensed model.

    The raw output of the 2N+1 linearized solves: the response to
    component i is ``X_cos[i] cos(w_i t) + X_sin[i] sin(w_i t)`` about
    ``X_mean`` (which carries all static loading).  Feed to
    :func:`.ops.freqdomain.spectral_stats` (what
    :func:`spectral_response_prepared` does) or post-process directly —
    e.g. response spectra S_r(w_i) = (X_cos^2 + X_sin^2) / (2 dw).
    """

    omega: jnp.ndarray        # [N] component frequencies (rad/s)
    U_mean: jnp.ndarray       # [n_dof] chain-layout displacements (mm)
    U_cos: jnp.ndarray        # [N, n_dof]
    U_sin: jnp.ndarray        # [N, n_dof]
    stress_mean: jnp.ndarray  # [Mr, 8] normal stress at the 8 points (MPa)
    stress_cos: jnp.ndarray   # [N, Mr, 8]
    stress_sin: jnp.ndarray   # [N, Mr, 8]
    totals: jnp.ndarray       # [2N+1, 3] global hydro force rows (N)
    sigma_v_max: jnp.ndarray  # linearization diagnostics
    c_lin_mean: jnp.ndarray
    totals_moment: jnp.ndarray  # [2N+1, 3] global moment rows about the
    #   mudline origin (N m): x/y = overturning, z = torsion


def spectral_transfer_prepared(prep: CondensedPrepared, sea,
                               case: LoadCase, n_gauss: int = 15,
                               refine_steps: int = 1,
                               current_alpha=None) -> FreqTransfer:
    """The 2N+1 Borgman-linearized transfer solves (see
    :func:`spectral_response_prepared`), returning the raw per-component
    response rows for custom post-processing."""
    _check_no_slam(case, "spectral_transfer_prepared")
    solve_dtype = prep.K_I.dtype
    return _spectral_transfer_jit(prep, sea, case.cast(solve_dtype),
                                  n_gauss, refine_steps, current_alpha)


@partial(jax.jit, static_argnames=("n_gauss", "refine_steps",
                                   "current_alpha"))
def _spectral_transfer_jit(prep, sea, case, n_gauss, refine_steps,
                           current_alpha):
    from .ops.freqdomain import linearized_sea_loads
    from .ops.sections import normal_stress_8pt

    with jax.default_matmul_precision("highest"):
        coarse, refined = prep.coarse, prep.refined
        solve_dtype = prep.K_I.dtype
        ldtype = refined.coords.dtype
        case_l = case.cast(ldtype)
        conn_h, D_m, Cd_h, Cm_h = hydro_members(
            refined, case_l.marine_growth_mm, case_l.Cd, case_l.Cm)
        lin = linearized_sea_loads(sea, refined.coords, conn_h, D_m,
                                   case_l.wave_dir_deg,
                                   case_l.current_dir_deg, Cd_h, Cm_h,
                                   case_l.rho_water, n_gauss=n_gauss,
                                   current_alpha=current_alpha)
        L_m = prep.L_m.astype(ldtype)
        # mean row: full case (statics + wind + linearized current drag)
        F_I_m, g_m = _chain_layout_loads(coarse, refined, case_l,
                                         lin.F1[:1], lin.F2[:1],
                                         L_m, prep.n_seg)
        # component rows: pure wave loading (statics stripped)
        zero = jnp.zeros_like(case_l.F_axial_kN)
        case_dyn = dataclasses.replace(
            case_l, F_axial_kN=zero, F_shear_kN=zero, M_moment_kNm=zero,
            M_torsion_kNm=zero, custom_sw_tonnes=zero, sw_mode="none",
            buoyancy="none", wind_speed_ms=0.0)
        F_I_d, g_d = _chain_layout_loads(coarse, refined, case_dyn,
                                         lin.F1[1:], lin.F2[1:],
                                         L_m, prep.n_seg)
        F_I = jnp.concatenate([F_I_m, F_I_d]).astype(solve_dtype)
        g = jnp.concatenate([g_m, g_d]).astype(solve_dtype)

        U, F1e, _ = _condensed_rows(coarse, prep.n_seg, prep.chain_solver,
                                    solve_dtype, refine_steps,
                                    prep.ks_nodes, prep.Kg,
                                    -prep.KT[:, :6, :], prep.fac,
                                    prep.dfac, prep.K_I, F_I, g)

        sec64 = jax.tree.map(lambda x: x.astype(solve_dtype),
                             refined.sections)
        s8 = normal_stress_8pt(sec64, refined.sect_id,
                               F1e[..., 0], F1e[..., 4], F1e[..., 5])
        N = sea.omega.shape[0]
        return FreqTransfer(
            omega=sea.omega.astype(solve_dtype), U_mean=U[0],
            U_cos=U[1:1 + N], U_sin=U[1 + N:], stress_mean=s8[0],
            stress_cos=s8[1:1 + N], stress_sin=s8[1 + N:],
            totals=lin.totals.astype(solve_dtype),
            sigma_v_max=lin.sigma_v_max, c_lin_mean=lin.c_lin_mean,
            totals_moment=lin.totals_moment.astype(solve_dtype))


def spectral_response_dynamic(coarse, refined, n_seg: int, sea,
                              case: LoadCase,
                              damping_ratio: float = 0.02,
                              damping: str = "modal",
                              T_storm_s: float = 3.0 * 3600.0,
                              exposure_years: float = 1.0,
                              curve: str = "D-sea-cp", scf=1.0,
                              occurrence: float = 1.0,
                              n_chain_modes: int = 12,
                              topside_mass_t: float | None = None,
                              support_stiffness=None,
                              added_mass_Ca=None,
                              n_gauss: int = 15, current_alpha=None,
                              prep: "CondensedPrepared | None" = None,
                              hydro_damping: bool = False):
    """DYNAMIC frequency-domain stochastic response: the quasi-static
    transfer of :func:`spectral_response_prepared` upgraded with inertia
    and damping on the Craig-Bampton reduced basis.

    Each spectral component's transfer solve becomes the steady-state
    harmonic response at its own frequency, so resonance-band sea energy is
    amplified by the true dynamic transfer — THE effect that drives fatigue
    of dynamically sensitive jackets (natural periods inside the wave
    band) and that a quasi-static analysis misses entirely.  Statistics
    layer, fatigue closed forms and MPM extremes are identical
    (:func:`.ops.freqdomain.spectral_stats`).

    See :func:`spectral_transfer_dynamic` for the mechanics and the
    damping models.
    """
    from .ops.freqdomain import spectral_stats

    tr = spectral_transfer_dynamic(
        coarse, refined, n_seg, sea, case, damping_ratio=damping_ratio,
        damping=damping, n_chain_modes=n_chain_modes,
        topside_mass_t=topside_mass_t, support_stiffness=support_stiffness,
        added_mass_Ca=added_mass_Ca, n_gauss=n_gauss,
        current_alpha=current_alpha, prep=prep,
        hydro_damping=hydro_damping)
    solve_dtype = tr.U_mean.dtype
    return spectral_stats(
        tr.omega, tr.stress_mean, tr.stress_cos, tr.stress_sin,
        tr.U_mean, tr.U_cos, tr.U_sin, tr.totals,
        jnp.asarray(case.fy, solve_dtype),
        jnp.asarray(T_storm_s, solve_dtype),
        jnp.asarray(exposure_years, solve_dtype), curve=curve,
        scf=jnp.asarray(scf, solve_dtype),
        occurrence=jnp.asarray(occurrence, solve_dtype),
        sigma_v_max=tr.sigma_v_max, c_lin_mean=tr.c_lin_mean,
        totals_moment=tr.totals_moment)


def spectral_transfer_dynamic(coarse, refined, n_seg: int, sea,
                              case: LoadCase,
                              damping_ratio: float = 0.02,
                              damping: str = "modal",
                              n_chain_modes: int = 12,
                              topside_mass_t: float | None = None,
                              support_stiffness=None,
                              added_mass_Ca=None,
                              n_gauss: int = 15,
                              current_alpha=None,
                              prep: "CondensedPrepared | None" = None,
                              hydro_damping: bool = False) -> FreqTransfer:
    """Per-component DYNAMIC transfer rows, mode-acceleration formulation.

    Mechanics (all REAL arithmetic — written for an accelerator without
    complex solves; kept until measured on the GPU):

    1. The EXACT quasi-static transfer rows from the full condensed
       system (:func:`spectral_transfer_prepared`; ``prep`` is built
       internally when not supplied).
    2. Borgman-linearized per-mode load rows on the full refined mesh
       (:func:`.ops.freqdomain.linearized_sea_loads`), projected to the
       Craig-Bampton reduced space with the work-conjugate transformation —
       the same projection as
       :func:`.ops.dynamics.transient_response_condensed` — and ONE full
       eigendecomposition of the reduced (K, M) (a few hundred DOFs
       regardless of refinement).
    3. Closed-form modal amplification per (mode j, component i):
       with d = w_j^2 - w_i^2, c = c_j w_i, det = d^2 + c^2:
       q_cos = (d f_cos - c f_sin)/det, q_sin = (c f_cos + d f_sin)/det.
       At w_i = w_j this is the textbook 1/(2 zeta) resonance peak.
    4. MODE ACCELERATION: the dynamic rows are the exact static rows plus
       the expanded modal CORRECTION q(w) - q(0).  CB truncation therefore
       only touches the resonant correction, never the static content —
       with pure mode displacement, 12 retained chain modes carry up to
       ~2% mid-chain stress-sigma error under distributed wave loading at
       n_seg=8 (measured on the default jacket; 42 modes = exact); with
       the split that error is identically zero off resonance.
    5. Stress recovery exactly as the quasi-static path.

    ``damping``: 'modal' (default) applies the SAME ratio to every reduced
    mode (c_j = 2 zeta w_j — the standard choice for spectral fatigue;
    Rayleigh would overdamp the high modes); 'rayleigh' matches
    :func:`.ops.dynamics.dynamic_response_condensed` (c_j = alpha +
    beta w_j^2 anchored at the first two distinct frequencies) for
    cross-validation.

    The w -> 0 limit recovers :func:`spectral_transfer_prepared` exactly
    (for ANY retained-mode count — the correction vanishes identically);
    ``tests/test_freqdomain.py`` pins that limit, the regular-wave
    cross-check against the complex harmonic solver, and the truncation
    robustness off resonance.
    """
    _check_no_slam(case, "spectral_transfer_dynamic")
    if damping not in ("modal", "rayleigh"):
        raise ValueError("damping must be 'modal' or 'rayleigh', got "
                         f"{damping!r}")
    if not 0.0 < float(damping_ratio) < 1.0:
        raise ValueError("damping_ratio must be in (0, 1), got "
                         f"{damping_ratio}")
    case = case.cast(refined.coords.dtype)
    if topside_mass_t is None:
        topside_mass_t = float(case.custom_sw_tonnes)
    if prep is None:
        prep = prepare_condensed(coarse, refined, n_seg, E=float(case.E),
                                 nu=float(case.nu),
                                 support_stiffness=support_stiffness)
    cb = _cached_cb_reduce(coarse, refined, n_seg, float(case.E),
                           float(case.nu), topside_mass_t, n_chain_modes,
                           support_stiffness, added_mass_Ca,
                           float(case.rho_water))
    w2n, phi, c_j = _cb_modal_basis(cb, damping, float(damping_ratio))
    return _dynamic_transfer_jit(prep, cb, w2n, phi, c_j, sea, case,
                                 n_gauss, current_alpha,
                                 hydro_damping=hydro_damping)


_MODAL_CACHE: dict = {}


def _cb_modal_basis(cb, damping: str, damping_ratio: float,
                    n_modes_device: int = 64):
    """Mass-normalized modal basis of the reduced (K, M) + per-mode
    damping coefficients — sea-state independent, memoized on the (cached)
    reduction's identity.

    By default the FULL basis via eigh (LAPACK on the CPU, cuSOLVER on the
    GPU).  With the 'subspace' eigen backend: the lowest ``n_modes_device``
    modes via subspace iteration (ops/eigen.py) — safe to truncate here
    because the transfer uses the MODE-ACCELERATION form (the quasi-static
    part is exact for every mode; the basis only carries the resonant
    correction, which decays as (w / w_n)^2 for the omitted high modes)."""
    from .ops.dynamics import _eigh_backend

    key = (id(cb), damping, damping_ratio)
    hit = _MODAL_CACHE.get(key)
    if hit is not None:
        return hit[1:]
    dtype = cb.K_red.dtype
    with jax.default_matmul_precision("highest"):
        K_ff = cb.K_red[jnp.ix_(cb.free, cb.free)]
        M_ff = cb.M_red[jnp.ix_(cb.free, cb.free)]
        if _eigh_backend() == "subspace":
            from .ops.eigen import subspace_eigh
            m = min(n_modes_device, K_ff.shape[0])
            w2n, phi = subspace_eigh(K_ff, M_ff, m, n_iter=16)
            w2n = jnp.clip(w2n, 0.0)
            wn = jnp.sqrt(w2n)
        else:
            Lm = jnp.linalg.cholesky(M_ff)
            Y = jax.scipy.linalg.solve_triangular(Lm, K_ff, lower=True)
            Am = jax.scipy.linalg.solve_triangular(Lm, Y.T, lower=True)
            Am = 0.5 * (Am + Am.T)
            w2n, V = jnp.linalg.eigh(Am)
            w2n = jnp.clip(w2n, 0.0)
            wn = jnp.sqrt(w2n)
            phi = jax.scipy.linalg.solve_triangular(Lm.T, V, lower=False)
    if damping == "modal":
        c_j = (2.0 * damping_ratio * wn).astype(dtype)
    else:                                              # 'rayleigh'
        wn_np = np.asarray(wn)
        w1 = float(wn_np[0])
        w2r = next((float(v) for v in wn_np[1:] if v > 1.01 * w1),
                   3.0 * w1)
        alpha = damping_ratio * 2.0 * w1 * w2r / (w1 + w2r)
        beta = damping_ratio * 2.0 / (w1 + w2r)
        c_j = (alpha + beta * w2n).astype(dtype)
    if len(_MODAL_CACHE) >= 8:
        _MODAL_CACHE.clear()
    _MODAL_CACHE[key] = (cb, w2n, phi, c_j)   # strong ref pins the id key
    return w2n, phi, c_j


def _dynamic_transfer_core(prep, cb, w2n, phi, c_j, sea, case,
                           n_gauss, current_alpha,
                           hydro_damping=False) -> FreqTransfer:
    """Traceable per-sea dynamic transfer (mode acceleration): exact static
    rows from the condensed solve + the expanded modal correction.
    CBReduction carries its dimensions as STATIC pytree metadata, so
    they build shapes under jit.

    ``hydro_damping=True`` adds the Borgman-linearized relative-velocity
    drag damping (the c xdot term of F = c (u - xdot)): a consistent
    transverse element damping matrix from the per-member wetted-average
    coefficient, projected onto the modal diagonal (phi^T C phi — the
    standard decoupling approximation).  Resonant response of compliant
    structures is damping-limited, and this sea-state-dependent term
    routinely exceeds the structural ratio there."""
    from .ops.dynamics import _cb_expand, element_hydro_damping
    from .ops.freqdomain import linearized_sea_loads
    from .ops.sections import normal_stress_8pt

    coarse, refined, n_seg = prep.coarse, prep.refined, prep.n_seg
    dtype = refined.coords.dtype
    case = case.cast(dtype)
    n_red, nc, Mc = cb.n_red, cb.nc, cb.Mc
    n_int = n_seg - 1

    # exact static transfer rows on the FULL condensed system
    tr_s = _spectral_transfer_jit(prep, sea, case.cast(prep.K_I.dtype),
                                  n_gauss, 1, current_alpha)

    with jax.default_matmul_precision("highest"):
        conn_h, D_m, Cd_h, Cm_h = hydro_members(
            refined, case.marine_growth_mm, case.Cd, case.Cm)
        lin = linearized_sea_loads(sea, refined.coords, conn_h, D_m,
                                   case.wave_dir_deg, case.current_dir_deg,
                                   Cd_h, Cm_h, case.rho_water,
                                   n_gauss=n_gauss,
                                   current_alpha=current_alpha)
        # mean row: full statics; component rows: pure wave loading
        F_I_m, g_m = _chain_layout_loads(coarse, refined, case,
                                         lin.F1[:1], lin.F2[:1],
                                         cb.L_m, n_seg)
        zero = jnp.zeros_like(case.F_axial_kN)
        case_dyn = dataclasses.replace(
            case, F_axial_kN=zero, F_shear_kN=zero, M_moment_kNm=zero,
            M_torsion_kNm=zero, custom_sw_tonnes=zero, sw_mode="none",
            buoyancy="none", wind_speed_ms=0.0)
        F_I_d, g_d = _chain_layout_loads(coarse, refined, case_dyn,
                                         lin.F1[1:], lin.F2[1:],
                                         cb.L_m, n_seg)
        F_I = jnp.concatenate([F_I_m, F_I_d])          # [R, nc, 6]
        g = jnp.concatenate([g_m, g_d])                # [R, n_int, Mc, 6]
        R = F_I.shape[0]

        # work-conjugate projection to the reduced space
        F_red = jnp.zeros((R, n_red), dtype)
        F_red = F_red.at[:, :6 * nc].set(F_I.reshape(R, 6 * nc))
        F_i = g.swapaxes(1, 2).reshape(R, Mc, n_int * 6)
        F_red = F_red.at[:, cb.bdof].add(
            jnp.einsum("mnj,smn->smj", cb.Psi, F_i))
        F_red = F_red.at[:, cb.qdof].add(
            jnp.einsum("mnq,smn->smq", cb.Phi, F_i))
        F_f = F_red[:, cb.free]

        edofs = jnp.concatenate(
            [6 * refined.conn[:, 0:1] + jnp.arange(6),
             6 * refined.conn[:, 1:2] + jnp.arange(6)], axis=-1)

        if hydro_damping:
            # modal-diagonal projection of the linearized drag damping
            # (structural members only; appurtenance damping neglected)
            Mr = refined.conn.shape[0]
            C_e = element_hydro_damping(refined.coords, refined.conn,
                                        lin.c_damp[:Mr])
            n_modes = phi.shape[1]
            P_red = jnp.zeros((n_modes, cb.n_red), dtype)
            P_red = P_red.at[:, cb.free].set(phi.T)
            phi_full = _cb_expand(cb, P_red)           # [n_modes, n_dof]
            pe = phi_full[:, edofs]                    # [n_modes, Mr, 12]
            c_h = jnp.einsum("nmi,mij,nmj->n", pe, C_e, pe)
            c_j = c_j + jnp.maximum(c_h, 0.0)

        N = sea.omega.shape[0]
        w = sea.omega.astype(dtype)
        fc = F_f[1:1 + N] @ phi                        # [N, n_f] modal loads
        fs = F_f[1 + N:] @ phi
        d_ = w2n[None, :] - (w**2)[:, None]            # [N, n_f]
        cw = c_j[None, :] * w[:, None]
        det = d_**2 + cw**2
        qc = (d_ * fc - cw * fs) / det
        qs = (cw * fc + d_ * fs) / det
        # mode acceleration: subtract each mode's STATIC response, keep
        # only the dynamic correction (vanishes identically at w -> 0);
        # the static content comes exactly from the condensed solve above
        w2s = jnp.maximum(w2n, jnp.asarray(1e-30, dtype))
        Xc = (qc - fc / w2s) @ phi.T
        Xs = (qs - fs / w2s) @ phi.T

        X = jnp.concatenate([jnp.zeros((1, Xc.shape[1]), dtype), Xc, Xs])
        U_red = jnp.zeros((R, n_red), dtype).at[:, cb.free].set(X)
        U = _cb_expand(cb, U_red)                      # [R, n_dof_ref]
        U_static = jnp.concatenate([tr_s.U_mean[None], tr_s.U_cos,
                                    tr_s.U_sin]).astype(dtype)
        U = U + U_static

        KT6 = -matmul12(cb.K_local, cb.T)[:, :6, :]
        F1e = matvec12(KT6, U[:, edofs])
        s8 = normal_stress_8pt(refined.sections, refined.sect_id,
                               F1e[..., 0], F1e[..., 4], F1e[..., 5])
        return FreqTransfer(
            omega=w, U_mean=U[0], U_cos=U[1:1 + N], U_sin=U[1 + N:],
            stress_mean=s8[0], stress_cos=s8[1:1 + N],
            stress_sin=s8[1 + N:], totals=lin.totals.astype(dtype),
            sigma_v_max=lin.sigma_v_max, c_lin_mean=lin.c_lin_mean,
            totals_moment=lin.totals_moment.astype(dtype))


_dynamic_transfer_jit = partial(jax.jit, static_argnames=(
    "n_gauss", "current_alpha", "hydro_damping"))(_dynamic_transfer_core)


class ScatterFatigue(NamedTuple):
    """Scatter-diagram fatigue accumulation over multiple sea states."""

    damage_rainflow: jnp.ndarray    # [M] Miner sum over all states
    damage_rayleigh: jnp.ndarray    # [M]
    life_years_rainflow: jnp.ndarray
    life_years_rayleigh: jnp.ndarray
    per_state_rainflow: np.ndarray  # [n_states, M]
    states: tuple                   # ((Hs, Tp, occurrence), ...)


def scatter_fatigue(prep: CondensedPrepared, case: LoadCase, states, d,
                    exposure_years: float, curve: str = "D-sea-cp",
                    scf: float = 1.0, n_components: int = 48,
                    n_steps: int = 1024, seed: int = 0, U_c=0.0,
                    spectrum: str = "jonswap", stretching: str = "wheeler",
                    current_alpha=None, spreading_s=None) -> ScatterFatigue:
    """Fatigue over a SCATTER DIAGRAM of sea states (Miner accumulation).

    ``states``: sequence of (Hs [m], Tp [s], occurrence fraction) rows —
    the long-term wave climate — optionally with a 4th column, the state's
    wave HEADING [deg from North] (a directional scatter: the current
    rotates with the wave, preserving their relative angle; 3-column rows
    use the case's heading).  Each state is realized as an N-component
    random sea (seeded per state: reproducible), the FULL refined FEM
    response history is solved through the prepared condensed handle (one
    program per state), and per-member damage (narrow-band Rayleigh AND
    rainflow, :func:`.ops.spectrum.spectral_fatigue_screen`) accumulates
    linearly across states — the standard long-term fatigue recipe the
    reference cannot begin to express (one deterministic wave per run).

    Occurrences should sum to <= 1; a larger sum raises.
    """
    import dataclasses

    from .ops.spectrum import make_random_sea, spectral_fatigue_screen

    states = tuple(tuple(float(v) for v in row) for row in states)
    if not states:
        raise ValueError("scatter_fatigue needs at least one "
                         "(Hs, Tp, occurrence) state")
    if any(len(r) not in (3, 4) for r in states):
        raise ValueError("scatter rows must be (Hs, Tp, occurrence"
                         "[, heading_deg])")
    total_occ = sum(r[2] for r in states)
    if total_occ > 1.0 + 1e-9:
        raise ValueError(
            f"scatter-diagram occurrences sum to {total_occ:.3f} > 1")
    rel_dir = case.current_dir_deg - case.wave_dir_deg
    d_rf = d_nb = None
    per_state = []
    for i, row in enumerate(states):
        Hs, Tp, occ = row[:3]
        case_i = case
        if len(row) == 4:
            case_i = dataclasses.replace(case, wave_dir_deg=row[3],
                                         current_dir_deg=row[3] + rel_dir)
        sea = make_random_sea(Hs, Tp, d, n_components=n_components,
                              seed=seed + i, spectrum=spectrum, U_c=U_c,
                              spreading_s=spreading_s,
                              dtype=prep.refined.coords.dtype)
        dt = Tp / 10.0
        ts = np.arange(n_steps) * dt
        hist = sea_scan_prepared(prep, sea, case_i, ts,
                                 stretching=stretching,
                                 current_alpha=current_alpha)
        scr = spectral_fatigue_screen(np.asarray(hist.von_mises), dt,
                                      exposure_years=exposure_years,
                                      curve=curve, scf=scf, occurrence=occ)
        rf = np.asarray(scr.damage_rainflow)
        nb = np.asarray(scr.damage_rayleigh)
        per_state.append(rf)
        d_rf = rf if d_rf is None else d_rf + rf
        d_nb = nb if d_nb is None else d_nb + nb
    with np.errstate(divide="ignore"):
        life_rf = np.where(d_rf > 0, exposure_years / d_rf, np.inf)
        life_nb = np.where(d_nb > 0, exposure_years / d_nb, np.inf)
    return ScatterFatigue(
        damage_rainflow=jnp.asarray(d_rf), damage_rayleigh=jnp.asarray(d_nb),
        life_years_rainflow=jnp.asarray(life_rf),
        life_years_rayleigh=jnp.asarray(life_nb),
        per_state_rainflow=np.stack(per_state), states=states)


class ScatterFatigueSpectral(NamedTuple):
    """Frequency-domain scatter-diagram fatigue (no time march)."""

    damage_nb: jnp.ndarray          # [M] narrow-band Miner sum, all states
    damage_wl: jnp.ndarray          # [M] Wirsching-Light corrected sum
    life_years_nb: jnp.ndarray
    life_years_wl: jnp.ndarray
    per_state_wl: np.ndarray        # [n_states, M]
    mpm_utilization: jnp.ndarray    # [M] max over states (per-state storm)
    states: tuple                   # ((Hs, Tp, occurrence[, heading]), ...)
    per_state_sigma: np.ndarray     # [n_states, M] stress std dev (MPa)
    per_state_mean: np.ndarray      # [n_states, M] mean stress (MPa)
    per_state_nu0: np.ndarray       # [n_states, M] upcrossing rate (Hz)


def _scatter_spectral_setup(prep: CondensedPrepared, case: LoadCase,
                            states, d, *, n_components: int, seed: int,
                            spectrum: str, U_c, spreading_s, mesh=None):
    """Host-side input build shared by :func:`scatter_fatigue_spectral`
    and bench.py's cost-model lowering of ``_scatter_spectral_batched``:
    the stacked random-sea pytree plus per-state heading/occurrence rows.

    The seas are built ON THE HOST CPU device, so that per-state eager
    dispersion solves do not each dispatch to the accelerator; one
    transfer of the stacked tree replaces ~4 dispatches per state (chosen
    for dispatch cost on an earlier machine; not measured on the GPU).
    With ``mesh`` the state axis is zero-occurrence-padded to a device
    multiple and placed with a 'cases' NamedSharding.
    """
    from .ops.spectrum import make_random_sea

    solve_dtype = prep.K_I.dtype
    ldtype = prep.refined.coords.dtype
    with jax.default_device(jax.devices("cpu")[0]):
        seas = [make_random_sea(r[0], r[1], d, n_components=n_components,
                                seed=seed + i, spectrum=spectrum,
                                U_c=U_c, spreading_s=spreading_s,
                                dtype=ldtype)
                for i, r in enumerate(states)]
    heads = np.array([r[3] if len(r) == 4
                      else float(np.asarray(case.wave_dir_deg))
                      for r in states], np.float64)
    occs = np.array([r[2] for r in states], np.float64)
    B = len(states)
    if mesh is not None:
        n_pad = (-B) % mesh.size
        seas += [seas[-1]] * n_pad
        heads = np.concatenate([heads, np.repeat(heads[-1:], n_pad)])
        occs = np.concatenate([occs, np.zeros(n_pad)])
    with jax.default_device(jax.devices("cpu")[0]):
        sea_b = jax.tree.map(lambda *xs: jnp.stack(xs), *seas)
    heads_j = jnp.asarray(heads, solve_dtype)
    occs_j = jnp.asarray(occs, solve_dtype)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        cs = NamedSharding(mesh, P("cases"))
        sea_b = jax.device_put(sea_b, cs)
        heads_j = jax.device_put(heads_j, cs)
        occs_j = jax.device_put(occs_j, cs)
    return sea_b, heads_j, occs_j, B


def scatter_fatigue_spectral(prep: CondensedPrepared, case: LoadCase,
                             states, d, exposure_years: float,
                             curve: str = "D-sea-cp", scf=1.0,
                             n_components: int = 48, seed: int = 0,
                             U_c=0.0, spectrum: str = "jonswap",
                             current_alpha=None, spreading_s=None,
                             n_gauss: int = 15,
                             dynamic: bool = False,
                             damping_ratio: float = 0.02,
                             damping: str = "modal",
                             n_chain_modes: int = 12,
                             topside_mass_t: float | None = None,
                             added_mass_Ca=None,
                             support_stiffness=None,
                             storm_hours: float = 3.0,
                             mesh=None,
                             hydro_damping: bool = False
                             ) -> ScatterFatigueSpectral:
    """Long-term fatigue over an (Hs, Tp, occurrence[, heading]) scatter
    diagram in the FREQUENCY domain — the industry-standard spectral
    fatigue recipe, with no time marching at all.

    Each state costs 2N+1 condensed multi-RHS transfer solves
    (:func:`spectral_transfer_prepared`) and a closed-form statistics
    pass (:func:`.ops.freqdomain.spectral_stats`); per-member
    narrow-band + Wirsching-Light damages accumulate linearly across
    states (Miner).  Versus :func:`scatter_fatigue` (time domain +
    rainflow) this is deterministic — the closed forms depend only on
    component amplitudes, never on the realization's random phases — and
    ~an order of magnitude cheaper per state.  ``dynamic=True`` upgrades
    every state's transfer to the Craig-Bampton mode-acceleration
    dynamic transfer (:func:`spectral_transfer_dynamic`); the reduction
    is state-independent and cached, so the eigen-factorization is paid
    once per scatter sweep.

    ``states`` rows follow :func:`scatter_fatigue`: 3-column rows use the
    case's heading; a 4th column sets the state's wave heading [deg from
    North] with the current rotating alongside.  Occurrences must sum
    to <= 1.

    The whole diagram is ONE device program on both routes — the states
    stream through ``lax.map`` (per-call dispatch paid once, one-state
    memory footprint; the dynamic route closes over the state-independent
    cached CB reduction + modal basis) — and with ``mesh`` (a 1-D device
    mesh, axis 'cases', same convention as :func:`design_envelope`) the
    state axis is partitioned over the mesh: replicated factor,
    zero-occurrence padding to a device multiple, no cross-device
    communication (damage accumulation is a host-side occurrence-weighted
    sum).
    """
    from .ops.freqdomain import spectral_stats

    states = tuple(tuple(float(v) for v in row) for row in states)
    if not states:
        raise ValueError("scatter_fatigue_spectral needs at least one "
                         "(Hs, Tp, occurrence) state")
    if any(len(r) not in (3, 4) for r in states):
        raise ValueError("scatter rows must be (Hs, Tp, occurrence"
                         "[, heading_deg])")
    total_occ = sum(r[2] for r in states)
    if total_occ > 1.0 + 1e-9:
        raise ValueError(
            f"scatter-diagram occurrences sum to {total_occ:.3f} > 1")
    _check_no_slam(case, "scatter_fatigue_spectral")
    case = case.cast(prep.refined.coords.dtype)

    dyn = None
    if dynamic:
        if damping not in ("modal", "rayleigh"):
            raise ValueError("damping must be 'modal' or 'rayleigh', got "
                             f"{damping!r}")
        if not 0.0 < float(damping_ratio) < 1.0:
            raise ValueError("damping_ratio must be in (0, 1), got "
                             f"{damping_ratio}")
        if topside_mass_t is None:
            topside_mass_t = float(case.custom_sw_tonnes)
        cb = _cached_cb_reduce(prep.coarse, prep.refined, prep.n_seg,
                               float(case.E), float(case.nu),
                               topside_mass_t, n_chain_modes,
                               support_stiffness, added_mass_Ca,
                               float(case.rho_water))
        dyn = (cb,) + _cb_modal_basis(cb, damping, float(damping_ratio))

    sea_b, heads_j, occs_j, B = _scatter_spectral_setup(
        prep, case, states, d, n_components=n_components, seed=seed,
        spectrum=spectrum, U_c=U_c, spreading_s=spreading_s, mesh=mesh)
    if mesh is not None:
        nb, wl, mu, sig, mean_s, nu0 = _scatter_spectral_sharded(
            prep, case, sea_b, heads_j, occs_j, dyn, mesh, n_gauss,
            current_alpha, curve, float(exposure_years),
            float(storm_hours), scf, hydro_damping)
    else:
        nb, wl, mu, sig, mean_s, nu0 = _scatter_spectral_batched(
            prep, case, sea_b, heads_j, occs_j, dyn, n_gauss,
            current_alpha, curve, float(exposure_years),
            float(storm_hours), scf, hydro_damping)
    nb = np.asarray(nb)[:B]
    wl = np.asarray(wl)[:B]
    mu = np.asarray(mu)[:B]
    d_nb, d_wl = nb.sum(axis=0), wl.sum(axis=0)
    with np.errstate(divide="ignore"):
        life_nb = np.where(d_nb > 0, exposure_years / d_nb, np.inf)
        life_wl = np.where(d_wl > 0, exposure_years / d_wl, np.inf)
    return ScatterFatigueSpectral(
        damage_nb=jnp.asarray(d_nb), damage_wl=jnp.asarray(d_wl),
        life_years_nb=jnp.asarray(life_nb),
        life_years_wl=jnp.asarray(life_wl), per_state_wl=wl,
        mpm_utilization=jnp.asarray(mu.max(axis=0)), states=states,
        per_state_sigma=np.asarray(sig)[:B],
        per_state_mean=np.asarray(mean_s)[:B],
        per_state_nu0=np.asarray(nu0)[:B])


class LongTermExtremes(NamedTuple):
    """N-year return levels from the all-states upcrossing integral."""

    return_years: np.ndarray        # [R]
    stress_mpa: np.ndarray          # [R, M] return stress level
    utilization: np.ndarray         # [R, M] level / fy
    governing_state: np.ndarray     # [R, M] index of the dominant state


def long_term_extremes(res: ScatterFatigueSpectral, return_years=(10., 100.),
                       fy: float = 355.0) -> LongTermExtremes:
    """Long-term (all sea states) extreme response levels.

    The response within state i is Gaussian (mean m_i, std sigma_i,
    mean-upcrossing rate nu_i) under the Borgman-linearized transfer, so
    the LONG-TERM mean rate of upcrossings of level x is the
    occurrence-weighted sum

        nu(x) = sum_i occ_i nu_i exp(-(x - m_i)^2 / (2 sigma_i^2)),

    and the N-year return level solves nu(x) T_N = 1 (the standard
    all-sea-states method; the single-state occ=1 limit reduces EXACTLY
    to the most-probable-maximum formula m + sigma sqrt(2 ln(nu0 T_N)),
    which the tests pin).  Vectorized bisection over members; pure
    post-processing of a :func:`scatter_fatigue_spectral` result.
    """
    from .ops.fatigue import SECONDS_PER_YEAR

    occ = np.array([r[2] for r in res.states])[:, None]      # [B, 1]
    m = np.asarray(res.per_state_mean)                        # [B, M]
    sig = np.maximum(np.asarray(res.per_state_sigma), 0.0)
    nu = np.maximum(np.asarray(res.per_state_nu0), 0.0)
    live = (sig > 1e-12) & (occ * nu > 0)
    sig_s = np.where(live, sig, 1.0)

    def nu_of(x):                                             # x: [R, 1, M]
        ex = np.exp(-0.5 * ((x - m[None]) / sig_s[None]) ** 2)
        return np.sum(np.where(live[None], occ[None] * nu[None] * ex, 0.0),
                      axis=1)                                 # [R, M]

    R = len(return_years)
    T = np.asarray(return_years, np.float64) * SECONDS_PER_YEAR
    target = 1.0 / T[:, None]                                 # [R, 1]
    lo = np.broadcast_to(m.max(axis=0)[None], (R, m.shape[1])).copy()
    span = (sig * np.sqrt(2.0 * np.log(np.maximum(
        nu * T.max(), np.e)))).max(axis=0) + 1e-9
    hi = lo + 3.0 * span
    # grow hi until nu(hi) < target everywhere (rates can stack)
    for _ in range(8):
        under = nu_of(hi[:, None, :]) > target
        if not under.any():
            break
        hi = np.where(under, lo + 2.0 * (hi - lo), hi)
    for _ in range(80):                                       # bisection
        mid = 0.5 * (lo + hi)
        high_side = nu_of(mid[:, None, :]) > target
        lo = np.where(high_side, mid, lo)
        hi = np.where(high_side, hi, mid)
    x = 0.5 * (lo + hi)
    # no wave-induced variance anywhere: the level is the largest mean
    dead = ~live.any(axis=0)
    x[:, dead] = m.max(axis=0)[dead]
    # dominant state: largest crossing-rate contribution at the level
    ex = np.exp(-0.5 * ((x[:, None, :] - m[None]) / sig_s[None]) ** 2)
    contrib = np.where(live[None], occ[None] * nu[None] * ex, 0.0)
    gov = np.argmax(contrib, axis=1)
    return LongTermExtremes(
        return_years=np.asarray(return_years, np.float64),
        stress_mpa=x, utilization=x / float(fy), governing_state=gov)


def _scatter_spectral_one_fn(prep, case, dyn, n_gauss, current_alpha,
                             curve, exposure_years, storm_hours, scf,
                             hydro_damping=False):
    """Per-state kernel shared by the batched and mesh-sharded scatter
    routes: quasi-static (``dyn=None``) or Craig-Bampton dynamic transfer
    rows -> closed-form statistics."""
    from .ops.freqdomain import spectral_stats

    solve_dtype = prep.K_I.dtype
    case_s = case.cast(solve_dtype)
    rel = case_s.current_dir_deg - case_s.wave_dir_deg

    def one(args):
        sea, head, occ = args
        case_i = dataclasses.replace(case_s, wave_dir_deg=head,
                                     current_dir_deg=head + rel)
        if dyn is None:
            tr = _spectral_transfer_jit(prep, sea, case_i, n_gauss, 1,
                                        current_alpha)
        else:
            cb, w2n, phi, c_j = dyn
            tr = _dynamic_transfer_core(prep, cb, w2n, phi, c_j, sea,
                                        case_i, n_gauss, current_alpha,
                                        hydro_damping=hydro_damping)
        st = spectral_stats(
            tr.omega, tr.stress_mean, tr.stress_cos, tr.stress_sin,
            tr.U_mean, tr.U_cos, tr.U_sin, tr.totals,
            jnp.asarray(case_s.fy, solve_dtype),
            jnp.asarray(storm_hours * 3600.0, solve_dtype),
            jnp.asarray(exposure_years, solve_dtype), curve=curve,
            scf=jnp.asarray(scf, solve_dtype), occurrence=occ,
            sigma_v_max=tr.sigma_v_max, c_lin_mean=tr.c_lin_mean,
            totals_moment=tr.totals_moment)
        return (st.damage_nb, st.damage_wl, st.mpm_utilization,
                st.sigma_stress, st.mean_stress, st.nu0_hz)

    return one


@partial(jax.jit, static_argnames=("n_gauss", "current_alpha", "curve",
                                   "exposure_years", "storm_hours",
                                   "hydro_damping"))
def _scatter_spectral_batched(prep, case, sea_b, heads, occs, dyn,
                              n_gauss, current_alpha, curve, exposure_years,
                              storm_hours, scf, hydro_damping=False):
    """One device program for the whole scatter diagram: states stream
    through ``lax.map`` (single-state memory, dispatch floor paid once)."""
    one = _scatter_spectral_one_fn(prep, case, dyn, n_gauss,
                                   current_alpha, curve, exposure_years,
                                   storm_hours, scf, hydro_damping)
    with jax.default_matmul_precision("highest"):
        return jax.lax.map(one, (sea_b, heads, occs))


def _scatter_spectral_sharded(prep, case, sea_b, heads, occs, dyn,
                              mesh, n_gauss, current_alpha, curve,
                              exposure_years, storm_hours, scf,
                              hydro_damping=False):
    """State axis partitioned over the 1-D device mesh (axis 'cases'):
    replicated factor, each device streams its local block, no cross-
    device communication (accumulation happens host-side)."""
    from jax.sharding import PartitionSpec as P

    one = _scatter_spectral_one_fn(prep, case, dyn, n_gauss,
                                   current_alpha, curve, exposure_years,
                                   storm_hours, scf, hydro_damping)
    with jax.default_matmul_precision("highest"):
        @partial(jax.shard_map, mesh=mesh, in_specs=(P("cases"),),
                 out_specs=tuple(P("cases") for _ in range(6)))
        def local(batch):
            return jax.lax.map(one, batch)

        return local((sea_b, heads, occs))


def sea_response_batch(model: JacketModel, sea, case: LoadCase, ts,
                       n_gauss: int = 15, stretching: str = "none",
                       current_alpha=None,
                       support_stiffness=None) -> CondensedScanResults:
    """Irregular-sea time-history response on an UNREFINED (dense) model.

    The dense-path analog of :func:`sea_scan_prepared`: K is factored once
    and every sample time of the realization is a column of one multi-RHS
    solve; loads come from the spectral separable matmul.  Returns the same
    :class:`CondensedScanResults` layout (ts, U, von Mises, utilization,
    reactions, total Morison, critical index).
    """
    _check_no_slam(case, "sea_response_batch")
    ks_nodes, free_np, fixed_np = _ssi_spring_nodes(model, support_stiffness,
                                                    model.coords.dtype)
    return _sea_response_batch_jit(model, sea, case.cast(model.coords.dtype),
                                   jnp.asarray(ts, model.coords.dtype),
                                   n_gauss, stretching, current_alpha,
                                   ks_nodes, jnp.asarray(free_np),
                                   jnp.asarray(fixed_np))


@partial(jax.jit, static_argnames=("n_gauss", "stretching", "current_alpha"))
def _sea_response_batch_jit(model, sea, case, ts, n_gauss, stretching,
                            current_alpha, ks_nodes, free, fixed):
    from .ops.spectrum import morison_sea_batch

    with jax.default_matmul_precision("highest"):
        G = case.E / (2.0 * (1.0 + case.nu))
        Kg, K_local, T, L_m = element_stiffness(
            model.coords, model.conn, model.sections, model.sect_id,
            case.E, G, release=model.release)
        K = assemble_dense(Kg, model.conn, model.n_dof)
        fac = _spring_dfac(K, ks_nodes, free)
        conn_h, D_m, Cd_h, Cm_h = hydro_members(
            model, case.marine_growth_mm, case.Cd, case.Cm)
        mb = morison_sea_batch(sea, model.coords, conn_h, D_m,
                               case.wave_dir_deg, case.current_dir_deg,
                               Cd_h, Cm_h, case.rho_water, ts,
                               n_gauss=n_gauss, current_alpha=current_alpha,
                               stretching=stretching)
        F = jax.vmap(lambda nodal: assemble_loads(model, case, nodal,
                                                  L_m))(mb.nodal_forces)
        U = solve_mod.solve_factored(fac, F)               # [S, n_dof]
        KT6 = -matmul12(K_local, T)[:, :6, :]
        dofs = jnp.concatenate([6 * model.conn[:, 0:1] + jnp.arange(6),
                                6 * model.conn[:, 1:2] + jnp.arange(6)],
                               axis=-1)
        F1 = matvec12(KT6, U[:, dofs])
        vm = von_mises_8pt(model.sections, model.sect_id,
                           F1[..., 0], F1[..., 1], F1[..., 2],
                           F1[..., 3], F1[..., 4], F1[..., 5])
        util = vm / case.fy
        # reactions through the SPRINGLESS K: with springs the factored
        # system is (K + diag(k)) U = F, so K U - F = -k u_support exactly
        # (zero off the supports) — same recovery as the clamped path
        R = U @ K.T - F
        reac = R[:, fixed].reshape(ts.shape[0], -1, 6)
        crit = jnp.argmax(jnp.max(util, axis=1))
        return CondensedScanResults(
            ts=ts, U=U, von_mises=vm, utilization=util, reactions=reac,
            total_morison=mb.total_morison, critical_index=crit,
        )


def analyze_condensed(coarse: JacketModel, refined: JacketModel, n_seg: int,
                      wave, case: LoadCase, n_gauss: int = 15,
                      accel: str = "analytic",
                      solve_dtype=jnp.float64,
                      refine_steps: int = 1,
                      chain_solver: str = "auto",
                      support_stiffness=None) -> AnalysisResults:
    """Full single-phase analysis of a deeply refined jacket — the ~100k-DOF
    end-to-end path.

    Same pipeline and result pytree as :func:`analyze` (the reference
    RUN-ANALYSIS orchestrator, `JacketAnalysisGUI_v2.py:1827-2082`), but the
    linear solve goes through the exact chain condensation (ops/condense.py)
    instead of a dense factorization, so mesh refinement is bounded by HBM
    (O(n) memory), not by the O(n^2) dense assembly that caps the
    reference's own solver (`JacketAnalysisGUI_v2.py:444,485`).  At
    ``n_seg = 327`` the default jacket reaches 99,882 DOF; the solve is
    direct (no iteration count) and ``refine_steps`` rounds of iterative
    refinement give float32 ~1e-5-level agreement with float64
    (tests/test_large.py pins both).

    ``refined`` must come from ``refine_model(coarse, n_seg)``.

    ``support_stiffness`` (a [6] or [n_fixed, 6] spring vector, N/mm and
    N*mm/rad, as in :func:`analyze_ssi`) replaces the rigid support clamp
    with foundation springs: the condensed interface system is solved over
    ALL coarse DOFs with ``K_I + diag(k)`` and the reactions become the
    spring forces — soil-structure interaction at the ~100k-DOF scale.
    """
    _check_refined_layout(coarse, refined, n_seg)
    ks_nodes, free_np, fixed_np = _ssi_spring_nodes(coarse,
                                                    support_stiffness,
                                                    solve_dtype)
    return _analyze_condensed_jit(
        coarse, refined, wave, case.cast(solve_dtype), n_seg, n_gauss,
        accel, solve_dtype, refine_steps, chain_solver, ks_nodes,
        jnp.asarray(free_np), jnp.asarray(fixed_np))


@partial(jax.jit, static_argnames=("n_seg", "n_gauss", "accel",
                                   "solve_dtype", "refine_steps",
                                   "chain_solver"))
def _analyze_condensed_jit(coarse, refined, wave, case, n_seg, n_gauss,
                           accel, solve_dtype, refine_steps, chain_solver,
                           ks_nodes, free, fixed):
    with jax.default_matmul_precision("highest"):
        nc = coarse.n_nodes
        Mc = coarse.n_members
        n_int = n_seg - 1
        G = case.E / (2.0 * (1.0 + case.nu))

        # ---- element stiffness + chain factorization (solve precision) ----
        coords_s = refined.coords.astype(solve_dtype)
        sec_s = jax.tree.map(lambda x: x.astype(solve_dtype),
                             refined.sections)
        Kg, K_local, T, L_m = element_stiffness(
            coords_s, refined.conn, sec_s, refined.sect_id, case.E, G,
            release=refined.release)
        fac, _condense, _backsub = _chain_factor(Kg, n_seg, chain_solver)
        K_I = assemble_dense(fac.K_super, coarse.conn, 6 * nc)
        dfac = _spring_dfac(K_I, ks_nodes, free)

        # ---- hydrodynamic + interface + self-weight loads (model dtype) ----
        ldtype = refined.coords.dtype
        case_l = case.cast(ldtype)
        conn_h, D_m, Cd_h, Cm_h = hydro_members(
            refined, case_l.marine_growth_mm, case_l.Cd, case_l.Cm)
        mor = morison_loads(wave, refined.coords, conn_h, D_m,
                            case_l.wave_dir_deg, case_l.current_dir_deg,
                            Cd_h, Cm_h, case_l.rho_water,
                            case_l.t_analysis, n_gauss=n_gauss, accel=accel,
                            slam_cs=case_l.slam_cs)
        F = assemble_loads(refined, case_l, mor.nodal_forces,
                           L_m.astype(ldtype))
        F = F.astype(solve_dtype)

        # ---- condensed direct solve (+ refinement) ----
        node1 = coarse.conn[:, 0]
        node2 = coarse.conn[:, 1]
        Fn = F.reshape(1, -1, 6)
        F_I_nodes = Fn[:, :nc]
        g = Fn[:, nc:].reshape(1, Mc, n_int, 6).swapaxes(1, 2)
        solve_once = partial(_condensed_solve, fac=fac, dfac=dfac,
                             _condense=_condense, _backsub=_backsub,
                             node1=node1, node2=node2)
        U_In, v, F_cond_flat, U_I = solve_once(F_I_nodes, g)
        if refine_steps > 0:
            free_I = _refine_mask(coarse, ks_nodes, solve_dtype)
            U_In, v, U_I = _refine_condensed(Kg, n_seg, coarse.conn, free_I,
                                             solve_once, F_I_nodes, g,
                                             U_In, v, U_I, refine_steps,
                                             ks_nodes=ks_nodes)
        U = jnp.concatenate([U_In.reshape(1, -1),
                             v.swapaxes(1, 2).reshape(1, -1)], axis=1)[0]

        # ---- recovery: member end forces, stresses (`:504-533`) ----
        dofs = jnp.concatenate([6 * refined.conn[:, 0:1] + jnp.arange(6),
                                6 * refined.conn[:, 1:2] + jnp.arange(6)],
                               axis=-1)
        F1, F2 = internal_forces(K_local, T, U[dofs])
        vm = von_mises_8pt(sec_s, refined.sect_id,
                           F1[:, 0], F1[:, 1], F1[:, 2],
                           F1[:, 3], F1[:, 4], F1[:, 5])
        util = vm / case.fy

        # ---- reactions from the condensed interface system (exact) ----
        R = U_I @ K_I.T - F_cond_flat                      # [1, 6 nc]
        reac = R[0, fixed].reshape(-1, 6)

        disp = jnp.linalg.norm(U.reshape(-1, 6)[:, :3], axis=-1)
        imax = jnp.argmax(disp)
        return AnalysisResults(
            U=U, reactions=reac, F_applied=F,
            F1_local=F1, F2_local=F2,
            von_mises=vm, utilization=util, length_m=L_m,
            morison=mor,
            max_displacement_mm=disp[imax], max_displacement_node=imax,
            total_reaction=jnp.sum(reac, axis=0),
        )


def analyze_pdelta_condensed(coarse: JacketModel, refined: JacketModel,
                             n_seg: int, wave, case: LoadCase,
                             n_iter: int = 3, n_gauss: int = 15,
                             accel: str = "analytic",
                             solve_dtype=jnp.float64,
                             chain_solver: str = "auto",
                             support_stiffness=None) -> AnalysisResults:
    """Second-order (P-delta) analysis on a chain-refined mesh.

    The same fixed point as :func:`analyze_pdelta` — solve, take member
    axial forces, subtract the consistent geometric stiffness, re-solve —
    but every solve goes through the exact chain condensation, so the
    refinement range matches :func:`analyze_condensed` (the chain factor
    is rebuilt each iteration from ``Kg - K_G(N)``; the pivots stay
    Cholesky-positive while the case is below elastic buckling, and NaNs
    are the honest beyond-buckling signal, as on the dense path).
    Matches :func:`analyze_pdelta` on the same refined mesh exactly
    (tested) since both iterate the identical linearized system.
    """
    _check_refined_layout(coarse, refined, n_seg)
    ks_nodes, free_np, fixed_np = _ssi_spring_nodes(coarse,
                                                    support_stiffness,
                                                    solve_dtype)
    return _analyze_pdelta_condensed_jit(
        coarse, refined, wave, case.cast(solve_dtype), n_seg, n_iter,
        n_gauss, accel, solve_dtype, chain_solver, ks_nodes,
        jnp.asarray(free_np), jnp.asarray(fixed_np))


@partial(jax.jit, static_argnames=("n_seg", "n_iter", "n_gauss", "accel",
                                   "solve_dtype", "chain_solver"))
def _analyze_pdelta_condensed_jit(coarse, refined, wave, case, n_seg,
                                  n_iter, n_gauss, accel, solve_dtype,
                                  chain_solver, ks_nodes, free, fixed):
    from .ops.buckling import element_geometric_stiffness

    with jax.default_matmul_precision("highest"):
        nc = coarse.n_nodes
        Mc = coarse.n_members
        n_int = n_seg - 1
        G = case.E / (2.0 * (1.0 + case.nu))
        coords_s = refined.coords.astype(solve_dtype)
        sec_s = jax.tree.map(lambda x: x.astype(solve_dtype),
                             refined.sections)
        Kg, K_local, T, L_m = element_stiffness(
            coords_s, refined.conn, sec_s, refined.sect_id, case.E, G,
            release=refined.release)
        W_rel = None
        if refined.release is not None:
            from .ops.beams import release_W
            W_rel = release_W(coords_s, refined.conn, sec_s,
                              refined.sect_id, case.E, G, refined.release)

        # loads (same as the condensed single-phase path)
        ldtype = refined.coords.dtype
        case_l = case.cast(ldtype)
        conn_h, D_m, Cd_h, Cm_h = hydro_members(
            refined, case_l.marine_growth_mm, case_l.Cd, case_l.Cm)
        mor = morison_loads(wave, refined.coords, conn_h, D_m,
                            case_l.wave_dir_deg, case_l.current_dir_deg,
                            Cd_h, Cm_h, case_l.rho_water,
                            case_l.t_analysis, n_gauss=n_gauss, accel=accel,
                            slam_cs=case_l.slam_cs)
        F = assemble_loads(refined, case_l, mor.nodal_forces,
                           L_m.astype(ldtype)).astype(solve_dtype)
        node1 = coarse.conn[:, 0]
        node2 = coarse.conn[:, 1]
        Fn = F.reshape(1, -1, 6)
        F_I_nodes = Fn[:, :nc]
        g = Fn[:, nc:].reshape(1, Mc, n_int, 6).swapaxes(1, 2)
        dofs = jnp.concatenate([6 * refined.conn[:, 0:1] + jnp.arange(6),
                                6 * refined.conn[:, 1:2] + jnp.arange(6)],
                               axis=-1)

        def solve_with(Kg_i):
            fac, _condense, _backsub = _chain_factor(Kg_i, n_seg,
                                                     chain_solver)
            K_I = assemble_dense(fac.K_super, coarse.conn, 6 * nc)
            dfac = _spring_dfac(K_I, ks_nodes, free)
            U_In, v, F_cond_flat, U_I = _condensed_solve(
                F_I_nodes, g, fac=fac, dfac=dfac, _condense=_condense,
                _backsub=_backsub, node1=node1, node2=node2)
            U = jnp.concatenate([U_In.reshape(1, -1),
                                 v.swapaxes(1, 2).reshape(1, -1)], axis=1)[0]
            return U, K_I, F_cond_flat, U_I

        # first-order solution (amplification baseline) + fixed point
        U, K_I, F_cond_flat, U_I = solve_with(Kg)
        disp1 = jnp.linalg.norm(U.reshape(-1, 6)[:, :3], axis=-1)
        for _ in range(n_iter):
            F1, _ = internal_forces(K_local, T, U[dofs])
            N = -F1[:, 0]
            KGg = element_geometric_stiffness(coords_s, refined.conn, N,
                                              W=W_rel)
            U, K_I, F_cond_flat, U_I = solve_with(Kg - KGg)

        # recovery (elastic member stiffness, reference conventions)
        F1, F2 = internal_forces(K_local, T, U[dofs])
        vm = von_mises_8pt(sec_s, refined.sect_id,
                           F1[:, 0], F1[:, 1], F1[:, 2],
                           F1[:, 3], F1[:, 4], F1[:, 5])
        util = vm / case.fy
        R = U_I @ K_I.T - F_cond_flat
        reac = R[0, fixed].reshape(-1, 6)
        disp2 = jnp.linalg.norm(U.reshape(-1, 6)[:, :3], axis=-1)
        amp = jnp.max(jnp.where(disp1 > 0,
                                disp2 / jnp.where(disp1 > 0, disp1, 1.0),
                                1.0))
        imax = jnp.argmax(disp2)
        return AnalysisResults(
            U=U, reactions=reac, F_applied=F,
            F1_local=F1, F2_local=F2,
            von_mises=vm, utilization=util, length_m=L_m,
            morison=mor,
            max_displacement_mm=disp2[imax], max_displacement_node=imax,
            total_reaction=jnp.sum(reac, axis=0),
            pdelta_amplification=amp,
        )


class EnvelopeResults(NamedTuple):
    """Design-envelope results over a case batch (leading axis = case)."""

    ts: jnp.ndarray                # [C, S] phase times (periods differ)
    utilization: jnp.ndarray | None  # [C, S, M] full field (dense envelope);
                                     # None for the condensed variant, which
                                     # materializes only the reductions below
    max_util_per_phase: jnp.ndarray  # [C, S]
    max_util_per_case: jnp.ndarray # [C]
    critical_phase: jnp.ndarray    # [C] phase index of each case's max
    governing_case: jnp.ndarray    # [] argmax over cases
    member_envelope: jnp.ndarray   # [M] max utilization over all cases+phases
    total_morison: jnp.ndarray     # [C, S, 3]


def design_envelope(model: JacketModel, waves: FourierWave, cases: LoadCase,
                    n_steps: int = 36, n_gauss: int = 15,
                    mesh=None, current_alpha=None,
                    support_stiffness=None,
                    stretching: str = "none") -> EnvelopeResults:
    """Full-FEM storm envelope: every case x every wave phase, one program.

    The BASELINE 'design envelope' configuration: a batch of (H, T, heading)
    wave cases, each scanned over its own wave period with the COMPLETE
    structural solution at every phase (the reference can only scan total
    force, serially, for one case).  The stiffness is factored once —
    material properties are shared across cases — so the whole envelope is
    one multi-RHS solve of C x S load vectors; kinematics use the separable
    harmonic matmul per case.

    ``waves``/``cases`` carry a leading case axis (see
    ``parallel.sweep.make_wave_batch`` / ``make_case_batch``).  With ``mesh``
    (1-D device mesh, axis 'cases') the batch is sharded across chips and
    the governing-case reduction is an all-reduce across devices.

    ``current_alpha`` applies the power-law current profile (as in
    :func:`analyze`); ``support_stiffness`` puts the supports on 6-DOF
    foundation springs (see :func:`analyze_ssi`) for the whole envelope.
    """
    _check_shared_material(cases)
    _check_no_slam(cases, "design_envelope")
    ks_nodes, free_np, _ = _ssi_spring_nodes(model, support_stiffness,
                                             model.coords.dtype)
    free = jnp.asarray(free_np)

    fn = partial(_design_envelope_jit, n_steps=n_steps, n_gauss=n_gauss,
                 current_alpha=current_alpha, ks_nodes=ks_nodes,
                 stretching=stretching)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        cs = NamedSharding(mesh, P("cases"))
        waves = jax.device_put(waves, cs)
        cases = jax.device_put(cases, cs)
        model = jax.device_put(model, NamedSharding(mesh, P()))
    return fn(model, waves, cases.cast(model.coords.dtype), free)


@partial(jax.jit, static_argnames=("n_steps", "n_gauss", "current_alpha",
                                   "stretching"))
def _design_envelope_jit(model, waves, cases, free, n_steps, n_gauss,
                         current_alpha, ks_nodes, stretching="none"):
    with jax.default_matmul_precision("highest"):
        dtype = model.coords.dtype
        G = cases.E[0] / (2.0 * (1.0 + cases.nu[0]))
        Kg, K_local, T, L_m = element_stiffness(
            model.coords, model.conn, model.sections, model.sect_id,
            cases.E[0], G, release=model.release)
        K = assemble_dense(Kg, model.conn, model.n_dof)
        fac = _spring_dfac(K, ks_nodes, free)
        KT6 = -matmul12(K_local, T)[:, :6, :]
        dofs = jnp.concatenate([6 * model.conn[:, 0:1] + jnp.arange(6),
                                6 * model.conn[:, 1:2] + jnp.arange(6)],
                               axis=-1)

        def one_case(wave, case):
            ts = jnp.arange(n_steps, dtype=dtype) * wave.T / n_steps
            conn_h, D_m, Cd_h, Cm_h = hydro_members(
                model, case.marine_growth_mm, case.Cd, case.Cm)
            mb = morison_phase_batch(wave, model.coords, conn_h, D_m,
                                     case.wave_dir_deg, case.current_dir_deg,
                                     Cd_h, Cm_h, case.rho_water, ts,
                                     n_gauss=n_gauss,
                                     current_alpha=current_alpha,
                                     stretching=stretching)
            F = jax.vmap(lambda nodal: assemble_loads(model, case, nodal,
                                                      L_m))(mb.nodal_forces)
            U = solve_mod.solve_factored(fac, F)           # [S, n_dof]
            F1 = matvec12(KT6, U[:, dofs])
            vm = von_mises_8pt(model.sections, model.sect_id,
                               F1[..., 0], F1[..., 1], F1[..., 2],
                               F1[..., 3], F1[..., 4], F1[..., 5])
            return ts, vm / case.fy, mb.total_morison

        ts, util, tot = jax.vmap(one_case)(waves, cases)   # [C, S, M]
        per_phase = jnp.max(util, axis=-1)                 # [C, S]
        crit_phase = jnp.argmax(per_phase, axis=-1)        # [C]
        max_per_case = jnp.max(per_phase, axis=-1)         # [C]
        return EnvelopeResults(
            ts=ts, utilization=util,
            max_util_per_phase=per_phase,
            max_util_per_case=max_per_case,
            critical_phase=crit_phase,
            governing_case=jnp.argmax(max_per_case),
            member_envelope=jnp.max(util, axis=(0, 1)),
            total_morison=tot,
        )


def design_envelope_condensed(coarse: JacketModel, refined: JacketModel,
                              n_seg: int, waves: FourierWave,
                              cases: LoadCase, n_steps: int = 36,
                              n_gauss: int = 15,
                              solve_dtype=jnp.float32,
                              case_batch: int = 32,
                              kinematics: str = "separable",
                              chain_solver: str = "auto",
                              current_alpha=None,
                              support_stiffness=None,
                              mesh=None,
                              stretching: str = "none") -> EnvelopeResults:
    """Storm envelope on a REFINED mesh: every case x phase, full FEM.

    Combines the two flagship paths: the exact chain condensation (interior
    DOFs eliminated once — the factorization is case-independent) and the
    separable per-case phase kinematics.  Cases stream through ``lax.map``
    in chunks of ``case_batch`` so the refined displacement fields never
    materialize for the whole envelope at once; only reduced quantities
    (per-case-phase max utilization, the member envelope) accumulate.

    With ``mesh`` (a 1-D device mesh, axis 'cases') the case batch is
    partitioned across devices: every device factors the case-independent
    chains (replicated compute, no communication) and streams its local
    case block; only the member-envelope reduction crosses devices.
    """
    _check_shared_material(cases)
    _check_no_slam(cases, "design_envelope_condensed")
    _check_refined_layout(coarse, refined, n_seg)
    ks_nodes, free_np, _ = _ssi_spring_nodes(coarse, support_stiffness,
                                             solve_dtype)
    cases = cases.cast(solve_dtype)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        cs = NamedSharding(mesh, P("cases"))
        rep = NamedSharding(mesh, P())
        waves = jax.device_put(waves, cs)
        cases = jax.device_put(cases, cs)
        coarse = jax.device_put(coarse, rep)
        refined = jax.device_put(refined, rep)
        return _design_envelope_condensed_sharded(
            coarse, refined, waves, cases, n_seg, n_steps, n_gauss,
            solve_dtype, case_batch, kinematics, chain_solver,
            current_alpha, ks_nodes, jnp.asarray(free_np), mesh, stretching)
    return _design_envelope_condensed_jit(
        coarse, refined, waves, cases, n_seg, n_steps,
        n_gauss, solve_dtype, case_batch, kinematics, chain_solver,
        current_alpha, ks_nodes, jnp.asarray(free_np), stretching)


def _condensed_envelope_one_case(coarse, refined, cases, n_seg, n_steps,
                                 n_gauss, solve_dtype, kinematics,
                                 chain_solver, current_alpha, ks_nodes,
                                 free, stretching="none"):
    """Build the per-case closure shared by the single-device and
    mesh-sharded condensed envelopes: element stiffness + chain factor +
    grounded interface factorization happen ONCE here (case-independent);
    the returned ``one_case`` maps (wave, case) -> per-case reductions."""
    nc = coarse.n_nodes
    G = cases.E[0] / (2.0 * (1.0 + cases.nu[0]))
    ldtype = refined.coords.dtype

    coords_s = refined.coords.astype(solve_dtype)
    sec_s = jax.tree.map(lambda x: x.astype(solve_dtype),
                         refined.sections)
    Kg, K_local, T, L_m = element_stiffness(
        coords_s, refined.conn, sec_s, refined.sect_id, cases.E[0], G,
        release=refined.release)
    fac, _condense, _backsub = _chain_factor(Kg, n_seg, chain_solver)
    K_I = assemble_dense(fac.K_super, coarse.conn, 6 * nc)
    dfac = _spring_dfac(K_I, ks_nodes, free)
    KT6 = -matmul12(K_local, T)[:, :6, :]                  # [Mr, 6, 12]
    node1 = coarse.conn[:, 0]
    node2 = coarse.conn[:, 1]

    def one_case(args):
            wave, case = args
            case_l = case.cast(ldtype)
            conn_h, D_m, Cd_h, Cm_h = hydro_members(
                refined, case_l.marine_growth_mm, case_l.Cd, case_l.Cm)
            ts = jnp.arange(n_steps, dtype=ldtype) \
                * wave.T.astype(ldtype) / n_steps
            if kinematics == "separable":
                mb = morison_phase_batch(wave, refined.coords, conn_h,
                                         D_m, case_l.wave_dir_deg,
                                         case_l.current_dir_deg, Cd_h,
                                         Cm_h, case_l.rho_water, ts,
                                         n_gauss=n_gauss,
                                         current_alpha=current_alpha,
                                         stretching=stretching)
            else:
                raise ValueError(f"unknown kinematics mode {kinematics!r}")
            F_I_nodes, g = _chain_layout_loads(coarse, refined, case_l,
                                               mb.F1, mb.F2,
                                               L_m.astype(ldtype), n_seg)
            F_I_nodes = F_I_nodes.astype(solve_dtype)
            g = g.astype(solve_dtype)
            fI, fJ, v_g = _condense(fac, g)
            F_cond = F_I_nodes.at[:, node1].add(fI).at[:, node2].add(fJ)
            U_I = solve_mod.solve_factored(dfac, F_cond.reshape(n_steps, -1))
            U_In = U_I.reshape(n_steps, nc, 6)
            v = _backsub(fac, v_g, U_In[:, node1], U_In[:, node2])
            # recovery straight from the chain layout (see the scan impl)
            vext = jnp.concatenate([U_In[:, node1][:, None], v,
                                    U_In[:, node2][:, None]], axis=1)
            u_e = jnp.concatenate([vext[:, :-1], vext[:, 1:]], axis=-1)
            u_elem = u_e.swapaxes(1, 2).reshape(n_steps, -1, 12)
            F1 = matvec12(KT6, u_elem)
            vm = von_mises_8pt(sec_s, refined.sect_id,
                               F1[..., 0], F1[..., 1], F1[..., 2],
                               F1[..., 3], F1[..., 4], F1[..., 5])
            util = vm / case.fy
            return (ts, jnp.max(util, axis=1), jnp.max(util, axis=0),
                    mb.total_morison.astype(solve_dtype))

    return one_case


def _envelope_from_reductions(ts, per_phase, member_envelope, tot):
    crit_phase = jnp.argmax(per_phase, axis=-1)
    max_per_case = jnp.max(per_phase, axis=-1)
    return EnvelopeResults(
        ts=ts, utilization=None,  # full [C, S, M] field not materialized
        max_util_per_phase=per_phase,
        max_util_per_case=max_per_case,
        critical_phase=crit_phase,
        governing_case=jnp.argmax(max_per_case),
        member_envelope=member_envelope,
        total_morison=tot,
    )


@partial(jax.jit, static_argnames=("n_seg", "n_steps", "n_gauss",
                                   "solve_dtype", "case_batch", "kinematics",
                                   "chain_solver", "current_alpha",
                                   "stretching"))
def _design_envelope_condensed_jit(coarse, refined, waves, cases, n_seg,
                                   n_steps, n_gauss, solve_dtype, case_batch,
                                   kinematics, chain_solver, current_alpha,
                                   ks_nodes, free, stretching="none"):
    with jax.default_matmul_precision("highest"):
        one_case = _condensed_envelope_one_case(
            coarse, refined, cases, n_seg, n_steps, n_gauss, solve_dtype,
            kinematics, chain_solver, current_alpha, ks_nodes, free,
            stretching)
        # batch_size vmaps the body per chunk
        ts, per_phase, member_max, tot = jax.lax.map(
            one_case, (waves, cases), batch_size=case_batch)
        return _envelope_from_reductions(ts, per_phase,
                                         jnp.max(member_max, axis=0), tot)


@partial(jax.jit, static_argnames=("n_seg", "n_steps", "n_gauss",
                                   "solve_dtype", "case_batch", "kinematics",
                                   "chain_solver", "current_alpha", "mesh",
                                   "stretching"))
def _design_envelope_condensed_sharded(coarse, refined, waves, cases, n_seg,
                                       n_steps, n_gauss, solve_dtype,
                                       case_batch, kinematics, chain_solver,
                                       current_alpha, ks_nodes, free, mesh,
                                       stretching="none"):
    """Mesh-sharded condensed envelope: the case axis is partitioned over
    the 1-D device mesh (axis 'cases'); each device factors the (case-
    independent) chains once — replicated compute, no communication — and
    streams its local case block through ``lax.map``.  Only the member-
    envelope reduction crosses devices (one ``pmax``)."""
    from jax.sharding import PartitionSpec as P

    with jax.default_matmul_precision("highest"):
        one_case = _condensed_envelope_one_case(
            coarse, refined, cases, n_seg, n_steps, n_gauss, solve_dtype,
            kinematics, chain_solver, current_alpha, ks_nodes, free,
            stretching)

        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(P("cases"),),
                 out_specs=(P("cases"), P("cases"), P(), P("cases")))
        def local(wc):
            n_local = wc[1].E.shape[0]
            ts, per_phase, member_max, tot = jax.lax.map(
                one_case, wc, batch_size=min(case_batch, max(n_local, 1)))
            member_env = jax.lax.pmax(jnp.max(member_max, axis=0), "cases")
            return ts, per_phase, member_env, tot

        ts, per_phase, member_env, tot = local((waves, cases))
        return _envelope_from_reductions(ts, per_phase, member_env, tot)
