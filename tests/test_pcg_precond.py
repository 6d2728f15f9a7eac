"""Two-level (smoothed rigid-body aggregation) PCG preconditioner.

Closes BASELINE.md's "IC-preconditioned CG" line for general sparse
meshes: block-Jacobi iteration counts grow ~O(chain length) on refined
slender frames (round-2 verdict weak item); the smoothed-aggregation
coarse correction must cut them >= 3x at the ~10k-DOF scale while
reproducing the direct solution.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import small_fem_solver_tpu as sf


def _storm():
    wave = sf.make_wave(9.5, 9.4, 50.0, U_c=1.2, model="stokes", N=5)
    case = sf.LoadCase(wave_dir_deg=38.0, current_dir_deg=38.0,
                       F_axial_kN=25100.0, F_shear_kN=2900.0,
                       custom_sw_tonnes=1100.0, sw_mode="custom")
    return wave, case


def test_two_level_cuts_iterations_10kdof():
    """refine_model(32) jacket, 9,612 DOF, f64, tol 1e-10: measured
    block-Jacobi 4,275 iterations vs two-level 621 (6.9x).  The assertion
    requires a cut of >= 3x and identical physics."""
    wave, case = _storm()
    model = sf.refine_model(sf.default_3leg_jacket(), 32)
    assert model.n_dof == 9612
    r_bj = sf.analyze(model, wave, case, solver="pcg", accel="analytic",
                      pcg_precond="block_jacobi", pcg_maxiter=20000)
    r_tl = sf.analyze(model, wave, case, solver="pcg", accel="analytic",
                      pcg_precond="two_level", pcg_maxiter=20000)
    it_bj, it_tl = int(r_bj.solver_iters), int(r_tl.solver_iters)
    assert it_tl * 3 <= it_bj, (it_bj, it_tl)
    r_ch = sf.analyze(model, wave, case, solver="chol", accel="analytic")
    scale = float(np.abs(np.asarray(r_ch.U)).max())
    np.testing.assert_allclose(np.asarray(r_tl.U), np.asarray(r_ch.U),
                               rtol=1e-8, atol=1e-9 * scale)
    np.testing.assert_allclose(np.asarray(r_tl.utilization),
                               np.asarray(r_ch.utilization), rtol=1e-7)


def test_two_level_auto_and_validation():
    wave, case = _storm()
    model = sf.refine_model(sf.default_3leg_jacket(), 8)
    # auto picks two-level for this mesh (> 120 nodes) — same answer as
    # the explicit setting, solver still converges
    r_auto = sf.analyze(model, wave, case, solver="pcg", accel="analytic")
    r_tl = sf.analyze(model, wave, case, solver="pcg", accel="analytic",
                      pcg_precond="two_level")
    assert int(r_auto.solver_iters) == int(r_tl.solver_iters)
    with pytest.raises(ValueError, match="pcg_precond"):
        sf.analyze(model, wave, case, solver="pcg", pcg_precond="ilu")


def test_aggregates_cover_and_connect():
    from small_fem_solver_tpu.api import _cached_bcsr_pattern
    from small_fem_solver_tpu.ops.coarse import aggregates_from_pattern
    model = sf.refine_model(sf.default_3leg_jacket(), 16)
    pattern = _cached_bcsr_pattern(model.conn, model.n_nodes)
    agg = aggregates_from_pattern(pattern, target_size=17)
    assert agg.min() == 0 and agg.shape == (model.n_nodes,)
    n_agg = agg.max() + 1
    sizes = np.bincount(agg)
    assert sizes.sum() == model.n_nodes
    # aggregates are modest and none dominates
    assert sizes.max() <= 2 * 17
    # the aggregate count respects the dense-prolongator cap
    assert n_agg <= 192


def _assembled(n_seg):
    from small_fem_solver_tpu.api import _cached_bcsr_pattern
    from small_fem_solver_tpu.ops.assembly import assemble_bcsr
    from small_fem_solver_tpu.ops.beams import element_stiffness
    model = sf.refine_model(sf.default_3leg_jacket(), n_seg)
    E, G = 210000.0, 210000.0 / 2.6
    Kg, _, _, _ = element_stiffness(model.coords, model.conn,
                                    model.sections, model.sect_id, E, G)
    pattern = _cached_bcsr_pattern(model.conn, model.n_nodes)
    return model, assemble_bcsr(Kg, pattern), pattern


def test_sparse_prolongator_matches_dense_oracle():
    """The round-5 block-sparse smoothed prolongator (slot-table P, O(n)
    apply) must agree to roundoff with the dense-P construction it
    replaced (the dense form needed 28.4 GB at ~100k DOF, more than the
    device held)."""
    from small_fem_solver_tpu.ops.coarse import (
        aggregates_from_pattern, build_coarse_space,
        build_coarse_space_dense, coarse_solve, prolong, prolongator_dense,
        restrict)
    model, A, pattern = _assembled(12)
    agg = aggregates_from_pattern(pattern)
    n_agg = int(agg.max()) + 1
    cs = build_coarse_space(A, model.coords, model.fixed_mask,
                            agg=jnp.asarray(agg), n_agg=n_agg)
    cd = build_coarse_space_dense(A, model.coords, model.fixed_mask,
                                  agg=jnp.asarray(agg), n_agg=n_agg)
    Ps = np.asarray(prolongator_dense(cs))
    Pd = np.asarray(cd.P)
    scale = np.abs(Pd).max()
    np.testing.assert_allclose(Ps, Pd, atol=1e-12 * scale)
    np.testing.assert_allclose(np.asarray(cs.L_c), np.asarray(cd.L_c),
                               atol=1e-12 * np.abs(np.asarray(cd.L_c)).max())
    rng = np.random.default_rng(0)
    r = jnp.asarray(rng.normal(size=model.n_dof))
    xc = jnp.asarray(rng.normal(size=6 * n_agg))
    np.testing.assert_allclose(np.asarray(restrict(cs, r)),
                               Pd.T @ np.asarray(r), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(prolong(cs, xc)),
                               Pd @ np.asarray(xc), rtol=1e-10)
    # the full coarse correction P A_c^-1 P^T r agrees too
    corr_s = np.asarray(prolong(cs, coarse_solve(cs, restrict(cs, r))))
    corr_d = np.asarray(cd.P @ coarse_solve(cd, cd.P.T @ r))
    np.testing.assert_allclose(corr_s, corr_d,
                               atol=1e-10 * np.abs(corr_d).max())


def test_two_level_sparse_vs_dense_iterates_10kdof():
    """At ~10k DOF the sparse-P two-level PCG must
    reproduce the dense-P preconditioner's convergence trajectory —
    identical preconditioner => same iterate sequence up to roundoff, so
    iteration counts match (tiny slack for rounding at the tol check)."""
    from small_fem_solver_tpu.ops import solve as solve_mod
    from small_fem_solver_tpu.ops.assembly import (bcsr_block_diagonal,
                                                   bcsr_matvec)
    from small_fem_solver_tpu.ops.coarse import (
        aggregates_from_pattern, build_coarse_space,
        build_coarse_space_dense, two_level_preconditioner,
        two_level_preconditioner_dense)
    model, A, pattern = _assembled(32)
    assert model.n_dof == 9612
    agg = aggregates_from_pattern(pattern)
    n_agg = int(agg.max()) + 1
    rng = np.random.default_rng(7)
    fmask = solve_mod.dof_free_mask(model.fixed_mask).astype(A.blocks.dtype)
    b = fmask * jnp.asarray(rng.normal(size=model.n_dof) * 1e5)
    op = solve_mod.projected_operator(lambda x: bcsr_matvec(A, x), fmask)
    bj = solve_mod.block_jacobi_preconditioner(bcsr_block_diagonal(A), fmask)
    cs = build_coarse_space(A, model.coords, model.fixed_mask,
                            agg=jnp.asarray(agg), n_agg=n_agg)
    cd = build_coarse_space_dense(A, model.coords, model.fixed_mask,
                                  agg=jnp.asarray(agg), n_agg=n_agg)
    rs = solve_mod.pcg(op, b, precond=two_level_preconditioner(bj, cs),
                       tol=1e-10, maxiter=20000)
    rd = solve_mod.pcg(op, b,
                       precond=two_level_preconditioner_dense(bj, cd),
                       tol=1e-10, maxiter=20000)
    assert abs(int(rs.n_iter) - int(rd.n_iter)) <= 2, \
        (int(rs.n_iter), int(rd.n_iter))
    scale = float(np.abs(np.asarray(rd.x)).max())
    np.testing.assert_allclose(np.asarray(rs.x), np.asarray(rd.x),
                               atol=1e-8 * scale)


def test_distributed_pcg_two_level_matches_dense():
    """The coarse correction inside shard_map (one psum of the [6 n_agg]
    coarse residual per iteration) reproduces the dense answer at a scale
    where block-Jacobi alone needs thousands of iterations."""
    from small_fem_solver_tpu.api import _cached_bcsr_pattern
    from small_fem_solver_tpu.ops.assembly import (assemble_bcsr,
                                                   assemble_dense)
    from small_fem_solver_tpu.ops.beams import element_stiffness
    from small_fem_solver_tpu.ops.coarse import (aggregates_from_pattern,
                                                 build_coarse_space)
    from small_fem_solver_tpu.ops.solve import free_fixed_dofs, solve_dense
    from small_fem_solver_tpu.parallel.pcg_dist import distributed_pcg

    devs = np.array(jax.devices())
    mesh = Mesh(devs, ("dof",))
    n_seg = 16
    model = sf.refine_model(sf.default_3leg_jacket(), n_seg)
    assert model.n_dof == 4716
    E, G = 210000.0, 210000.0 / 2.6
    Kg, _, _, _ = element_stiffness(model.coords, model.conn,
                                    model.sections, model.sect_id, E, G)
    pattern = _cached_bcsr_pattern(model.conn, model.n_nodes)
    A = assemble_bcsr(Kg, pattern)
    K = assemble_dense(Kg, model.conn, model.n_dof)
    rng = np.random.default_rng(1)
    b = jnp.asarray(rng.normal(size=model.n_dof) * 1e5)
    b = b * jnp.repeat(jnp.logical_not(model.fixed_mask), 6)

    agg = aggregates_from_pattern(pattern)
    cs = build_coarse_space(A, model.coords, model.fixed_mask,
                            agg=jnp.asarray(agg), n_agg=int(agg.max()) + 1)
    u2, it2, res2 = distributed_pcg(A, b, model.fixed_mask, mesh,
                                    tol=1e-11, maxiter=20000, coarse=cs)
    u1, it1, _ = distributed_pcg(A, b, model.fixed_mask, mesh,
                                 tol=1e-11, maxiter=20000)
    assert float(res2) < 1e-10
    assert int(it2) * 3 <= int(it1), (int(it1), int(it2))
    free, _ = free_fixed_dofs(model.fixed_mask)
    u_ref = solve_dense(K, b, jnp.asarray(free))
    scale = np.abs(np.asarray(u_ref)).max()
    np.testing.assert_allclose(np.asarray(u2), np.asarray(u_ref),
                               rtol=1e-6, atol=1e-7 * scale)


def test_structured_ops_match_generic():
    """Entry-major band matvec/preconditioner (ops/structured.py) against
    the generic BCSR forms, single application (operator-level parity is
    tight; a full CG at tol tau may legitimately return iterates differing
    by ~tau*cond between arithmetically-reordered but equivalent paths)."""
    from small_fem_solver_tpu.api import (_cached_aggregates,
                                          _cached_bcsr_pattern)
    from small_fem_solver_tpu.ops import solve as solve_mod
    from small_fem_solver_tpu.ops import structured
    from small_fem_solver_tpu.ops.assembly import (assemble_bcsr,
                                                   bcsr_block_diagonal,
                                                   bcsr_matvec)
    from small_fem_solver_tpu.ops.beams import element_stiffness
    from small_fem_solver_tpu.ops.coarse import (build_coarse_space,
                                                 two_level_preconditioner)

    model = sf.refine_model(sf.default_3leg_jacket(), 12)
    pattern = _cached_bcsr_pattern(model.conn, model.n_nodes)
    plan = structured.plan_structured(pattern)
    assert plan is not None  # refined meshes are chain-tridiagonal
    E = jnp.float64(210000.0)
    Kg, _, _, _ = element_stiffness(model.coords, model.conn,
                                    model.sections, model.sect_id, E,
                                    E / 2.6)
    A = assemble_bcsr(Kg, pattern)
    fmask = solve_mod.dof_free_mask(model.fixed_mask).astype(jnp.float64)
    Dinv = solve_mod.block_jacobi_inverse(bcsr_block_diagonal(A), fmask)
    agg, n_agg, splan = _cached_aggregates(pattern)
    cs = build_coarse_space(A, model.coords, model.fixed_mask, agg=agg,
                            n_agg=n_agg, plan=splan)
    sop = structured.build_structured(A, plan, Dinv, fmask, cs)

    n = model.n_nodes
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal(6 * n))
    X = x.reshape(n, 6).T

    y_ref = np.asarray(bcsr_matvec(A, x))
    y_em = np.asarray(structured.matvec(sop, X)).T.reshape(-1)
    sc = np.abs(y_ref).max()
    np.testing.assert_allclose(y_em, y_ref, atol=1e-12 * sc)

    pre_ref = two_level_preconditioner(
        solve_mod.block_jacobi_apply(Dinv), cs)
    z_ref = np.asarray(pre_ref(x))
    z_em = np.asarray(structured.precond(sop, X)).T.reshape(-1)
    np.testing.assert_allclose(z_em, z_ref,
                               atol=1e-12 * np.abs(z_ref).max())

    # the generic 21-node jacket has no dominant bands -> generic path
    assert structured.plan_structured(
        _cached_bcsr_pattern(sf.default_3leg_jacket().conn, 21)) is None


def test_chunked_pcg_matches_single_program():
    """analyze(pcg_chunk=...) — the watchdog-safe segmented CG — must
    reproduce the single-program PCG solution: the structured path
    converges to the same tolerance, and the generic-ops chunk path
    (forced by disabling the structured plan) is ITERATE-IDENTICAL since
    it re-enters the very same while_loop body."""
    import small_fem_solver_tpu.api as api

    wave, case = _storm()
    model = sf.refine_model(sf.default_3leg_jacket(), 8)
    r0 = sf.analyze(model, wave, case, solver="pcg", accel="analytic",
                    pcg_precond="two_level", pcg_tol=1e-9,
                    pcg_maxiter=8000)
    r1 = sf.analyze(model, wave, case, solver="pcg", accel="analytic",
                    pcg_precond="two_level", pcg_tol=1e-9,
                    pcg_maxiter=8000, pcg_chunk=50)
    assert float(r1.solver_residual) <= 1e-9
    scale = np.abs(np.asarray(r0.U)).max()
    # two converged-at-1e-9 iterates of reordered arithmetic agree to a
    # few orders above the tolerance on this conditioning
    np.testing.assert_allclose(np.asarray(r1.U), np.asarray(r0.U),
                               atol=1e-5 * scale)

    # force the generic chunk path: identical while_loop -> same iterates
    from small_fem_solver_tpu.api import _cached_bcsr_pattern
    pattern = _cached_bcsr_pattern(model.conn, model.n_nodes)
    key = (pattern.n_nodes, np.asarray(pattern.block_rows).tobytes(),
           np.asarray(pattern.block_cols).tobytes())
    api._SPLAN_CACHE[key] = None
    try:
        r2 = sf.analyze(model, wave, case, solver="pcg", accel="analytic",
                        pcg_precond="two_level", pcg_tol=1e-9,
                        pcg_maxiter=8000, pcg_chunk=50)
    finally:
        api._SPLAN_CACHE.pop(key, None)
    assert int(r2.solver_iters) == int(r0.solver_iters)
    du = np.abs(np.asarray(r2.U) - np.asarray(r0.U)).max() / scale
    assert du < 1e-11, du
