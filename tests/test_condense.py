"""Condensed (substructure) solver vs the generic dense path.

The chain condensation is an exact direct method, so on a refined model its
displacements, stresses and reactions must match the dense Cholesky solver
to solver precision at every phase.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import small_fem_solver_tpu as sf
from small_fem_solver_tpu.api import phase_scan_condensed


@pytest.mark.parametrize("n_seg", [2, 4, 8])
def test_condensed_matches_dense(n_seg):
    coarse = sf.default_3leg_jacket()
    refined = sf.refine_model(coarse, n_seg)
    wave = sf.make_wave(9.5, 9.4, 50.0, U_c=1.2, model="stokes", N=5)
    case = sf.LoadCase(wave_dir_deg=38.0, current_dir_deg=120.0,
                       F_axial_kN=25100.0, F_shear_kN=2900.0,
                       M_moment_kNm=5000.0, custom_sw_tonnes=1100.0,
                       sw_mode="custom")

    n_steps = 5
    scan = phase_scan_condensed(coarse, refined, n_seg, wave, case,
                                n_steps=n_steps, accel="fd",
                                kinematics="pointwise")

    for i in range(n_steps):
        case_i = sf.LoadCase(**{**{f: getattr(case, f) for f in
                                   ("E", "nu", "fy", "rho_water",
                                    "wave_dir_deg", "current_dir_deg", "Cd",
                                    "Cm", "F_axial_kN", "F_shear_kN",
                                    "M_moment_kNm", "M_torsion_kNm",
                                    "custom_sw_tonnes")},
                                "t_analysis": float(scan.ts[i]),
                                "sw_mode": "custom"})
        ref = sf.analyze(refined, wave, case_i, solver="chol")
        U_ref = np.asarray(ref.U)
        scale = np.abs(U_ref).max()
        np.testing.assert_allclose(np.asarray(scan.U[i]), U_ref,
                                   rtol=1e-8, atol=1e-8 * scale)
        np.testing.assert_allclose(np.asarray(scan.von_mises[i]),
                                   np.asarray(ref.von_mises),
                                   rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(np.asarray(scan.reactions[i]),
                                   np.asarray(ref.reactions), rtol=1e-7,
                                   atol=1e-7 * np.abs(np.asarray(ref.reactions)).max())


def test_condensed_calculated_self_weight():
    """Self-weight 'calculated' distributes to interior chain nodes too."""
    coarse = sf.default_3leg_jacket()
    n_seg = 3
    refined = sf.refine_model(coarse, n_seg)
    wave = sf.airy_wave(2.0, 9.4, 50.0)
    case = sf.LoadCase(sw_mode="calculated")
    scan = phase_scan_condensed(coarse, refined, n_seg, wave, case, n_steps=2,
                                accel="fd", kinematics="pointwise")
    ref = sf.analyze(refined, wave,
                     sf.LoadCase(sw_mode="calculated", t_analysis=0.0),
                     solver="chol")
    U_ref = np.asarray(ref.U)
    np.testing.assert_allclose(np.asarray(scan.U[0]), U_ref, rtol=1e-8,
                               atol=1e-8 * np.abs(U_ref).max())


def test_separable_calculated_self_weight():
    """The chain-layout load builder handles sw_mode='calculated' (per-
    element half weights to both chain ends) identically to the pointwise
    path's assemble_loads + reshape."""
    coarse = sf.default_3leg_jacket()
    n_seg = 6
    refined = sf.refine_model(coarse, n_seg)
    wave = sf.airy_wave(9.0, 9.4, 50.0, 1.2)
    case = sf.LoadCase(wave_dir_deg=38.0, current_dir_deg=38.0,
                       F_axial_kN=25100.0, F_shear_kN=2900.0,
                       sw_mode="calculated")
    sp = phase_scan_condensed(coarse, refined, n_seg, wave, case, n_steps=3,
                              kinematics="separable")
    pw = phase_scan_condensed(coarse, refined, n_seg, wave, case, n_steps=3,
                              kinematics="pointwise", accel="analytic")
    U = np.asarray(pw.U)
    np.testing.assert_allclose(np.asarray(sp.U), U, rtol=1e-10,
                               atol=1e-10 * np.abs(U).max())


def test_condensed_equilibrium():
    coarse = sf.default_3leg_jacket()
    refined = sf.refine_model(coarse, 4)
    wave = sf.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="fenton", N=12)
    case = sf.LoadCase(wave_dir_deg=38.0, current_dir_deg=38.0,
                       F_axial_kN=25100.0, F_shear_kN=2900.0,
                       custom_sw_tonnes=1100.0, sw_mode="custom")
    scan = phase_scan_condensed(coarse, refined, 4, wave, case, n_steps=4)
    # vertical reaction balances axial + self-weight - morison_z at each phase
    Fz_applied = -25100e3 - 1100e3 * 9.81 + np.asarray(scan.total_morison)[:, 2]
    Rz = np.asarray(scan.reactions).sum(axis=1)[:, 2]
    np.testing.assert_allclose(Rz, -Fz_applied, rtol=1e-9)


@pytest.mark.parametrize("model_name,N", [("airy", 1), ("stokes", 5),
                                          ("fenton", 12)])
def test_separable_kinematics_matches_pointwise(model_name, N):
    """The separable harmonic-matmul load path equals the per-phase path.

    Exact for Airy (no clamp); for clamped models the only difference is the
    1 cm evaluation band below the instantaneous surface (~1e-7 relative).
    """
    coarse = sf.default_3leg_jacket()
    refined = sf.refine_model(coarse, 8)
    wave = sf.make_wave(9.5, 9.4, 50.0, U_c=1.2, model=model_name, N=N)
    case = sf.LoadCase(wave_dir_deg=38.0, current_dir_deg=120.0,
                       F_axial_kN=25100.0, F_shear_kN=2900.0,
                       custom_sw_tonnes=1100.0, sw_mode="custom")
    sp = phase_scan_condensed(coarse, refined, 8, wave, case, n_steps=12,
                              kinematics="separable")
    pw = phase_scan_condensed(coarse, refined, 8, wave, case, n_steps=12,
                              kinematics="pointwise", accel="analytic")
    tol = 1e-12 if model_name == "airy" else 2e-6
    scale = float(np.abs(np.asarray(pw.U)).max())
    np.testing.assert_allclose(np.asarray(sp.U), np.asarray(pw.U),
                               rtol=tol, atol=tol * scale)
    np.testing.assert_allclose(np.asarray(sp.total_morison),
                               np.asarray(pw.total_morison), rtol=tol,
                               atol=tol * float(np.abs(np.asarray(pw.total_morison)).max()))


def test_flagship_f32_accuracy_at_bench_scale():
    """The exact bench configuration (bench.py): n_seg=32 (9,612 DOF),
    Fenton N=18 storm wave, float32 condensation/solve — asserted against
    the same scan in float64.  Pins the '4e-4 relative vs float64' claim of
    the bench docstring / docs/ARCHITECTURE.md section 4 at flagship scale
    (round-1 verdict: flagship-scale correctness was extrapolated from
    n_seg=2-4, never tested)."""
    n_seg = 32
    coarse64 = sf.default_3leg_jacket()
    refined64 = sf.refine_model(coarse64, n_seg)
    coarse32 = sf.default_3leg_jacket(dtype=jnp.float32)
    refined32 = sf.refine_model(coarse32, n_seg)
    assert refined64.n_dof == 9612  # the bench's advertised size
    case = sf.LoadCase(wave_dir_deg=38.0, current_dir_deg=38.0,
                       F_axial_kN=25100.0, F_shear_kN=2900.0,
                       custom_sw_tonnes=1100.0, sw_mode="custom")
    n_steps = 8  # same per-phase math as the bench's 360 (phase count only
    # scales the RHS batch; per-phase conditioning is what is under test)
    w64 = sf.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="fenton", N=18)
    w32 = sf.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="fenton", N=18,
                       dtype=jnp.float32)
    s64 = phase_scan_condensed(coarse64, refined64, n_seg, w64, case,
                               n_steps=n_steps, kinematics="separable",
                               solve_dtype=jnp.float64)
    # both exact chain solvers at the bench config: 'thomas' (flat) and
    # 'nested' (what chain_solver='auto' — the bench default — picks at
    # n_seg=32; measured slightly MORE f32-accurate: ~1.8e-5 vs ~2.2e-5)
    for chain_solver in ("thomas", "nested"):
        s32 = phase_scan_condensed(coarse32, refined32, n_seg, w32, case,
                                   n_steps=n_steps, kinematics="separable",
                                   solve_dtype=jnp.float32,
                                   chain_solver=chain_solver)
        U64, U32 = np.asarray(s64.U), np.asarray(s32.U, dtype=np.float64)
        scale = np.abs(U64).max()
        # measured ~3.6e-5 / ~8e-5 with the default one refinement round
        # (vs ~4e-3 without refinement); 1e-4/2e-4 leave headroom for
        # device rounding (measured 3.1e-5 / 8.2e-5 on an H100 at 360 phases)
        assert np.abs(U32 - U64).max() / scale < 1e-4
        vm64 = np.asarray(s64.von_mises)
        vm32 = np.asarray(s32.von_mises, dtype=np.float64)
        assert np.abs(vm32 - vm64).max() / vm64.max() < 2e-4
        # the governing answer (max utilization over the scan) agrees tightly
        np.testing.assert_allclose(float(s32.utilization.max()),
                                   float(s64.utilization.max()), rtol=2e-4)


@pytest.mark.parametrize("n_seg,n_sub", [(4, 2), (6, 3), (32, 8), (324, 18)])
def test_nested_matches_thomas(n_seg, n_sub):
    """Two-level (nested) condensation == flat block Thomas in float64.

    Note the float32 limit is NOT the solver: at n_seg ~ 300 the Jacobi-
    scaled bending system's condition (~n_seg^4) reaches 1/eps_f32, so the
    f32 element stiffness itself perturbs the solution O(1) — deep
    refinement requires float64 regardless of elimination order (measured:
    flat and nested both carry O(1) f32 error at n_seg=324, and iterative
    refinement converges to the perturbed system).  Nested's value is the
    scan depth: O(sqrt(n_seg)) sequential steps."""
    from small_fem_solver_tpu.ops.beams import element_stiffness
    from small_fem_solver_tpu.ops.condense import (
        back_substitute, back_substitute_nested, condense_loads,
        condense_loads_nested, factor_chains, factor_chains_nested)
    model = sf.refine_model(sf.default_3leg_jacket(), n_seg)
    E, G = 210000.0, 210000.0 / 2.6
    Kg, _, _, _ = element_stiffness(model.coords, model.conn, model.sections,
                                    model.sect_id, E, G)
    f1 = factor_chains(Kg, n_seg)
    fn = factor_chains_nested(Kg, n_seg, n_sub)
    Ks = float(np.abs(np.asarray(f1.K_super)).max())
    np.testing.assert_allclose(np.asarray(fn.K_super), np.asarray(f1.K_super),
                               rtol=1e-9, atol=1e-10 * Ks)
    rng = np.random.default_rng(0)
    g = jnp.asarray(rng.normal(size=(2, n_seg - 1, 51, 6))) * 1e5
    fI1, fJ1, v1 = condense_loads(f1, g)
    fIn, fJn, vn = condense_loads_nested(fn, g)
    np.testing.assert_allclose(np.asarray(fIn), np.asarray(fI1), rtol=1e-8,
                               atol=1e-9 * float(np.abs(np.asarray(fI1)).max()))
    np.testing.assert_allclose(np.asarray(fJn), np.asarray(fJ1), rtol=1e-8,
                               atol=1e-9 * float(np.abs(np.asarray(fJ1)).max()))
    uI = jnp.asarray(rng.normal(size=(2, 51, 6)))
    uJ = jnp.asarray(rng.normal(size=(2, 51, 6)))
    b1 = back_substitute(f1, v1, uI, uJ)
    bn = back_substitute_nested(fn, vn, uI, uJ)
    np.testing.assert_allclose(np.asarray(bn), np.asarray(b1), rtol=1e-8,
                               atol=1e-9 * float(np.abs(np.asarray(b1)).max()))


def test_nested_split_rejects_primes():
    from small_fem_solver_tpu.ops.condense import nested_split
    assert nested_split(324) == 18
    assert nested_split(336) in (21, 16)
    with pytest.raises(ValueError):
        nested_split(317)  # prime


@pytest.mark.parametrize("chain_solver", ["thomas", "nested"])
def test_prepared_scan_matches_one_shot(chain_solver):
    """phase_scan_prepared(prepare_condensed(...)) == phase_scan_condensed.

    The prepared path runs EXACTLY the same per-scan program with the
    factorization read from the handle, so the results must agree to solver
    precision (identical ops modulo compilation grouping)."""
    from small_fem_solver_tpu.api import (phase_scan_prepared,
                                          prepare_condensed)
    n_seg = 16
    coarse = sf.default_3leg_jacket()
    refined = sf.refine_model(coarse, n_seg)
    wave = sf.make_wave(9.5, 9.4, 50.0, U_c=1.2, model="stokes", N=5)
    case = sf.LoadCase(wave_dir_deg=38.0, current_dir_deg=120.0,
                       F_axial_kN=25100.0, F_shear_kN=2900.0,
                       custom_sw_tonnes=1100.0, sw_mode="custom")
    one = phase_scan_condensed(coarse, refined, n_seg, wave, case,
                               n_steps=6, kinematics="separable",
                               chain_solver=chain_solver)
    prep = prepare_condensed(coarse, refined, n_seg, E=case.E, nu=case.nu,
                             chain_solver=chain_solver)
    pre = phase_scan_prepared(prep, wave, case, n_steps=6,
                              kinematics="separable")
    scale = float(np.abs(np.asarray(one.U)).max())
    np.testing.assert_allclose(np.asarray(pre.U), np.asarray(one.U),
                               rtol=1e-12, atol=1e-12 * scale)
    np.testing.assert_allclose(np.asarray(pre.von_mises),
                               np.asarray(one.von_mises), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(pre.reactions),
                               np.asarray(one.reactions), rtol=1e-12,
                               atol=1e-12 * float(np.abs(np.asarray(one.reactions)).max()))
    # a second wave/case through the SAME handle (the amortization use case)
    wave2 = sf.make_wave(14.0, 11.0, 50.0, U_c=1.0, model="stokes", N=5)
    case2 = sf.LoadCase(wave_dir_deg=90.0, F_shear_kN=1000.0, sw_mode="none")
    one2 = phase_scan_condensed(coarse, refined, n_seg, wave2, case2,
                                n_steps=6, kinematics="separable",
                                chain_solver=chain_solver)
    pre2 = phase_scan_prepared(prep, wave2, case2, n_steps=6,
                               kinematics="separable")
    scale2 = float(np.abs(np.asarray(one2.U)).max())
    np.testing.assert_allclose(np.asarray(pre2.U), np.asarray(one2.U),
                               rtol=1e-12, atol=1e-12 * scale2)


def test_prepared_scan_ssi_and_material_guard():
    """Prepared handle with foundation springs matches the one-shot SSI
    scan; a mismatched case material raises."""
    from small_fem_solver_tpu.api import (phase_scan_prepared,
                                          prepare_condensed)
    n_seg = 4
    coarse = sf.default_3leg_jacket()
    refined = sf.refine_model(coarse, n_seg)
    wave = sf.airy_wave(9.0, 9.4, 50.0, 1.2)
    case = sf.LoadCase(wave_dir_deg=38.0, F_axial_kN=25100.0,
                       F_shear_kN=2900.0, sw_mode="none")
    springs = np.array([5e6, 5e6, 8e6, 5e12, 5e12, 5e12])
    one = phase_scan_condensed(coarse, refined, n_seg, wave, case,
                               n_steps=3, kinematics="separable",
                               support_stiffness=springs)
    prep = prepare_condensed(coarse, refined, n_seg,
                             support_stiffness=springs)
    pre = phase_scan_prepared(prep, wave, case, n_steps=3,
                              kinematics="separable")
    scale = float(np.abs(np.asarray(one.U)).max())
    np.testing.assert_allclose(np.asarray(pre.U), np.asarray(one.U),
                               rtol=1e-12, atol=1e-12 * scale)
    with pytest.raises(ValueError, match="does not match the prepared"):
        phase_scan_prepared(prep, wave, sf.LoadCase(E=200000.0), n_steps=3)


def test_analyze_prepared_matches_analyze_condensed():
    """analyze_prepared == analyze_condensed to solver precision, with the
    factorization read from the handle (incl. F2 and reactions)."""
    from small_fem_solver_tpu.api import analyze_prepared, prepare_condensed
    n_seg = 8
    coarse = sf.default_3leg_jacket()
    refined = sf.refine_model(coarse, n_seg)
    wave = sf.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="fenton", N=12)
    case = sf.LoadCase(wave_dir_deg=38.0, current_dir_deg=38.0,
                       F_axial_kN=25100.0, F_shear_kN=2900.0,
                       custom_sw_tonnes=1100.0, sw_mode="custom",
                       t_analysis=0.34)
    ref = sf.analyze_condensed(coarse, refined, n_seg, wave, case)
    prep = prepare_condensed(coarse, refined, n_seg)
    got = analyze_prepared(prep, wave, case)
    scale = float(np.abs(np.asarray(ref.U)).max())
    np.testing.assert_allclose(np.asarray(got.U), np.asarray(ref.U),
                               rtol=1e-12, atol=1e-12 * scale)
    # KT is prefolded (K_local @ T once) vs the reference path's two
    # sequential matvecs: identical math, different rounding order —
    # agreement at ~1e-10 of the force scale
    f2_scale = float(np.abs(np.asarray(ref.F2_local)).max())
    np.testing.assert_allclose(np.asarray(got.F2_local),
                               np.asarray(ref.F2_local), rtol=1e-9,
                               atol=1e-9 * f2_scale)
    np.testing.assert_allclose(np.asarray(got.reactions),
                               np.asarray(ref.reactions), rtol=1e-12,
                               atol=1e-12 * float(np.abs(np.asarray(ref.reactions)).max()))
    np.testing.assert_allclose(np.asarray(got.von_mises),
                               np.asarray(ref.von_mises), rtol=1e-12,
                               atol=1e-12)
    # a second case through the same handle
    import dataclasses
    case2 = dataclasses.replace(case, wave_dir_deg=120.0, t_analysis=2.0)
    ref2 = sf.analyze_condensed(coarse, refined, n_seg, wave, case2)
    got2 = analyze_prepared(prep, wave, case2)
    np.testing.assert_allclose(np.asarray(got2.U), np.asarray(ref2.U),
                               rtol=1e-12,
                               atol=1e-12 * float(np.abs(np.asarray(ref2.U)).max()))
