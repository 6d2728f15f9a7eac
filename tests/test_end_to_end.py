"""End-to-end pipeline parity vs the reference at 1e-8 relative, plus
solver cross-checks (LU vs Cholesky vs PCG) and the batched phase scan."""
import jax.numpy as jnp
import numpy as np
import pytest

import small_fem_solver_tpu as sf


def _case_from_params(p):
    return sf.LoadCase(
        E=p["E"], nu=p["nu"], fy=p["fy"], rho_water=p["rho_water"],
        wave_dir_deg=p["wave_dir"], current_dir_deg=p["current_dir"],
        Cd=p["Cd"], Cm=p["Cm"],
        F_axial_kN=p["F_axial_kN"], F_shear_kN=p["F_shear_kN"],
        M_moment_kNm=p["M_moment_kNm"], M_torsion_kNm=p["M_torsion_kNm"],
        custom_sw_tonnes=p.get("custom_sw_tonnes", 0.0),
        t_analysis=p["t_analysis"], sw_mode=p["sw_mode"],
    )


def _run(golden, solver="lu"):
    p = golden["params"]
    model = sf.default_3leg_jacket(leg_section=(p["D_leg"], p["t_leg"]),
                                   brace_section=(p["D_brace"], p["t_brace"]),
                                   rho_steel=p["rho_steel"])
    wave = sf.airy_wave(p["H"], p["T"], p["d"], p["U_c"])
    res = sf.analyze(model, wave, _case_from_params(p), solver=solver)
    return model, res


@pytest.mark.parametrize("which", ["golden_default", "golden_variant"])
def test_load_vector_matches_reference(which, request):
    g = request.getfixturevalue(which)
    model, res = _run(g)
    F_ref = np.array(g["fem"]["F_global"])
    scale = np.abs(F_ref).max()
    np.testing.assert_allclose(np.asarray(res.F_applied), F_ref,
                               rtol=1e-8, atol=1e-8 * scale)


@pytest.mark.parametrize("which", ["golden_default", "golden_variant"])
@pytest.mark.parametrize("solver", ["lu", "chol"])
def test_displacements_match_reference(which, solver, request):
    g = request.getfixturevalue(which)
    model, res = _run(g, solver=solver)
    U_ref = np.array(g["fem"]["U"])
    scale = np.abs(U_ref).max()
    np.testing.assert_allclose(np.asarray(res.U), U_ref, rtol=1e-8,
                               atol=1e-8 * scale)


@pytest.mark.parametrize("which", ["golden_default", "golden_variant"])
def test_reactions_match_reference(which, request):
    g = request.getfixturevalue(which)
    model, res = _run(g)
    fixed_names = [n for n in model.node_names if n in g["fem"]["reactions"]]
    assert fixed_names == model.fixed_node_names()
    R_ref = np.array([g["fem"]["reactions"][n] for n in fixed_names])
    scale = np.abs(R_ref).max()
    np.testing.assert_allclose(np.asarray(res.reactions), R_ref,
                               rtol=1e-8, atol=1e-8 * scale)


@pytest.mark.parametrize("which", ["golden_default", "golden_variant"])
def test_member_forces_and_vm_match_reference(which, request):
    g = request.getfixturevalue(which)
    model, res = _run(g)
    ref = g["fem"]["internal_forces"]
    assert [m["member"] for m in ref] == list(model.member_names)

    F1 = np.asarray(res.F1_local)
    F2 = np.asarray(res.F2_local)
    for col, key, scale in [(0, "Fx_max_kN", 1e3), (1, "Fy_max_kN", 1e3),
                            (2, "Fz_max_kN", 1e3), (4, "My_max_kNm", 1e6),
                            (5, "Mz_max_kNm", 1e6)]:
        ours = np.maximum(np.abs(F1[:, col]), np.abs(F2[:, col])) / scale
        refs = np.array([m[key] for m in ref])
        np.testing.assert_allclose(ours, refs, rtol=1e-8, atol=1e-8 * max(refs.max(), 1))

    vm_ref = np.array([m["von_mises_max_MPa"] for m in ref])
    np.testing.assert_allclose(np.asarray(res.von_mises), vm_ref, rtol=1e-8)
    util_ref = np.array([m["utilization"] for m in ref])
    np.testing.assert_allclose(np.asarray(res.utilization), util_ref, rtol=1e-8)
    np.testing.assert_allclose(np.asarray(res.length_m),
                               [m["length_m"] for m in ref], rtol=1e-10)


def test_reaction_equilibrium(golden_default):
    """Support reactions balance the applied loads (physics invariant the
    reference surfaces in its log, `JacketAnalysisGUI_v2.py:2027-2033`)."""
    model, res = _run(golden_default)
    F = np.asarray(res.F_applied).reshape(-1, 6)
    R = np.asarray(res.total_reaction)
    np.testing.assert_allclose(R[:3], -F[:, :3].sum(0), rtol=1e-9)


def test_pcg_matches_dense(golden_default):
    g = golden_default
    model, res_lu = _run(g, solver="lu")
    _, res_pcg = _run(g, solver="pcg")
    U_ref = np.asarray(res_lu.U)
    scale = np.abs(U_ref).max()
    np.testing.assert_allclose(np.asarray(res_pcg.U), U_ref, rtol=1e-6,
                               atol=1e-8 * scale)
    np.testing.assert_allclose(np.asarray(res_pcg.von_mises),
                               np.asarray(res_lu.von_mises), rtol=1e-6)


def test_phase_batch_consistent_with_single_solves(golden_default):
    """The factored multi-RHS phase batch equals per-phase analyze()."""
    g = golden_default
    p = g["params"]
    model = sf.default_3leg_jacket()
    wave = sf.airy_wave(p["H"], p["T"], p["d"], p["U_c"])
    case = _case_from_params(p)
    ts, batch = sf.analyze_phase_batch(model, wave, case, n_steps=8,
                                       accel="fd")   # match analyze()'s default
    for i in [0, 3, 7]:
        case_i = sf.LoadCase(**{**{f.name: getattr(case, f.name)
                                   for f in case.__dataclass_fields__.values()},
                                "t_analysis": float(ts[i])})
        res_i = sf.analyze(model, wave, case_i, solver="chol")
        np.testing.assert_allclose(np.asarray(batch.U[i]), np.asarray(res_i.U),
                                   rtol=1e-9, atol=1e-9 * abs(np.asarray(res_i.U)).max())
        np.testing.assert_allclose(np.asarray(batch.von_mises[i]),
                                   np.asarray(res_i.von_mises), rtol=1e-9)


def test_max_displacement_report(golden_default):
    g = golden_default
    model, res = _run(g)
    U_ref = np.array(g["fem"]["U"]).reshape(-1, 6)
    disp = np.linalg.norm(U_ref[:, :3], axis=1)
    assert int(res.max_displacement_node) == int(np.argmax(disp))
    np.testing.assert_allclose(float(res.max_displacement_mm), disp.max(), rtol=1e-8)


def test_lstsq_fallback_on_singular_system():
    """A free-floating structure (no supports) is singular; the lstsq
    fallback still returns a finite minimum-norm solution, replicating the
    reference's try/except recovery (`JacketAnalysisGUI_v2.py:484-487`)."""
    import dataclasses
    model = sf.default_3leg_jacket()
    floating = dataclasses.replace(
        model, fixed_mask=jnp.zeros_like(model.fixed_mask))
    wave = sf.airy_wave(5.0, 9.4, 50.0)
    case = sf.LoadCase(sw_mode="none")
    res = sf.analyze(floating, wave, case, solver="lu", lstsq_fallback=True)
    assert bool(jnp.isfinite(res.U).all())


def test_no_top_nodes_drops_interface_loads_without_nan():
    """Regression: a model without top nodes (e.g. minimal JSON input) must
    not produce 0/0 NaNs in the load vector; interface loads are dropped."""
    import dataclasses
    model = sf.default_3leg_jacket()
    no_top = dataclasses.replace(model, top_mask=jnp.zeros_like(model.top_mask))
    wave = sf.airy_wave(5.0, 9.4, 50.0)
    case = sf.LoadCase(F_axial_kN=25100.0, F_shear_kN=2900.0, sw_mode="none")
    res = sf.analyze(no_top, wave, case, solver="chol")
    assert bool(jnp.isfinite(res.U).all())
    # only Morison loads remain
    F = np.asarray(res.F_applied).reshape(-1, 6)
    assert np.abs(F[:, 3:]).max() == 0.0


def test_pcg_diagnostics_and_nonconvergence_warning(golden_default):
    """analyze(solver='pcg') surfaces iteration count/residual and warns when
    PCG hits maxiter without converging."""
    import warnings
    p = golden_default["params"]
    model = sf.default_3leg_jacket()
    wave = sf.airy_wave(p["H"], p["T"], p["d"], p["U_c"])
    case = _case_from_params(p)
    res = sf.analyze(model, wave, case, solver="pcg")
    assert res.solver_iters is not None
    assert float(res.solver_residual) <= 1e-10
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        sf.analyze(model, wave, case, solver="pcg", pcg_maxiter=2)
        assert any("PCG did not converge" in str(x.message) for x in w)


def test_phase_batch_analytic_default_avoids_fd_emergence_spike():
    """The reference's dt=1e-3 FD acceleration produces an O(u/dt) inertia
    spike at phases where a quadrature point emerges within the FD window;
    densely sampled batches hit such phases, so analyze_phase_batch defaults
    to the analytic derivative (documented; 'fd' remains available for
    bit-level reference semantics)."""
    model = sf.default_3leg_jacket()
    wave = sf.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="fenton", N=18)
    case = sf.LoadCase(wave_dir_deg=38.0, current_dir_deg=38.0,
                       F_axial_kN=25100.0, F_shear_kN=2900.0,
                       custom_sw_tonnes=1100.0, sw_mode="custom")
    _, b_an = sf.analyze_phase_batch(model, wave, case, n_steps=72)
    _, b_fd = sf.analyze_phase_batch(model, wave, case, n_steps=72,
                                     accel="fd")
    u_an = float(np.asarray(b_an.utilization).max())
    u_fd = float(np.asarray(b_fd.utilization).max())
    assert u_an < 0.5                      # physical storm response
    assert u_fd > 2.0 * u_an               # the documented spike


def test_shallow_water_case_matches_reference(golden_shallow):
    """Golden parity in the shallow-water regime (k d ~ 0.9: the dispersion
    solve and the cosh/sinh depth profiles behave very differently from the
    deep default), sw_mode='none', zero current, westward heading."""
    g = golden_shallow
    model, res = _run(g)
    for key, ours in [("F_global", res.F_applied), ("U", res.U)]:
        ref = np.array(g["fem"][key])
        scale = np.abs(ref).max()
        np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-8,
                                   atol=1e-8 * scale)
    vm_ref = np.array([m["von_mises_max_MPa"]
                       for m in g["fem"]["internal_forces"]])
    np.testing.assert_allclose(np.asarray(res.von_mises), vm_ref, rtol=1e-8)


def _model_from_geometry(g):
    p = g["params"]
    geom = g["geometry"]
    return sf.build_model(
        nodes={k: tuple(v) for k, v in geom["nodes"].items()},
        members=geom["members"], fixed_nodes=geom["fixed"],
        top_nodes=geom["top"],
        leg_section=(p["D_leg"], p["t_leg"]),
        brace_section=(p["D_brace"], p["t_brace"]),
        rho_steel=p["rho_steel"])


def test_singular_lstsq_fallback_matches_reference(golden_singular):
    """GOLDEN parity of the least-squares fallback: the orphan node's six
    zero rows make K_ff exactly singular, so the recorded reference numbers
    come from its except-branch ``np.linalg.lstsq``
    (`JacketAnalysisGUI_v2.py:484-487`); our jit-compatible fallback must
    reproduce the same minimum-norm solution to 1e-8."""
    g = golden_singular
    p = g["params"]
    model = _model_from_geometry(g)
    wave = sf.airy_wave(p["H"], p["T"], p["d"], p["U_c"])
    res = sf.analyze(model, wave, _case_from_params(p), solver="lu",
                     lstsq_fallback=True)
    assert bool(jnp.isfinite(res.U).all())
    U_ref = np.array(g["fem"]["U"])
    scale = np.abs(U_ref).max()
    # 1e-6 (not the usual 1e-8): the solution of a rank-deficient least-
    # squares problem depends on the SVD implementation's tail handling —
    # LAPACK dgelsd (reference) vs jnp.linalg.lstsq agree to ~3e-8 here,
    # which is the inherent reproducibility of the fallback itself
    np.testing.assert_allclose(np.asarray(res.U), U_ref, rtol=1e-6,
                               atol=1e-6 * scale)
    # orphan DOFs: minimum-norm least squares leaves them at zero even
    # though self-weight loads the node (inconsistent equations)
    orphan = model.node_names.index("ZZ_ORPHAN")
    assert np.abs(U_ref.reshape(-1, 6)[orphan]).max() == 0.0
    vm_ref = np.array([m["von_mises_max_MPa"]
                       for m in g["fem"]["internal_forces"]])
    np.testing.assert_allclose(np.asarray(res.von_mises), vm_ref, rtol=1e-6,
                               atol=1e-6 * vm_ref.max())


def test_autogen_4leg_case_matches_reference(golden_autogen_4leg):
    """GOLDEN parity for a 4-leg tower whose member list was produced by the
    REFERENCE's own auto-generators (`JacketAnalysisGUI_v2.py:1224-1273`):
    (a) our ``models.autogen`` reproduces the exact generated member list
    (names, order, ring closure), (b) the full analysis matches to 1e-8."""
    from small_fem_solver_tpu.models import autogen

    g = golden_autogen_4leg
    p = g["params"]
    geom = g["geometry"]
    # (a) generator parity from the bare node dict
    ours = autogen.auto_generate_h_braces(
        geom["nodes"], autogen.auto_generate_legs(geom["nodes"], []))
    theirs = [{k: m[k] for k in ("name", "node1", "node2", "type")}
              for m in geom["members"]]
    assert ours == theirs
    # (b) full end-to-end parity
    model = _model_from_geometry(g)
    wave = sf.airy_wave(p["H"], p["T"], p["d"], p["U_c"])
    res = sf.analyze(model, wave, _case_from_params(p), solver="lu")
    for key, val in [("F_global", res.F_applied), ("U", res.U)]:
        ref = np.array(g["fem"][key])
        scale = np.abs(ref).max()
        np.testing.assert_allclose(np.asarray(val), ref, rtol=1e-8,
                                   atol=1e-8 * scale)
    vm_ref = np.array([m["von_mises_max_MPa"]
                       for m in g["fem"]["internal_forces"]])
    np.testing.assert_allclose(np.asarray(res.von_mises), vm_ref, rtol=1e-8)
    R_ref = np.array([g["fem"]["reactions"][n]
                      for n in model.fixed_node_names()])
    np.testing.assert_allclose(np.asarray(res.reactions), R_ref, rtol=1e-8,
                               atol=1e-8 * np.abs(R_ref).max())


def test_scan_is_informational_semantics(golden_variant):
    """The reference's phase scan is informational ONLY: the FEM solve uses
    the user-entered t_analysis, not the scan's critical phase
    (`JacketAnalysisGUI_v2.py:1909`, `:1863`).  Golden-checked both ways:
    our scan reproduces the reference's 36-step critical phase, and the FEM
    golden (already matched above) was recorded at t_analysis, which
    differs from that critical time."""
    g = golden_variant
    p = g["params"]
    model = sf.default_3leg_jacket()
    wave = sf.airy_wave(p["H"], p["T"], p["d"], p["U_c"])
    case = _case_from_params(p)
    D_m = model.sections.D_outer[model.sect_id] / 1000.0
    scan = sf.phase_scan(wave, model.coords, model.conn, D_m,
                         p["wave_dir"], p["current_dir"], p["Cd"], p["Cm"],
                         p["rho_water"], n_steps=36)
    ref_scan = g["phase_scan"]
    np.testing.assert_allclose(np.asarray(scan.total_kN), ref_scan["total_kN"],
                               rtol=1e-8)
    crit_t = float(scan.t[int(scan.critical_index)])
    assert crit_t == pytest.approx(ref_scan["critical_t"], abs=1e-12)
    # the recorded FEM state is NOT the critical-phase state
    assert abs(p["t_analysis"] - ref_scan["critical_t"]) > 0.1
    res_user = sf.analyze(model, wave, case, solver="lu")
    U_ref = np.array(g["fem"]["U"])
    np.testing.assert_allclose(np.asarray(res_user.U), U_ref, rtol=1e-8,
                               atol=1e-8 * np.abs(U_ref).max())
    # and solving AT the critical phase gives a materially different state
    import dataclasses
    case_crit = dataclasses.replace(case,
                                    t_analysis=float(ref_scan["critical_t"]))
    res_crit = sf.analyze(model, wave, case_crit, solver="lu")
    assert not np.allclose(np.asarray(res_crit.U), U_ref, rtol=1e-3)


def test_custom_tower_case_matches_reference(golden_custom_tower):
    """Golden parity for a NON-default structure (4-leg tower built from the
    same dict schema users feed build_model): covers user geometry, member
    auto-typing, 'calculated' self-weight and different sections."""
    g = golden_custom_tower
    p = g["params"]
    geom = g["geometry"]
    model = sf.build_model(
        nodes={k: tuple(v) for k, v in geom["nodes"].items()},
        members=geom["members"], fixed_nodes=geom["fixed"],
        top_nodes=geom["top"],
        leg_section=(p["D_leg"], p["t_leg"]),
        brace_section=(p["D_brace"], p["t_brace"]),
        rho_steel=p["rho_steel"])
    wave = sf.airy_wave(p["H"], p["T"], p["d"], p["U_c"])
    res = sf.analyze(model, wave, _case_from_params(p), solver="lu")
    for key, ours in [("F_global", res.F_applied), ("U", res.U)]:
        ref = np.array(g["fem"][key])
        scale = np.abs(ref).max()
        np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-8,
                                   atol=1e-8 * scale)
    ref_if = g["fem"]["internal_forces"]
    assert [m["member"] for m in ref_if] == list(model.member_names)
    vm_ref = np.array([m["von_mises_max_MPa"] for m in ref_if])
    np.testing.assert_allclose(np.asarray(res.von_mises), vm_ref, rtol=1e-8)
    R_ref = np.array([g["fem"]["reactions"][n]
                      for n in model.fixed_node_names()])
    np.testing.assert_allclose(np.asarray(res.reactions), R_ref, rtol=1e-8,
                               atol=1e-8 * np.abs(R_ref).max())
