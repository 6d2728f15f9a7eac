"""Response-spectrum analysis validation: spectrum shape, SDOF limit,
effective-mass identity, CQC correlation, direction rules."""
import jax.numpy as jnp
import numpy as np
import pytest

import small_fem_solver_tpu as sf
from small_fem_solver_tpu.models.model import build_model
from small_fem_solver_tpu.ops.seismic import (cqc_correlation, ec8_spectrum,
                                              table_spectrum)

G = 9.80665


def _cantilever(n_el=8, L=30.0, D=800.0, t=30.0):
    nodes = {f"N{i}": (0.0, 0.0, i * L / n_el) for i in range(n_el + 1)}
    members = [{"name": f"E{i}", "node1": f"N{i}", "node2": f"N{i+1}",
                "type": "leg"} for i in range(n_el)]
    return build_model(nodes, members, ["N0"], [f"N{n_el}"],
                       leg_section=(D, t), brace_section=(D, t))


def test_ec8_spectrum_shape():
    """Plateau value, corner continuity, long-period decay."""
    pga, zeta = 0.3, 0.05
    S, T_B, T_C, T_D = 1.2, 0.15, 0.5, 2.0  # ground B
    eta = 1.0  # zeta = 5% -> eta = 1
    plateau = 2.5 * eta * pga * G * S
    Sa = ec8_spectrum(jnp.array([0.0, T_B, 0.3, T_C, 1.0, T_D, 4.0]),
                      pga, "B", zeta)
    np.testing.assert_allclose(Sa[0], pga * G * S, rtol=1e-12)   # PGA anchor
    np.testing.assert_allclose(Sa[1], plateau, rtol=1e-12)
    np.testing.assert_allclose(Sa[2], plateau, rtol=1e-12)
    np.testing.assert_allclose(Sa[3], plateau, rtol=1e-12)
    np.testing.assert_allclose(Sa[4], plateau * T_C / 1.0, rtol=1e-12)
    np.testing.assert_allclose(Sa[5], plateau * T_C / T_D, rtol=1e-12)
    np.testing.assert_allclose(Sa[6], plateau * T_C * T_D / 16.0, rtol=1e-12)
    # damping correction bounded below at 0.55
    hi = ec8_spectrum(jnp.array([0.3]), pga, "B", 0.50)
    assert float(hi[0]) == pytest.approx(plateau * 0.55, rel=1e-6)
    with pytest.raises(ValueError):
        ec8_spectrum(jnp.array([1.0]), pga, "Z")


def test_table_spectrum_interp():
    T_tab = jnp.array([0.1, 1.0, 2.0])
    Sa_tab = jnp.array([2.0, 4.0, 1.0])
    Sa = table_spectrum(jnp.array([0.05, 0.55, 3.0]), T_tab, Sa_tab)
    np.testing.assert_allclose(Sa, [2.0, 3.0, 1.0], rtol=1e-12)


def test_cqc_correlation_limits():
    """Identical modes fully correlated; separated modes near-independent."""
    rho = cqc_correlation(jnp.array([2.0, 2.0, 6.0]), zeta=0.02)
    np.testing.assert_allclose(np.diag(rho), 1.0, rtol=1e-12)
    np.testing.assert_allclose(rho[0, 1], 1.0, rtol=1e-12)
    assert float(rho[0, 2]) < 0.01
    np.testing.assert_allclose(np.asarray(rho), np.asarray(rho).T)


def test_sdof_peak_displacement():
    """Tip-mass cantilever: the first bending pair is x/y DEGENERATE (the
    eigenvectors are an arbitrary rotation of the pair), so combine both
    modes — CQC with rho = 1 across an equal-frequency pair reduces to the
    basis-invariant |sum_i Gamma_i phi_i| Sa(T1)/omega1^2, and the
    tip-mass-dominated column is SDOF-like (sum Gamma phi_tip ~ 1)."""
    model = _cantilever()
    res = sf.response_spectrum(model, 0.2, ground="A", zeta=0.05,
                               topside_mass_t=500.0, n_modes=2,
                               directions=((1.0, 0.0, 0.0),))
    tip_x = 6 * (model.coords.shape[0] - 1)
    gp = float(sum(res.participation[0, i] * res.mode_shapes[i, tip_x]
                   for i in range(2)))
    omega = 2.0 * np.pi / float(res.periods_s[0])
    Sa = float(ec8_spectrum(res.periods_s[0], 0.2, "A", 0.05))
    expected = abs(gp) * Sa * 1e3 / omega**2
    np.testing.assert_allclose(float(res.U_peak[tip_x]), expected, rtol=1e-6)
    # SDOF-ness of the tip-mass model
    assert abs(gp) == pytest.approx(1.0, rel=0.05)
    # base shear: fully correlated equal-frequency pair -> (G1^2+G2^2) Sa
    g2 = float(jnp.sum(res.participation[0] ** 2))
    np.testing.assert_allclose(float(res.base_shear_kN[0]),
                               g2 * Sa, rtol=1e-6)


def test_effective_mass_identity():
    """With ALL modes kept, sum Gamma_i^2 = b^T M_ff^{-1} b per direction,
    b = (M iota)|_free — the completeness identity for the consistent-mass
    participation Gamma_i = phi_i^T M iota (iota spans fixed DOFs too)."""
    from small_fem_solver_tpu.ops.dynamics import _build_km

    model = _cantilever(n_el=4)
    n_free = 6 * 4
    res = sf.response_spectrum(model, 0.2, n_modes=n_free,
                               directions=((1, 0, 0), (0, 0, 1)))
    K, M, free, _ = _build_km(model, 210000.0, 0.3, 0.0)
    M = np.asarray(M)
    free = np.asarray(free)
    M_ff = M[np.ix_(free, free)]
    for d, vec in enumerate([(1, 0, 0), (0, 0, 1)]):
        r = np.zeros(model.n_dof)
        for c in range(3):
            r[c::6] = vec[c]
        b = (M @ r)[free]
        np.testing.assert_allclose(
            float(jnp.sum(res.effective_mass_t[d])),
            b @ np.linalg.solve(M_ff, b), rtol=1e-8)


def test_direction_rules_and_combination():
    """SRSS and 100/40/40 both dominate each single-direction result; SRSS
    over modes >= ... sanity on the default jacket."""
    model = sf.default_3leg_jacket()
    kw = dict(ground="B", zeta=0.05, n_modes=8, topside_mass_t=1100.0)
    rx = sf.response_spectrum(model, 0.2, directions=((1, 0, 0),), **kw)
    ry = sf.response_spectrum(model, 0.2, directions=((0, 1, 0),), **kw)
    srss = sf.response_spectrum(model, 0.2, dir_rule="srss", **kw)
    r44 = sf.response_spectrum(model, 0.2, dir_rule="100-40-40", **kw)
    single_max = np.maximum(np.asarray(rx.U_peak), np.asarray(ry.U_peak))
    assert np.all(np.asarray(srss.U_peak) >= single_max - 1e-9)
    assert np.all(np.asarray(r44.U_peak) >= single_max - 1e-9)
    # expected SRSS identity per DOF
    np.testing.assert_allclose(
        np.asarray(srss.U_peak),
        np.sqrt(np.asarray(rx.U_peak) ** 2 + np.asarray(ry.U_peak) ** 2),
        rtol=1e-9, atol=1e-12)
    # SRSS modal combination is bounded above by CQC for positively
    # correlated same-sign contributions -- just check both run and differ
    srss_modes = sf.response_spectrum(model, 0.2, combination="srss", **kw)
    assert np.all(np.isfinite(np.asarray(srss_modes.U_peak)))
    with pytest.raises(ValueError):
        sf.response_spectrum(model, 0.2, combination="abs")
    with pytest.raises(ValueError):
        sf.response_spectrum(model, 0.2, dir_rule="cqc")


def test_jacket_seismic_smoke():
    """Default jacket + deck mass + springs + added mass: finite demands,
    vertical direction picks the vertical spectrum."""
    model = sf.default_3leg_jacket()
    res = sf.response_spectrum(
        model, 0.25, ground="C", zeta=0.05, n_modes=12,
        topside_mass_t=1100.0, added_mass_Ca=1.0,
        support_stiffness=[2e6, 2e6, 5e6, 1e12, 1e12, 1e12],
        directions=((1, 0, 0), (0, 1, 0), (0, 0, 1)))
    assert np.all(np.isfinite(np.asarray(res.U_peak)))
    assert float(res.max_displacement_mm) > 0.01
    assert np.all(np.asarray(res.utilization) >= 0)
    assert np.all(np.asarray(res.base_shear_kN) > 0)
    # vertical spectrum (0.9 a_g, S=1) differs from the ground-C horizontal
    assert not np.allclose(np.asarray(res.Sa_ms2[2]),
                           np.asarray(res.Sa_ms2[0]))
    # site-specific table override applies to every direction
    tab = sf.response_spectrum(
        model, 0.25, n_modes=6, topside_mass_t=1100.0,
        spectrum=(jnp.array([0.0, 10.0]), jnp.array([3.0, 3.0])))
    np.testing.assert_allclose(np.asarray(tab.Sa_ms2), 3.0, rtol=1e-12)


def test_condensed_matches_dense_when_exact():
    """Craig-Bampton with ALL interior modes retained is an exact change of
    basis: the condensed spectrum analysis must match the dense analysis of
    the refined mesh (the degenerate-pair ambiguity cancels in CQC because
    the fully correlated pair contributes resp(sum Gamma_i phi_i), which is
    rotation-invariant)."""
    model = sf.default_3leg_jacket()
    n_seg = 3
    refined = sf.refine_model(model, n_seg)
    kw = dict(ground="B", zeta=0.05, n_modes=6, topside_mass_t=1100.0,
              directions=((1, 0, 0), (0, 1, 0)))
    dense = sf.response_spectrum(refined, 0.2, **kw)
    cond = sf.response_spectrum_condensed(
        model, refined, n_seg, 0.2, n_chain_modes=6 * (n_seg - 1), **kw)
    np.testing.assert_allclose(np.asarray(cond.periods_s),
                               np.asarray(dense.periods_s), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(cond.base_shear_kN),
                               np.asarray(dense.base_shear_kN), rtol=1e-7)
    np.testing.assert_allclose(np.asarray(cond.U_peak),
                               np.asarray(dense.U_peak),
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(np.asarray(cond.utilization),
                               np.asarray(dense.utilization),
                               rtol=1e-5, atol=1e-10)
    np.testing.assert_allclose(float(cond.total_mass_t),
                               float(dense.total_mass_t), rtol=1e-12)


def test_cli_seismic(capsys, tmp_path):
    from small_fem_solver_tpu.cli import main
    main(["seismic", "--pga-g", "0.2", "--ground", "B", "--n-modes", "6",
          "--vertical"])
    out = capsys.readouterr().out
    assert "base shear x" in out and "base shear z" in out
    assert "captured modal mass" in out
    # site-specific spectrum file
    f = tmp_path / "spec.csv"
    f.write_text("0.0,2.5\n1.0,5.0\n4.0,1.0\n")
    main(["seismic", "--spectrum-file", str(f), "--n-modes", "4",
          "--dir-rule", "100-40-40", "--combination", "srss"])
    out = capsys.readouterr().out
    assert "site-specific spectrum: 3 (T, Sa) points" in out


def test_ground_motion_time_history_sdof_identity():
    """Harmonic ground acceleration on the tip-mass column: the steady
    relative displacement matches the SDOF transfer function
    u = Gamma*phi * a0 / sqrt((w^2 - wg^2)^2 + (2 zeta w wg)^2)."""
    from small_fem_solver_tpu.ops.dynamics import (
        modal_analysis, transient_response_condensed)

    model = _cantilever(n_el=6)
    n_seg = 4
    refined = sf.refine_model(model, n_seg)
    topside = 400.0
    modal = sf.modal_analysis(model, n_modes=2, topside_mass_t=topside)
    w1 = float(modal.omega[0])
    zeta = 0.03
    r = 0.5                                    # drive at half resonance
    wg = r * w1
    a0 = 0.8                                   # m/s^2
    dt = 2 * np.pi / wg / 96
    n_steps = int(30 * 2 * np.pi / wg / dt)
    ts = np.arange(n_steps) * dt
    ag = a0 * np.sin(wg * ts)
    case = sf.LoadCase(sw_mode="none")
    res = transient_response_condensed(
        model, refined, n_seg, None, case, dt, n_steps,
        damping_ratio=zeta, topside_mass_t=topside, zero_loads=True,
        ground_accel=ag, ground_dir=(1.0, 0.0, 0.0))
    tip_x = 6 * model.node_index(model.node_names[-1])
    hist = np.asarray(res.U_time[:, tip_x])
    amp = 0.5 * (hist[n_steps // 2:].max() - hist[n_steps // 2:].min())
    # modal participation of the x-bending pair at the tip
    spec = sf.response_spectrum(model, 0.2, n_modes=2,
                                topside_mass_t=topside,
                                directions=((1.0, 0.0, 0.0),))
    gp = float(sum(spec.participation[0, i] * spec.mode_shapes[i, tip_x]
                   for i in range(2)))
    expected = abs(gp) * a0 * 1e3 / np.sqrt(
        (w1**2 - wg**2) ** 2 + (2 * zeta * w1 * wg) ** 2)
    np.testing.assert_allclose(amp, expected, rtol=0.03)
    # wrong sample count raises
    with pytest.raises(ValueError, match="samples"):
        transient_response_condensed(
            model, refined, n_seg, None, case, dt, n_steps,
            zero_loads=True, topside_mass_t=topside, ground_accel=ag[:-5])


def test_response_spectrum_f32_path():
    """f32 (fast-path) response spectrum tracks f64 within mixed-
    precision eigensolve tolerance."""
    model64 = sf.default_3leg_jacket()
    model32 = sf.default_3leg_jacket(dtype=jnp.float32)
    kw = dict(ground="B", zeta=0.05, n_modes=6, topside_mass_t=1100.0)
    r64 = sf.response_spectrum(model64, 0.2, **kw)
    r32 = sf.response_spectrum(model32, 0.2, **kw)
    np.testing.assert_allclose(np.asarray(r32.periods_s),
                               np.asarray(r64.periods_s), rtol=2e-3)
    np.testing.assert_allclose(np.asarray(r32.base_shear_kN),
                               np.asarray(r64.base_shear_kN), rtol=5e-3)
    np.testing.assert_allclose(float(r32.max_displacement_mm),
                               float(r64.max_displacement_mm), rtol=1e-2)
