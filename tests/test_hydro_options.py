"""Wheeler stretching and power-law current profiles (beyond-reference
hydrodynamic options; defaults preserve exact reference semantics)."""
import jax.numpy as jnp
import numpy as np
import pytest

import small_fem_solver_tpu as sf
from small_fem_solver_tpu.ops.morison import morison_loads, morison_phase_batch
from small_fem_solver_tpu.ops.waves import _uw_raw, kinematics, surface_elevation

REMOVED_MODE = "pallas"   # the fused-kernel mode, now an unknown mode


def _wave():
    return sf.make_wave(12.0, 9.4, 50.0, U_c=0.0, model="stokes", N=5)


def test_wheeler_maps_surface_to_mwl():
    """At the instantaneous surface, Wheeler-stretched kinematics equal the
    unstretched profile evaluated at z = 0 (the defining property)."""
    wave = sf.airy_wave(8.0, 9.4, 50.0)     # no z-clamp -> exact check
    x = jnp.linspace(0.0, 140.0, 7)
    eta = surface_elevation(wave, x, 0.0)
    kin = kinematics(wave, x, eta - 1e-9, 0.0, accel="analytic",
                     stretching="wheeler")
    u0, w0 = _uw_raw(wave, x, jnp.zeros_like(x), 0.0)
    np.testing.assert_allclose(np.asarray(kin.u), np.asarray(u0), rtol=1e-6)


def test_wheeler_reduces_crest_kinematics():
    """Under the crest, Wheeler evaluation heights are lower, so horizontal
    velocity is reduced vs the unstretched (clamped) profile."""
    wave = _wave()
    x = jnp.zeros(5)                        # crest at x = 0, t = 0
    eta = float(surface_elevation(wave, 0.0, 0.0))
    assert eta > 2.0
    z = jnp.linspace(0.1, eta - 0.1, 5)     # above MWL, below crest
    k_n = kinematics(wave, x, z, 0.0, accel="analytic")
    k_w = kinematics(wave, x, z, 0.0, accel="analytic",
                     stretching="wheeler")
    assert np.all(np.asarray(k_w.u) < np.asarray(k_n.u))
    assert np.all(np.asarray(k_w.u) > 0)


def test_wheeler_noop_below_trough_is_small():
    """Deep below the surface the stretch is a small correction, not a
    discontinuity."""
    wave = _wave()
    k_n = kinematics(wave, 10.0, -40.0, 1.0, accel="analytic")
    k_w = kinematics(wave, 10.0, -40.0, 1.0, accel="analytic",
                     stretching="wheeler")
    assert abs(float(k_w.u) - float(k_n.u)) < 0.15 * abs(float(k_n.u)) + 1e-9


def _model_and_args(alpha, U_c=1.7, H=9.5):
    model = sf.default_3leg_jacket()
    wave = sf.make_wave(H, 9.4, 50.0, U_c=U_c, model="stokes", N=5)
    D_m = model.sections.D_outer[model.sect_id] / 1000.0
    return model, wave, D_m


def test_current_profile_alpha_zero_is_uniform():
    model, wave, D_m = _model_and_args(0.0)
    a = morison_loads(wave, model.coords, model.conn, D_m, 38.0, 120.0,
                      0.7, 2.0, 1025.0, 1.0, current_alpha=None)
    b = morison_loads(wave, model.coords, model.conn, D_m, 38.0, 120.0,
                      0.7, 2.0, 1025.0, 1.0, current_alpha=0.0)
    np.testing.assert_allclose(np.asarray(b.nodal_forces),
                               np.asarray(a.nodal_forces), rtol=1e-12)


def test_current_profile_reduces_drag():
    """A 1/7-power profile carries less momentum at depth than a uniform
    current of the same surface speed -> smaller total drag."""
    model, wave, D_m = _model_and_args(None, U_c=1.7, H=0.05)
    uni = morison_loads(wave, model.coords, model.conn, D_m, 38.0, 38.0,
                        0.7, 2.0, 1025.0, 0.0)
    pro = morison_loads(wave, model.coords, model.conn, D_m, 38.0, 38.0,
                        0.7, 2.0, 1025.0, 0.0, current_alpha=1.0 / 7.0)
    d_u = np.linalg.norm(np.asarray(uni.total_drag))
    d_p = np.linalg.norm(np.asarray(pro.total_drag))
    assert 0.5 * d_u < d_p < 0.95 * d_u


def test_current_profile_separable_matches_pointwise():
    model, wave, D_m = _model_and_args(None)
    ts = jnp.arange(6) * 9.4 / 6
    mb = morison_phase_batch(wave, model.coords, model.conn, D_m, 38.0,
                             120.0, 0.7, 2.0, 1025.0, ts,
                             current_alpha=1.0 / 7.0)
    for i, t in enumerate(np.asarray(ts)):
        r = morison_loads(wave, model.coords, model.conn, D_m, 38.0, 120.0,
                          0.7, 2.0, 1025.0, float(t), accel="analytic",
                          current_alpha=1.0 / 7.0)
        scale = np.abs(np.asarray(r.nodal_forces)).max()
        # the separable path skips the raschii z-clamp the pointwise path
        # replicates, a documented ~3e-5 difference in the 1 cm band below
        # the surface (same magnitude with or without the profile)
        np.testing.assert_allclose(np.asarray(mb.nodal_forces[i]),
                                   np.asarray(r.nodal_forces),
                                   rtol=1e-4, atol=1e-4 * scale)


def test_analyze_and_scan_accept_hydro_options():
    model = sf.default_3leg_jacket()
    wave = sf.make_wave(9.5, 9.4, 50.0, U_c=1.2, model="stokes", N=5)
    case = sf.LoadCase(wave_dir_deg=38.0, current_dir_deg=38.0,
                       F_axial_kN=25100.0, F_shear_kN=2900.0,
                       custom_sw_tonnes=1100.0, sw_mode="custom")
    res = sf.analyze(model, wave, case, solver="chol", accel="analytic",
                     stretching="wheeler", current_alpha=1.0 / 7.0)
    assert np.isfinite(np.asarray(res.U)).all()
    base = sf.analyze(model, wave, case, solver="chol", accel="analytic")
    # the options change the loading (and therefore the answer)
    assert not np.allclose(np.asarray(res.U), np.asarray(base.U))
    coarse = model
    refined = sf.refine_model(coarse, 2)
    scan = sf.phase_scan_condensed(coarse, refined, 2, wave, case, n_steps=3,
                                   kinematics="pointwise", accel="analytic",
                                   stretching="wheeler",
                                   current_alpha=1.0 / 7.0)
    assert np.isfinite(np.asarray(scan.U)).all()
    # an unknown kinematics mode is refused, with or without stretching
    with pytest.raises(ValueError, match="unknown kinematics mode"):
        sf.phase_scan_condensed(coarse, refined, 2, wave, case, n_steps=3,
                                kinematics=REMOVED_MODE, stretching="wheeler")


def test_wheeler_separable_matches_pointwise():
    """Wheeler on the separable path (2nd-order Taylor frozen stretch) vs
    the exact pointwise Wheeler evaluation, Airy default storm.

    The Taylor error is O((k dz)^3/6) per mode (k dz ~ 0.39 at the crest of
    the H=17 storm) at the worst near-crest quadrature POINT; integrated
    member loads agree to ~1e-2 and the structural response tighter.  This
    is the published measured bound — Wheeler +
    linear (Airy/spectral) waves is the standard engineering combination
    (API RP 2A); for high-order Stokes/Fenton crest harmonics use the exact
    pointwise path."""
    coarse = sf.default_3leg_jacket()
    refined = sf.refine_model(coarse, 2)
    wave = sf.airy_wave(17.038, 9.4, 50.0, 1.7)   # clamp-free: exact check
    case = sf.LoadCase(wave_dir_deg=38.0, current_dir_deg=38.0,
                       F_axial_kN=25100.0, F_shear_kN=2900.0,
                       custom_sw_tonnes=1100.0, sw_mode="custom")
    sp = sf.phase_scan_condensed(coarse, refined, 2, wave, case, n_steps=12,
                                 kinematics="separable", stretching="wheeler")
    pw = sf.phase_scan_condensed(coarse, refined, 2, wave, case, n_steps=12,
                                 kinematics="pointwise", accel="analytic",
                                 stretching="wheeler")
    base = sf.phase_scan_condensed(coarse, refined, 2, wave, case,
                                   n_steps=12, kinematics="separable")
    U_sp, U_pw = np.asarray(sp.U), np.asarray(pw.U)
    scale = np.abs(U_pw).max()
    # measured ~2e-3; 1e-2 is the published bound
    assert np.abs(U_sp - U_pw).max() / scale < 1e-2
    np.testing.assert_allclose(float(sp.utilization.max()),
                               float(pw.utilization.max()), rtol=1e-2)
    # and the stretch actually does something (reduces crest kinematics
    # loads vs the unstretched separable path)
    assert not np.allclose(U_sp, np.asarray(base.U), rtol=1e-4)
    assert float(sp.utilization.max()) < float(base.utilization.max())


def test_marine_growth_zero_preserves_reference_numbers():
    import dataclasses

    model = sf.default_3leg_jacket()
    wave = sf.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="stokes", N=5)
    case = sf.LoadCase(wave_dir_deg=38.0, current_dir_deg=38.0,
                       F_axial_kN=25100.0, F_shear_kN=2900.0,
                       custom_sw_tonnes=1100.0, sw_mode="custom")
    base = sf.analyze(model, wave, case)
    zero = sf.analyze(model, wave,
                      dataclasses.replace(case, marine_growth_mm=0.0))
    np.testing.assert_array_equal(np.asarray(base.U), np.asarray(zero.U))


def test_marine_growth_scales_morison_loads():
    """Growth adds 2t to the hydrodynamic diameter: drag scales ~D,
    inertia ~D^2, and the structural solve sees only the larger loads."""
    import dataclasses

    from small_fem_solver_tpu.ops.morison import morison_loads

    model = sf.default_3leg_jacket()
    wave = sf.make_wave(10.0, 9.4, 50.0, model="stokes", N=5)
    case = sf.LoadCase(wave_dir_deg=0.0, current_dir_deg=0.0, sw_mode="none")
    t_g = 100.0                                     # mm of growth
    r0 = sf.analyze(model, wave, case)
    r1 = sf.analyze(model, wave,
                    dataclasses.replace(case, marine_growth_mm=t_g))
    # per member the scaling is EXACT: drag ~ D, inertia ~ D^2 at the
    # same kinematics (growth does not move the quadrature points)
    D = np.asarray(model.sections.D_outer)[np.asarray(model.sect_id)]
    f = (D + 2 * t_g) / D                                  # [M]
    d0 = np.linalg.norm(np.asarray(r0.morison.member_drag), axis=1)
    d1 = np.linalg.norm(np.asarray(r1.morison.member_drag), axis=1)
    i0 = np.linalg.norm(np.asarray(r0.morison.member_inertia), axis=1)
    i1 = np.linalg.norm(np.asarray(r1.morison.member_inertia), axis=1)
    wet = d0 > 1e-6
    np.testing.assert_allclose(d1[wet] / d0[wet], f[wet], rtol=1e-9)
    np.testing.assert_allclose(i1[wet] / i0[wet], f[wet] ** 2, rtol=1e-9)
    assert float(r1.max_displacement_mm) > float(r0.max_displacement_mm)


def test_marine_growth_on_condensed_and_batched_paths():
    import dataclasses

    from small_fem_solver_tpu.parallel.sweep import (make_case_batch,
                                                     make_wave_batch)

    model = sf.default_3leg_jacket()
    wave = sf.make_wave(10.0, 9.4, 50.0, model="stokes", N=5)
    case = sf.LoadCase(wave_dir_deg=0.0, current_dir_deg=0.0, sw_mode="none",
                       marine_growth_mm=75.0)
    n_seg = 3
    refined = sf.refine_model(model, n_seg)
    dense = sf.analyze(refined, wave, case, accel="analytic")
    cond = sf.analyze_condensed(model, refined, n_seg, wave, case)
    np.testing.assert_allclose(np.asarray(cond.U), np.asarray(dense.U),
                               rtol=1e-8, atol=1e-12)
    # per-case growth in an envelope batch
    waves = make_wave_batch([8.0, 8.0], 9.4, 50.0, model="stokes", N=5,
                            n_modes=8, dtype=np.float64)
    cases = make_case_batch(case, t_analysis=np.zeros(2),
                            marine_growth_mm=np.array([0.0, 150.0]))
    env = sf.design_envelope(model, waves, cases, n_steps=4)
    u = np.asarray(env.max_util_per_case)
    assert u[1] > u[0]                    # more growth -> more load


def test_wheeler_on_envelope_paths():
    """stretching='wheeler' flows through both envelope paths and matches
    the per-case prepared scan."""
    from small_fem_solver_tpu.parallel.sweep import (make_case_batch,
                                                     make_wave_batch)
    coarse = sf.default_3leg_jacket()
    n_seg = 2
    refined = sf.refine_model(coarse, n_seg)
    Hs = [8.0, 14.0]
    waves = make_wave_batch(Hs, 9.4, 50.0, U_c=1.0, model="airy",
                            n_modes=4, dtype=jnp.float64)
    base = sf.LoadCase(wave_dir_deg=38.0, current_dir_deg=38.0,
                       F_axial_kN=25100.0, F_shear_kN=2900.0,
                       custom_sw_tonnes=1100.0, sw_mode="custom")
    cases = make_case_batch(base, t_analysis=jnp.zeros(2))
    env = sf.design_envelope_condensed(coarse, refined, n_seg, waves, cases,
                                       n_steps=4, solve_dtype=jnp.float64,
                                       stretching="wheeler")
    env0 = sf.design_envelope_condensed(coarse, refined, n_seg, waves,
                                        cases, n_steps=4,
                                        solve_dtype=jnp.float64)
    assert not np.allclose(np.asarray(env.max_util_per_case),
                           np.asarray(env0.max_util_per_case), rtol=1e-6)
    for c, H in enumerate(Hs):
        w = sf.airy_wave(H, 9.4, 50.0, 1.0)
        scan = sf.phase_scan_condensed(coarse, refined, n_seg, w, base,
                                       n_steps=4, kinematics="separable",
                                       stretching="wheeler")
        np.testing.assert_allclose(float(env.max_util_per_case[c]),
                                   float(scan.utilization.max()), rtol=1e-9)
    envd = sf.design_envelope(coarse, waves, cases, n_steps=4,
                              stretching="wheeler")
    assert np.isfinite(np.asarray(envd.max_util_per_case)).all()
    with pytest.raises(ValueError, match="unknown kinematics mode"):
        sf.design_envelope_condensed(coarse, refined, n_seg, waves, cases,
                                     n_steps=4, kinematics=REMOVED_MODE,
                                     stretching="wheeler")
