"""Pushover / RSR: determinate-truss capacity closed form, redundancy on
the jacket, elastic-range linearity."""
import numpy as np
import pytest

import small_fem_solver_tpu as sf
from small_fem_solver_tpu.models.model import build_model
from small_fem_solver_tpu.ops.pushover import pushover


def _v_frame():
    """Pin-based V-truss + a feather-soft keeper column (rotational
    stability for the apex): statically determinate in axial, so first
    yield IS the axial capacity and the post-yield tangent collapses to
    the keeper's."""
    h, b = 6.0, 4.0
    nodes = {"L": (-b, 0.0, 0.0), "R": (b, 0.0, 0.0),
             "K": (0.0, 0.0, 0.0), "TOP": (0.0, 0.0, h)}
    members = [
        {"name": "bl", "node1": "L", "node2": "TOP", "type": "brace",
         "release": "pinned"},
        {"name": "br", "node1": "R", "node2": "TOP", "type": "brace",
         "release": "pinned"},
        {"name": "keeper", "node1": "K", "node2": "TOP", "type": "leg"},
    ]
    # stocky braces: Euler >> A fy so both capacities are A fy
    return build_model(nodes, members, ["L", "R", "K"], ["TOP"],
                       leg_section=(60.0, 2.0), brace_section=(400.0, 20.0))


def test_v_truss_capacity_closed_form():
    model = _v_frame()
    wave = sf.airy_wave(1e-9, 9.4, 50.0)   # no hydro: lateral via topside
    F0 = 5000.0                             # kN lateral unit load
    case = sf.LoadCase(sw_mode="none", F_shear_kN=F0, wave_dir_deg=90.0,
                       current_dir_deg=90.0, t_analysis=0.0)
    # wave_dir 90 -> theta = 0 -> shear along +x (the V plane)
    res = pushover(model, wave, case, lambda_max=3.0, n_lambda=31,
                   n_iter=120)
    A = float(model.sections.Ax[1])         # brace section
    sin_th = 4.0 / np.hypot(4.0, 6.0)
    lam_c = 2.0 * sin_th * (A * 355.0) / (F0 * 1e3)
    assert 1.0 < lam_c < 2.5                # the grid brackets it
    fy_lam = float(res.first_yield_lambda)
    assert fy_lam == pytest.approx(lam_c, rel=0.08)
    # determinate: practical collapse (slope blow-up) right at capacity
    assert float(res.rsr) == pytest.approx(lam_c, abs=0.25)
    # beyond capacity only the feather keeper resists: displacement jumps
    lam = np.asarray(res.lambdas)
    disp = np.asarray(res.max_displacement_mm)
    conv = np.asarray(res.converged)
    below = disp[(lam < 0.9 * lam_c) & (lam > 0) & conv]
    above = disp[(lam > 1.2 * lam_c) & conv]
    if len(above):
        assert above.min() > 10.0 * below.max()
    # elastic range: axial forces scale linearly with lambda
    ax = np.asarray(res.axial_N)
    i1, i2 = 2, 4
    assert lam[i2] < 0.9 * lam_c
    np.testing.assert_allclose(ax[i2, :2], ax[i1, :2] * lam[i2] / lam[i1],
                               rtol=1e-6)


def test_jacket_pushover_redundancy():
    """The default jacket is redundant: the RSR exceeds first yield by a
    margin, the yielded set grows with lambda, the curve is monotone, and
    the design state (lambda = 1) is fully elastic."""
    model = sf.default_3leg_jacket()
    wave = sf.stokes_wave(17.038, 9.4, 50.0, 1.7, order=5)
    case = sf.LoadCase(wave_dir_deg=38.0, current_dir_deg=38.0,
                       F_axial_kN=25100.0, F_shear_kN=2900.0,
                       custom_sw_tonnes=1100.0, sw_mode="custom",
                       t_analysis=0.34)
    res = pushover(model, wave, case, lambda_max=18.0, n_lambda=19,
                   n_iter=100)
    lam = np.asarray(res.lambdas)
    conv = np.asarray(res.converged)
    disp = np.asarray(res.max_displacement_mm)
    ny = np.asarray(res.n_yielded)
    assert conv[0]                       # gravity-only state stable
    fy_lam = float(res.first_yield_lambda)
    rsr = float(res.rsr)
    assert np.isfinite(fy_lam)
    assert rsr > 1.15 * fy_lam           # redundancy margin beyond yield
    assert rsr < lam[-1]                 # practical collapse detected
    # monotone growth where converged
    ok = conv & np.isfinite(disp)
    assert np.all(np.diff(disp[ok]) > -1e-6)
    assert np.all(np.diff(ny[ok]) >= 0)
    # the design state (lambda = 1) is comfortably stable and elastic
    i1 = int(np.argmin(np.abs(lam - 1.0)))
    assert conv[i1] and ny[i1] == 0
    assert 0 < float(res.max_util[i1]) < 1.0


def test_pushover_rose_symmetry():
    """First-yield factors respect the jacket's 3-fold symmetry: headings
    120 degrees apart give the same first-yield lambda (the topside shear
    and the wave rotate together; gravity is isotropic)."""
    from small_fem_solver_tpu.ops.pushover import pushover_rose

    model = sf.default_3leg_jacket()
    wave = sf.airy_wave(17.038, 9.4, 50.0, 1.7)
    case = sf.LoadCase(wave_dir_deg=0.0, current_dir_deg=0.0,
                       F_axial_kN=25100.0, F_shear_kN=2900.0,
                       custom_sw_tonnes=1100.0, sw_mode="custom")
    kw = dict(lambda_max=16.0, n_lambda=9, n_iter=60)
    headings, rsr, fy, _ = pushover_rose(
        model, wave, case, [10.0, 130.0, 250.0, 70.0], **kw)
    # 3-fold symmetry: 10 / 130 / 250 are equivalent headings
    np.testing.assert_allclose(fy[1], fy[0], rtol=1e-6)
    np.testing.assert_allclose(fy[2], fy[0], rtol=1e-6)
    np.testing.assert_allclose(rsr[1], rsr[0], rtol=1e-9)
    np.testing.assert_allclose(rsr[2], rsr[0], rtol=1e-9)
    # a non-equivalent heading is allowed to differ (and the min governs)
    assert np.isfinite(rsr).all() and rsr.min() > 1.0


def test_pushover_rose_sharded_matches_host():
    """mesh= shards the heading axis: the sharded GSPMD rose reproduces
    the host-loop rose exactly (8 virtual devices)."""
    import jax
    from jax.sharding import Mesh

    from small_fem_solver_tpu.ops.pushover import pushover_rose

    model = sf.default_3leg_jacket()
    wave = sf.airy_wave(17.038, 9.4, 50.0, 1.7)
    case = sf.LoadCase(wave_dir_deg=0.0, current_dir_deg=0.0,
                       F_axial_kN=25100.0, F_shear_kN=2900.0,
                       custom_sw_tonnes=1100.0, sw_mode="custom")
    headings = [0.0, 45.0, 90.0, 135.0, 180.0, 225.0, 270.0, 315.0]
    kw = dict(lambda_max=14.0, n_lambda=8, n_iter=50)
    mesh = Mesh(np.array(jax.devices()[:8]), ("headings",))
    _, rsr_sh, fy_sh, _ = pushover_rose(model, wave, case, headings,
                                        mesh=mesh, **kw)
    _, rsr_h, fy_h, _ = pushover_rose(model, wave, case, headings, **kw)
    np.testing.assert_allclose(rsr_sh, rsr_h, rtol=1e-12)
    np.testing.assert_allclose(fy_sh, fy_h, rtol=1e-12)


def test_pushover_f32_path():
    """The fast-path dtype: the f32 pushover stays finite and lands
    on the f64 curve within f32 conditioning tolerance."""
    import jax.numpy as jnp

    model64 = sf.default_3leg_jacket()
    model32 = sf.default_3leg_jacket(dtype=jnp.float32)
    wave64 = sf.airy_wave(17.038, 9.4, 50.0, 1.7)
    wave32 = sf.airy_wave(17.038, 9.4, 50.0, 1.7, dtype=jnp.float32)
    case = sf.LoadCase(wave_dir_deg=38.0, current_dir_deg=38.0,
                       F_axial_kN=25100.0, F_shear_kN=2900.0,
                       custom_sw_tonnes=1100.0, sw_mode="custom")
    kw = dict(lambda_max=12.0, n_lambda=7, n_iter=60)
    r64 = pushover(model64, wave64, case, **kw)
    r32 = pushover(model32, wave32, case, **kw)
    assert np.asarray(r32.converged)[:5].all()
    np.testing.assert_allclose(np.asarray(r32.max_displacement_mm)[:5],
                               np.asarray(r64.max_displacement_mm)[:5],
                               rtol=2e-3)
    assert float(r32.first_yield_lambda) == pytest.approx(
        float(r64.first_yield_lambda), abs=2.01)  # grid-resolution match
