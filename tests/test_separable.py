"""The separable phase-batch Morison path (the kinematics of every fast
scan and envelope) against the pointwise float64 oracle, case by case."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import small_fem_solver_tpu as sf
from small_fem_solver_tpu.ops.morison import morison_loads, morison_phase_batch


def _errors(model, wave, wave_dir, current_dir, ts, kw=None, oracle_kw=None):
    """(max nodal error / max nodal force, max total error / max total)
    over the phases ``ts``: the separable path with options ``kw`` against
    the pointwise path with ``oracle_kw`` (default: the same options)."""
    kw = kw or {}
    oracle_kw = kw if oracle_kw is None else oracle_kw
    D_m = model.sections.D_outer[model.sect_id] / 1000.0
    mb = morison_phase_batch(wave, model.coords, model.conn, D_m, wave_dir,
                             current_dir, 0.7, 2.0, 1025.0, ts, **kw)
    nodal, total = [], []
    for i, t in enumerate(np.asarray(ts)):
        r = morison_loads(wave, model.coords, model.conn, D_m, wave_dir,
                          current_dir, 0.7, 2.0, 1025.0, float(t),
                          accel="analytic", **oracle_kw)
        f = np.asarray(r.nodal_forces)
        nodal.append(np.abs(np.asarray(mb.nodal_forces[i]) - f).max()
                     / np.abs(f).max())
        tot = np.asarray(r.total_morison)
        total.append(np.abs(np.asarray(mb.total_morison[i]) - tot).max()
                     / np.abs(tot).max())
    return max(nodal), max(total)


def _first_members(model, n):
    return dataclasses.replace(
        model, conn=model.conn[:n], sect_id=model.sect_id[:n],
        member_names=model.member_names[:n],
        member_types=model.member_types[:n])


# Bounds: Airy has no height clamp to differ on, so the two paths agree to
# rounding.  The nonlinear waves differ only where the pointwise path
# replicates the reference's evaluation-height clamp, a 1 cm band below the
# surface (measured ~3.4e-5).  Wheeler on the separable path is a
# second-order Taylor expansion of the stretched profiles: measured 3.6e-3
# for Airy and 4.3e-2 for Stokes-5, whose crest harmonics carry the larger
# (jk dz)^3 term (morison_phase_batch's docstring).
CASES = {
    "airy": dict(wave=("airy", 1, 9.5), tol=1e-12),
    "stokes": dict(wave=("stokes", 5, 9.5), tol=1e-4),
    "fenton": dict(wave=("fenton", 12, 9.5), tol=1e-4),
    "wheeler_airy": dict(wave=("airy", 1, 12.0), tol=1e-2,
                         kw=dict(stretching="wheeler")),
    "wheeler_stokes": dict(wave=("stokes", 5, 12.0), tol=6e-2,
                           kw=dict(stretching="wheeler")),
    "current_profile": dict(wave=("stokes", 5, 9.5), tol=1e-4,
                            kw=dict(current_alpha=1.0 / 7.0)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_separable_matches_pointwise(name):
    c = CASES[name]
    model_name, N, H = c["wave"]
    kw = c.get("kw", {})
    model = sf.default_3leg_jacket(dtype=jnp.float64)
    wave = sf.make_wave(H, 9.4, 50.0, U_c=1.2, model=model_name, N=N,
                        dtype=jnp.float64)
    ts = jnp.arange(12, dtype=jnp.float64) * 9.4 / 12
    nodal, total = _errors(model, wave, 38.0, 120.0, ts, kw)
    assert nodal < c["tol"] and total < c["tol"], (nodal, total)
    if kw:
        # the option must matter: without it the separable path lands
        # clearly farther from the oracle that has it
        _, total_without = _errors(model, wave, 38.0, 120.0, ts, {}, kw)
        assert total_without > 2 * total, (total_without, total)


def test_separable_odd_member_count():
    """13 members: a count that is not a multiple of any block size."""
    model = _first_members(sf.default_3leg_jacket(dtype=jnp.float64), 13)
    wave = sf.airy_wave(8.0, 9.4, 50.0, 1.0, dtype=jnp.float64)
    nodal, total = _errors(model, wave, 0.0, 0.0,
                           jnp.arange(4, dtype=jnp.float64))
    assert nodal < 1e-12 and total < 1e-12
