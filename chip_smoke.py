"""Smoke run of the jacket solver's main path on an NVIDIA GPU.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --multi    # four cards: the two sharded paths only

Each phase drives a public entry point at the size users run it, checks the
answer against the repository's plain reference computed on the same card,
and prints one line: phase, size, error next to its tolerance and precision,
compile seconds (first call minus a steady call), steady seconds, and the
process's ``peak_bytes_in_use`` so far.  A failed check raises, so the run
exits non-zero; nothing is caught.  The last line of standard output is one
JSON object naming the device.  Without a GPU the script exits non-zero
before any work.

Phases (one card):
  golden    sf.analyze on the default jacket, f64, pointwise kinematics,
            vs tests/golden/default_case.json at the 1e-8 parity invariant
  flagship  9,612-DOF x 360-phase condensed scan in f32 (one-shot and
            prepared) vs the same scan in f64
  envelope  10 Fenton cases x 360 phases at 9,612 DOF vs per-case scans
  large     99,882-DOF condensed solve (residual, equilibrium) and the
            two-level PCG on the same mesh, f64
  scatter   spectral scatter fatigue (10 states, 32 components), f32 vs f64
  dynamics  modal analysis with 1,100 t topside: eigh vs subspace iteration
Phases (--multi, four cards):
  multi_envelope  16 cases x 360 phases on a ("cases",) mesh vs one card
  multi_pcg       row-sharded PCG at 10,530 DOF on a ("dof",) mesh vs the
                  one-card condensed solve
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import small_fem_solver_tpu as sf  # noqa: E402
from small_fem_solver_tpu.utils.compile_cache import \
    enable_compile_cache  # noqa: E402

F32, F64 = jnp.float32, jnp.float64
GOLDEN = pathlib.Path(__file__).resolve().parent / "tests" / "golden" \
    / "default_case.json"
STORM = dict(wave_dir_deg=38.0, current_dir_deg=38.0, F_axial_kN=25100.0,
             F_shear_kN=2900.0, custom_sw_tonnes=1100.0, sw_mode="custom")


def _storm_wave(dtype, H=17.038):
    return sf.make_wave(H, 9.4, 50.0, U_c=1.7, model="fenton", N=18,
                        dtype=dtype)


def _rel(a, b):
    """max |a - b| / max |b| in float64."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _timed(fn):
    """(result, compile_s, steady_s): a first call, which compiles, then a
    steady call; compile_s is the difference."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    steady = time.perf_counter() - t0
    return out, max(first - steady, 0.0), steady


def _check(name, err, tol):
    if not err <= tol:          # NaN fails too
        raise AssertionError(f"{name}: error {err:.3e} exceeds {tol:.1e}")
    return f"{name} {err:.2e} (tol {tol:.0e})"


def _report(phase, size, checks, precision, compile_s, steady_s, extra=""):
    stats = jax.devices()[0].memory_stats() or {}
    print(f"[{phase}] size={size} | {'; '.join(checks)} | "
          f"precision={precision} | compile_s={compile_s:.2f} "
          f"steady_s={steady_s:.4f} | "
          f"peak_bytes_in_use={stats.get('peak_bytes_in_use')}"
          + (f" | {extra}" if extra else ""), flush=True)


def phase_golden():
    g = json.loads(GOLDEN.read_text())
    p = g["params"]
    model = sf.default_3leg_jacket(leg_section=(p["D_leg"], p["t_leg"]),
                                   brace_section=(p["D_brace"], p["t_brace"]),
                                   rho_steel=p["rho_steel"], dtype=F64)
    wave = sf.airy_wave(p["H"], p["T"], p["d"], p["U_c"], dtype=F64)
    case = sf.LoadCase(
        E=p["E"], nu=p["nu"], fy=p["fy"], rho_water=p["rho_water"],
        wave_dir_deg=p["wave_dir"], current_dir_deg=p["current_dir"],
        Cd=p["Cd"], Cm=p["Cm"], F_axial_kN=p["F_axial_kN"],
        F_shear_kN=p["F_shear_kN"], M_moment_kNm=p["M_moment_kNm"],
        M_torsion_kNm=p["M_torsion_kNm"],
        custom_sw_tonnes=p.get("custom_sw_tonnes", 0.0),
        t_analysis=p["t_analysis"], sw_mode=p["sw_mode"])
    fem = g["fem"]
    ref = {"U": np.array(fem["U"]),
           "F_applied": np.array(fem["F_global"]),
           "reactions": np.array([fem["reactions"][n]
                                  for n in model.fixed_node_names()]),
           "utilization": np.array([m["utilization"]
                                    for m in fem["internal_forces"]]),
           "von_mises": np.array([m["von_mises_max_MPa"]
                                  for m in fem["internal_forces"]])}
    checks, times = [], None
    for solver in ("lu", "chol"):
        res, c_s, s_s = _timed(lambda: sf.analyze(
            model, wave, case, solver=solver, accel="fd"))
        times = times or (c_s, s_s)
        for field, want in ref.items():
            checks.append(_check(f"{solver}.{field}",
                                 _rel(getattr(res, field), want), 1e-8))
    _report("golden", f"{model.n_dof} DOF", checks,
            "f64 vs reference goldens", *times)


def _flagship_inputs(dtype, n_seg):
    coarse = sf.default_3leg_jacket(dtype=dtype)
    return coarse, sf.refine_model(coarse, n_seg), _storm_wave(dtype)


def phase_flagship(n_seg=32, n_steps=360):
    case = sf.LoadCase(**STORM)
    c32, r32, w32 = _flagship_inputs(F32, n_seg)
    c64, r64, w64 = _flagship_inputs(F64, n_seg)
    s32, c_s, s_s = _timed(lambda: sf.phase_scan_condensed(
        c32, r32, n_seg, w32, case, n_steps=n_steps, kinematics="separable",
        solve_dtype=F32))
    prep = sf.prepare_condensed(c32, r32, n_seg, solve_dtype=F32)
    p32 = sf.phase_scan_prepared(prep, w32, case, n_steps=n_steps)
    s64 = sf.phase_scan_condensed(c64, r64, n_seg, w64, case,
                                  n_steps=n_steps, kinematics="separable",
                                  solve_dtype=F64)
    u64 = float(np.asarray(s64.utilization).max())
    checks = []
    # bounds of tests/test_condense.py's flagship f32-vs-f64 test
    for tag, s in (("oneshot", s32), ("prepared", p32)):
        checks += [
            _check(f"{tag}.U", _rel(s.U, s64.U), 1e-4),
            _check(f"{tag}.von_mises", _rel(s.von_mises, s64.von_mises),
                   2e-4),
            _check(f"{tag}.max_util",
                   abs(float(np.asarray(s.utilization).max()) - u64) / u64,
                   2e-4)]
    _report("flagship", f"{r32.n_dof} DOF x {n_steps} phases", checks,
            "f32 vs f64 on device", c_s, s_s,
            f"max_util={u64:.5f} critical_phase={int(s64.critical_index)}")


def phase_envelope(n_seg=32, n_steps=360, n_cases=10):
    from small_fem_solver_tpu.parallel.sweep import (make_case_batch,
                                                     make_wave_batch)
    case = sf.LoadCase(**STORM)
    coarse, refined, _ = _flagship_inputs(F32, n_seg)
    waves = make_wave_batch(np.linspace(8.0, 17.0, n_cases), 9.4, 50.0,
                            U_c=1.7, model="fenton", N=18, n_modes=18,
                            dtype=F32)
    cases = make_case_batch(case, t_analysis=jnp.zeros(n_cases, F32))
    env, c_s, s_s = _timed(lambda: sf.design_envelope_condensed(
        coarse, refined, n_seg, waves, cases, n_steps=n_steps,
        solve_dtype=F32, kinematics="separable"))
    # the envelope runs no refinement round, so neither does its reference
    prep = sf.prepare_condensed(coarse, refined, n_seg, solve_dtype=F32)
    ref = np.array([float(np.asarray(sf.phase_scan_prepared(
        prep, jax.tree.map(lambda x: x[c], waves), case, n_steps=n_steps,
        refine_steps=0).utilization).max()) for c in range(n_cases)])
    err = float(np.max(np.abs(np.asarray(env.max_util_per_case) - ref)
                       / ref))
    _report("envelope", f"{refined.n_dof} DOF x {n_cases} cases x "
            f"{n_steps} phases",
            [_check("max_util_per_case", err, 2e-4)],
            "f32 vs per-case f32 scans", c_s, s_s,
            f"governing_case={int(env.governing_case)}")


def _chain_residual(coarse, refined, n_seg, res):
    """max |F - K U| over free DOFs / max |F|, K applied chain by chain."""
    from small_fem_solver_tpu.ops.beams import element_stiffness
    from small_fem_solver_tpu.ops.condense import chain_matvec

    @jax.jit
    def ku(coords, U):
        with jax.default_matmul_precision("highest"):
            Kg, _, _, _ = element_stiffness(coords, refined.conn,
                                            refined.sections,
                                            refined.sect_id, 210000.0,
                                            210000.0 / 2.6)
            nc, Mc = coarse.n_nodes, coarse.n_members
            U_In = U[None, :6 * nc].reshape(1, nc, 6)
            v = U[None, 6 * nc:].reshape(1, Mc, n_seg - 1, 6).swapaxes(1, 2)
            y_I, y_int = chain_matvec(Kg, n_seg, coarse.conn, U_In, v)
            return jnp.concatenate([y_I.reshape(-1),
                                    y_int.swapaxes(1, 2).reshape(-1)])

    F = np.asarray(res.F_applied)
    free = np.repeat(~np.asarray(refined.fixed_mask), 6)
    r = (F - np.asarray(ku(refined.coords, res.U)))[free]
    return float(np.abs(r).max() / np.abs(F).max())


def phase_large(n_seg=327):
    coarse = sf.default_3leg_jacket(dtype=F64)
    refined = sf.refine_model(coarse, n_seg)
    wave = _storm_wave(F64)
    case = sf.LoadCase(**STORM, t_analysis=0.34)
    res, c_s, s_s = _timed(lambda: sf.analyze_condensed(
        coarse, refined, n_seg, wave, case))
    F = np.asarray(res.F_applied)
    eq = np.asarray(res.total_reaction[:3]) \
        + F.reshape(-1, 6)[:, :3].sum(axis=0)
    # bounds of tests/test_large.py
    checks = [_check("residual", _chain_residual(coarse, refined, n_seg,
                                                 res), 1e-9),
              _check("equilibrium", float(np.abs(eq).max()
                                          / np.abs(F).max()), 1e-10)]
    _report("large.condensed", f"{refined.n_dof} DOF", checks,
            "f64", c_s, s_s,
            f"max_util={float(np.asarray(res.utilization).max()):.5f}")

    tol = 1e-8
    pcg, c_s, s_s = _timed(lambda: sf.analyze(
        refined, wave, case, solver="pcg", pcg_precond="two_level",
        pcg_tol=tol, pcg_maxiter=3000, pcg_chunk=200))
    gap = float(np.abs(np.asarray(pcg.utilization)
                       - np.asarray(res.utilization)).max()
                / np.asarray(res.utilization).max())
    _report("large.pcg", f"{refined.n_dof} DOF", [_check(
        "rel_residual", float(pcg.solver_residual), tol)], "f64", c_s, s_s,
        f"iterations={int(pcg.solver_iters)} util_gap_vs_condensed="
        f"{gap:.2e} (known gap, not gated)")


SCATTER_STATES = tuple((2.5 + 0.5 * i, 7.0 + 0.3 * i, 0.05, 36.0 * i)
                       for i in range(10))


def phase_scatter(n_seg=8, n_components=32):
    case = sf.LoadCase(**STORM)
    out = {}
    for dtype in (F32, F64):
        coarse = sf.default_3leg_jacket(dtype=dtype)
        refined = sf.refine_model(coarse, n_seg)
        prep = sf.prepare_condensed(coarse, refined, n_seg,
                                    solve_dtype=dtype)
        out[dtype], c_s, s_s = _timed(lambda: sf.scatter_fatigue_spectral(
            prep, case, SCATTER_STATES, 50.0, 25.0,
            n_components=n_components))
        if dtype is F32:
            times = (c_s, s_s)
    d32 = np.asarray(out[F32].damage_wl, np.float64)
    d64 = np.asarray(out[F64].damage_wl)
    if not np.isfinite(d32).all():
        raise AssertionError("scatter: non-finite f32 damage")
    # damage goes as stress^m with m up to 5 (two-slope S-N curve), so the
    # f32 stress error (~1e-5 relative) is amplified about five-fold
    _report("scatter", f"{refined.n_dof} DOF x {len(SCATTER_STATES)} states"
            f" x {n_components} components",
            [_check("damage_wl", _rel(d32, d64), 1e-3)],
            "f32 vs f64 on device", *times,
            f"max_damage_wl={d64.max():.3e}")


def phase_dynamics(n_modes=10):
    from small_fem_solver_tpu.ops.dynamics import _build_km
    from small_fem_solver_tpu.ops.eigen import subspace_eigh

    model = sf.default_3leg_jacket(dtype=F64)
    modal, c_s, s_s = _timed(lambda: sf.modal_analysis(
        model, n_modes=n_modes, topside_mass_t=1100.0))
    K, M, free, _ = _build_km(model, 210000.0, 0.3, 1100.0, None, 1025.0)
    lam, _ = jax.jit(lambda K, M: subspace_eigh(K, M, n_modes, n_iter=16))(
        K[jnp.ix_(free, free)], M[jnp.ix_(free, free)])
    f_sub = np.sqrt(np.asarray(lam)) / (2.0 * np.pi)
    f_eigh = np.asarray(modal.frequencies_hz)
    T1 = 1.0 / f_eigh[0]
    _report("dynamics", f"{model.n_dof} DOF, {n_modes} modes",
            [_check("T1_vs_0.61s", abs(T1 - 0.61) / 0.61, 2e-2),
             # tests/test_eigen.py's subspace-vs-eigh bound
             _check("subspace_vs_eigh", _rel(f_sub, f_eigh), 1e-8)],
            "f64", c_s, s_s, f"T1={T1:.4f}s")


def _spans_all(x, n):
    if len(x.sharding.device_set) != n:
        raise AssertionError(f"result on {len(x.sharding.device_set)} of "
                             f"{n} devices")


def phase_multi_envelope(devs, n_seg=32, n_steps=360, n_cases=16):
    from jax.sharding import Mesh

    from small_fem_solver_tpu.parallel.sweep import (make_case_batch,
                                                     make_wave_batch)
    case = sf.LoadCase(**STORM)
    coarse, refined, _ = _flagship_inputs(F32, n_seg)
    waves = make_wave_batch(np.linspace(4.0, 17.0, n_cases), 9.4, 50.0,
                            U_c=1.7, model="fenton", N=18, n_modes=18,
                            dtype=F32)
    cases = make_case_batch(case, t_analysis=jnp.zeros(n_cases, F32))
    mesh = Mesh(np.array(devs), ("cases",))
    env, c_s, s_s = _timed(lambda: sf.design_envelope_condensed(
        coarse, refined, n_seg, waves, cases, n_steps=n_steps,
        solve_dtype=F32, mesh=mesh))
    _spans_all(env.max_util_per_case, len(devs))
    one = sf.design_envelope_condensed(coarse, refined, n_seg, waves, cases,
                                       n_steps=n_steps, solve_dtype=F32)
    member_diff = _rel(env.member_envelope, one.member_envelope)
    _report("multi_envelope", f"{refined.n_dof} DOF x {n_cases} cases x "
            f"{n_steps} phases on {len(devs)} devices",
            [_check("max_util_per_case", _rel(env.max_util_per_case,
                                              one.max_util_per_case), 1e-5)],
            "f32 sharded vs f32 one device", c_s, s_s,
            f"member_envelope_diff={member_diff:.2e} (not gated: f32 "
            "rounding of the unrefined chain solve)")


def phase_multi_pcg(devs, n_seg=35):
    from jax.sharding import Mesh

    coarse = sf.default_3leg_jacket(dtype=F32)
    refined = sf.refine_model(coarse, n_seg)
    wave = sf.stokes_wave(9.5, 9.4, 50.0, 1.2, order=5, n_modes=8,
                          dtype=F32)
    case = sf.LoadCase(**STORM)
    mesh = Mesh(np.array(devs), ("dof",))
    res, c_s, s_s = _timed(lambda: sf.analyze(
        refined, wave, case, solver="pcg", mesh=mesh, pcg_tol=1e-6,
        pcg_maxiter=8000, accel="analytic"))
    _spans_all(res.U, len(devs))
    cond = sf.analyze_condensed(coarse, refined, n_seg, wave, case)
    gap = _rel(res.utilization, cond.utilization)
    _report("multi_pcg", f"{refined.n_dof} DOF rows on {len(devs)} devices",
            [_check("rel_residual", float(res.solver_residual), 1e-5)],
            "f32 sharded PCG vs f64 one-device condensed", c_s, s_s,
            f"iterations={int(res.solver_iters)} "
            f"util_gap_vs_condensed={gap:.2e}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded phases")
    args = ap.parse_args(argv)

    enable_compile_cache()
    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX found {dev.platform!r}); "
                 "this script runs only on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(f"device_kind={dev.device_kind} count={len(devs)}")
    print("nvidia-smi name, power.limit:")
    print(smi.strip(), flush=True)

    if args.multi:
        if len(devs) != 4:
            sys.exit(f"chip_smoke --multi: needs 4 GPUs, found {len(devs)}")
        phase_multi_envelope(devs)
        phase_multi_pcg(devs)
    else:
        for phase in (phase_golden, phase_flagship, phase_envelope,
                      phase_large, phase_scatter, phase_dynamics):
            phase()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
