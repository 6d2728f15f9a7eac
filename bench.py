"""Benchmark of the jacket solver on one NVIDIA GPU.

    python bench.py [--large] [--repeats N]
    python bench.py --trace DIR      # profile the flagship scan, by layer

Prints ONE JSON line:
    {"metric": "phase_scan_360_10kdof", "value": <ms>, "unit": "ms",
     "vs_baseline": <ratio>, "device": {...}, "secondary": {...}}

The workload (BASELINE.md north star): the default 3-leg jacket refined to
9,612 DOF, Fenton stream-function storm wave (H=17.038 m, T=9.4 s, d=50 m,
U_c=1.7 m/s), full FEM at 360 wave phases — loads, solve, reactions and
von Mises utilization at every phase — via the exact substructure
condensation solver in float32 (one round of iterative refinement; its
error against float64 is asserted in tests/test_condense.py and on the card
by chip_smoke.py).  Repeated one-shot scans of the same model reuse the
case-independent chain factorization (api._cached_prepared), so the
amortized headline equals the factor-once user path; prepared_scan_ms pins
the explicit prepare/scan API.  ``vs_baseline`` is the north-star target
(50 ms) divided by the measured time: > 1 means the target is beaten.

Times are host clock around work that ends in ``block_until_ready``, in
steady state; compile time is reported apart.  Roofline shares use XLA's
cost model for the program against the card's published peaks
(:data:`PEAKS`).  The run refuses any device that is not in that table.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

# Published peaks, dense, without sparsity, at the 700 W power limit
# (NVIDIA H100 data sheet, SXM part).  Keyed by jax device_kind.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12,          # outside the tensor cores
        "f64_flops": 34e12,          # outside the tensor cores
        "f64_tensor_flops": 67e12,
        "tf32_tensor_flops": 495e12,
        "bf16_tensor_flops": 989e12,
        "hbm_bytes_s": 3.35e12,
        "source": "NVIDIA H100 Tensor Core GPU data sheet, SXM5",
    },
}
LAYERS = ("loads", "solve", "stress")   # jax.named_scope names in the scan


def device_peaks(kind: str) -> dict:
    """The peak table row for a jax ``device_kind``; unknown kinds raise."""
    try:
        return PEAKS[kind]
    except KeyError:
        raise ValueError(f"no published peaks for device kind {kind!r}; "
                         f"add them to bench.PEAKS with their source") \
            from None


def _cost_model(jitted, *args):
    """(flops, bytes accessed) of a jitted callable from XLA's cost model."""
    import jax

    cost = jax.jit(jitted).lower(*args).compile().cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    return float(cost.get("flops", 0.0)), float(cost.get("bytes accessed",
                                                         0.0))


def _roofline(flops, nbytes, seconds, peaks):
    """Achieved rates and shares of the card's f32 and HBM peaks."""
    return {"tflops_s": round(flops / seconds / 1e12, 4),
            "f32_peak_share": round(flops / seconds / peaks["f32_flops"], 5),
            "gbs": round(nbytes / seconds / 1e9, 1),
            "hbm_peak_share": round(nbytes / seconds / peaks["hbm_bytes_s"],
                                    5)}


def _flagship_setup():
    import jax.numpy as jnp

    import small_fem_solver_tpu as sf

    coarse = sf.default_3leg_jacket(dtype=jnp.float32)
    n_seg = 32
    refined = sf.refine_model(coarse, n_seg)
    wave = sf.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="fenton", N=18,
                        dtype=jnp.float32)
    case = sf.LoadCase(wave_dir_deg=38.0, current_dir_deg=38.0,
                       F_axial_kN=25100.0, F_shear_kN=2900.0,
                       custom_sw_tonnes=1100.0, sw_mode="custom")
    return coarse, refined, n_seg, wave, case


def _best_of(fn, rounds=3, n=10):
    """Minimum over ``rounds`` of the mean time of ``n`` back-to-back calls
    (dispatched asynchronously, blocked once at the end)."""
    import jax

    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        outs = [fn() for _ in range(n)]
        jax.block_until_ready(outs)
        best = min(best, (time.perf_counter() - t0) / n)
    return best


def measure_flagship(peaks, repeats: int = 5):
    import jax.numpy as jnp
    import numpy as np

    import small_fem_solver_tpu as sf
    from small_fem_solver_tpu.parallel.sweep import (make_case_batch,
                                                     make_wave_batch)

    coarse, refined, n_seg, wave, case = _flagship_setup()

    def run():
        return sf.phase_scan_condensed(coarse, refined, n_seg, wave, case,
                                       n_steps=360, kinematics="separable",
                                       solve_dtype=jnp.float32).utilization

    t0 = time.perf_counter()
    util = run().block_until_ready()
    compile_s = time.perf_counter() - t0
    single = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        run().block_until_ready()
        single = min(single, time.perf_counter() - t0)
    n = max(repeats, 10)
    amortized = _best_of(run, n=n)
    print(f"[bench] ndof={refined.n_dof} n_steps=360 compile={compile_s:.1f}s "
          f"single_call={single*1e3:.3f}ms amortized={amortized*1e3:.3f}ms "
          f"max_util={float(util.max()):.4f}", file=sys.stderr)

    # prepared (factor-once) scan: the user-facing amortized path
    prep = sf.prepare_condensed(coarse, refined, n_seg,
                                solve_dtype=jnp.float32)

    def run_prep():
        return sf.phase_scan_prepared(prep, wave, case,
                                      n_steps=360).utilization

    du = float(abs(run_prep() - util).max())
    prepared = _best_of(run_prep, n=n)
    print(f"[bench] prepared scan: {prepared*1e3:.3f} ms/360-phase scan, "
          f"prepared-vs-oneshot max|d util|={du:.1e}", file=sys.stderr)

    # sustained production throughput: 10 cases x 360 phases in one
    # envelope program, the factorization amortized across the case axis
    C = 10
    waves = make_wave_batch(np.linspace(8.0, 17.0, C), 9.4, 50.0, U_c=1.7,
                            model="fenton", N=18, n_modes=18,
                            dtype=jnp.float32)
    cases = make_case_batch(case, t_analysis=jnp.zeros(C, jnp.float32))

    def run_env():
        return sf.design_envelope_condensed(
            coarse, refined, n_seg, waves, cases, n_steps=360,
            solve_dtype=jnp.float32).max_util_per_case

    run_env().block_until_ready()
    env = _best_of(run_env, n=5)
    fl, by = _cost_model(run_env)
    roof = _roofline(fl, by, env, peaks)
    print(f"[bench] envelope: {C} cases x 360 phases @ {refined.n_dof} DOF "
          f"= {env/C*1e3:.3f} ms per scan; cost model {fl/1e9:.1f} GFLOP / "
          f"{by/1e6:.0f} MB per envelope -> {roof}", file=sys.stderr)
    sec = {"compile_s": round(compile_s, 2),
           "single_call_ms": round(single * 1e3, 4),
           "prepared_scan_ms": round(prepared * 1e3, 4),
           "envelope_ms_per_scan": round(env / C * 1e3, 4)}
    sec.update({f"envelope_{k}": v for k, v in roof.items()})
    return amortized * 1e3, sec


def measure_scatter(peaks):
    """Frequency-domain scatter fatigue: ms per sea state (each state =
    65 linearized transfer solves + closed-form statistics), and the
    marginal cost per state from a 10- and a 40-state climate."""
    import jax.numpy as jnp
    import numpy as np

    import small_fem_solver_tpu as sf
    from small_fem_solver_tpu.api import (_scatter_spectral_batched,
                                          _scatter_spectral_setup)

    coarse = sf.default_3leg_jacket(dtype=jnp.float32)
    refined = sf.refine_model(coarse, 8)
    case = sf.LoadCase(wave_dir_deg=38.0, current_dir_deg=38.0,
                       F_axial_kN=25100.0, F_shear_kN=2900.0,
                       custom_sw_tonnes=1100.0, sw_mode="custom")
    prep = sf.prepare_condensed(coarse, refined, 8, solve_dtype=jnp.float32)
    states10 = [(2.5 + 0.5 * i, 7.0 + 0.3 * i, 0.05, 36.0 * i)
                for i in range(10)]
    states40 = [(2.5 + 0.125 * i, 7.0 + 0.075 * i, 0.0125, 9.0 * i)
                for i in range(40)]
    n_components = 32

    def run(ss):
        return sf.scatter_fatigue_spectral(prep, case, ss, 50.0, 25.0,
                                           n_components=n_components)

    r = run(states10)
    run(states40)
    best10 = best40 = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        r = run(states10)
        best10 = min(best10, time.perf_counter() - t0)
        t0 = time.perf_counter()
        run(states40)
        best40 = min(best40, time.perf_counter() - t0)
    per = best10 / len(states10) * 1e3
    marginal = (best40 - best10) / (len(states40) - len(states10)) * 1e3
    print(f"[bench] spectral scatter fatigue @ {refined.n_dof} DOF: "
          f"{per:.3f} ms/state (marginal {marginal:.3f} ms/state; max 25-y "
          f"W-L damage {float(np.max(np.asarray(r.damage_wl))):.2e})",
          file=sys.stderr)
    out = {"scatter_ms_per_state": round(per, 4),
           "scatter_ms_per_state_marginal": round(marginal, 4)}

    # the device program of the climate, lowered on the inputs the public
    # API builds on the host
    def cost(ss):
        sea_b, heads, occs, _ = _scatter_spectral_setup(
            prep, case, tuple(tuple(float(v) for v in row) for row in ss),
            50.0, n_components=n_components, seed=0, spectrum="jonswap",
            U_c=0.0, spreading_s=None)
        c = _scatter_spectral_batched.lower(
            prep, case.cast(prep.refined.coords.dtype), sea_b, heads, occs,
            None, 15, None, "D-sea-cp", 25.0, 3.0, 1.0).compile() \
            .cost_analysis()
        c = c[0] if isinstance(c, (list, tuple)) else c
        return float(c.get("flops", 0.0)), float(c.get("bytes accessed",
                                                       0.0))

    (f10, b10), (f40, b40) = cost(states10), cost(states40)
    if marginal > 0:
        roof = _roofline((f40 - f10) / 30, (b40 - b10) / 30,
                         marginal * 1e-3, peaks)
        out.update({f"scatter_marginal_{k}": v for k, v in roof.items()})
    return out


def measure_assembly(peaks, n_seg: int = 327):
    """Global-K assembly throughput (GDOF/s) at ~100k DOF in float32:
    sustained (B = 64 assemblies in one program), one assembly per call,
    and the gather formulation for comparison."""
    import jax
    import jax.numpy as jnp

    import small_fem_solver_tpu as sf
    from small_fem_solver_tpu.api import _cached_bcsr_pattern
    from small_fem_solver_tpu.ops.assembly import (assemble_bcsr,
                                                   assemble_bcsr_direct,
                                                   prepare_direct_assembly)
    from small_fem_solver_tpu.ops.beams import element_global_stiffness

    model = sf.refine_model(sf.default_3leg_jacket(dtype=jnp.float32), n_seg)
    pattern = _cached_bcsr_pattern(model.conn, model.n_nodes)
    E = jnp.float32(210000.0)
    prep = prepare_direct_assembly(model.coords, model.conn, model.sect_id,
                                   model.n_nodes)

    @jax.jit
    def assemble_one(s):
        with jax.default_matmul_precision("highest"):
            return assemble_bcsr_direct(prep, model.sections, E, E / 2.6,
                                        scale=s).blocks

    assemble_one(jnp.float32(1.0)).block_until_ready()
    single = _best_of(lambda: assemble_one(jnp.float32(1.0)))

    B = 64
    scales = jnp.linspace(1.0, 1.01, B, dtype=jnp.float32)

    @jax.jit
    def sustained(scales):
        def one(s):
            with jax.default_matmul_precision("highest"):
                return assemble_bcsr_direct(prep, model.sections, E,
                                            E / 2.6, scale=s).blocks.sum()
        return jax.lax.map(one, scales)

    @jax.jit
    def sustained_gather(scales):
        def one(s):
            with jax.default_matmul_precision("highest"):
                Kg = element_global_stiffness(model.coords * s, model.conn,
                                              model.sections, model.sect_id,
                                              E, E / 2.6)
            return assemble_bcsr(Kg, pattern).blocks.sum()
        return jax.lax.map(one, scales)

    jax.block_until_ready((sustained(scales), sustained_gather(scales)))
    best = _best_of(lambda: sustained(scales), n=6) / B
    best_gather = _best_of(lambda: sustained_gather(scales), n=6) / B
    fl, by = _cost_model(sustained, scales)
    roof = _roofline(fl / B, by / B, best, peaks)
    print(f"[bench] assembly: {model.n_dof} DOF direct-write BCSR "
          f"sustained {best*1e3:.4f} ms = {model.n_dof/best/1e9:.3f} GDOF/s "
          f"(one per call {single*1e3:.4f} ms; gather path "
          f"{best_gather*1e3:.4f} ms) -> {roof}", file=sys.stderr)
    out = {"assembly_gdofs": round(model.n_dof / best / 1e9, 4),
           "assembly_single_gdofs": round(model.n_dof / single / 1e9, 4),
           "assembly_gather_gdofs": round(model.n_dof / best_gather / 1e9,
                                          4)}
    out.update({f"assembly_{k}": v for k, v in roof.items()})
    return out


def measure_large(n_seg: int = 327):
    """~100k-DOF end-to-end analyses in float64: the direct chain
    condensation and the two-level PCG on the same mesh."""
    import jax.numpy as jnp
    import numpy as np

    import small_fem_solver_tpu as sf

    coarse = sf.default_3leg_jacket(dtype=jnp.float64)
    refined = sf.refine_model(coarse, n_seg)
    wave = sf.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="fenton", N=18,
                        dtype=jnp.float64)
    case = sf.LoadCase(wave_dir_deg=38.0, current_dir_deg=38.0,
                       F_axial_kN=25100.0, F_shear_kN=2900.0,
                       custom_sw_tonnes=1100.0, sw_mode="custom",
                       t_analysis=0.34)

    def cond():
        return sf.analyze_condensed(coarse, refined, n_seg, wave, case)

    def pcg():
        return sf.analyze(refined, wave, case, solver="pcg",
                          pcg_maxiter=3000, pcg_precond="two_level",
                          pcg_tol=1e-8, pcg_chunk=200)

    out = {}
    for name, fn, reps in (("condensed", cond, 3), ("pcg", pcg, 2)):
        t0 = time.perf_counter()
        res = fn()
        res.U.block_until_ready()
        compile_s = time.perf_counter() - t0
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            res = fn()
            res.U.block_until_ready()
            best = min(best, time.perf_counter() - t0)
        out[f"large_{name}_ms"] = round(best * 1e3, 3)
        out[f"large_{name}_compile_s"] = round(compile_s, 2)
        if name == "condensed":
            ref = res
    util_gap = float(np.abs(np.asarray(res.utilization)
                            - np.asarray(ref.utilization)).max()
                     / np.asarray(ref.utilization).max())
    out.update(large_pcg_iters=int(res.solver_iters),
               large_pcg_util_rel=float(f"{util_gap:.3e}"))
    print(f"[bench] large mesh ndof={refined.n_dof}: {out}", file=sys.stderr)
    return out


def _op_layers(hlo_text: str) -> dict:
    """HLO instruction name -> layer, read from the named scopes that the
    ``op_name`` metadata of each instruction carries."""
    out = {}
    for m in re.finditer(r'^\s*(?:ROOT\s+)?%?([\w.\-]+) = [^\n]*?'
                         r'op_name="([^"]+)"', hlo_text, re.M):
        parts = m.group(2).split("/")
        out[m.group(1)] = next((p for p in parts if p in LAYERS), "other")
    return out


def reduce_trace(xplane_path: str, hlo_text: str, module: str) -> dict:
    """Device time per layer of one jitted program, from a profiler trace.

    Counts the kernel events on the GPU planes whose ``hlo_module`` stat
    contains ``module``; each event's ``hlo_op`` stat (or, for a kernel
    recorded inside a CUDA graph, its name, which is the fusion's name) is
    mapped to its layer through :func:`_op_layers`.  Busy time is the
    union of those events' intervals; the window runs from the first
    event's start to the last event's end.
    """
    from jax.profiler import ProfileData

    layers = _op_layers(hlo_text)
    per = dict.fromkeys(LAYERS + ("other",), 0)
    spans = []
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith("/device:GPU:"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                stats = dict(ev.stats)
                if module not in str(stats.get("hlo_module", "")):
                    continue
                op = str(stats.get("hlo_op"))
                layer = layers.get(op if op != "command_buffer" else ev.name,
                                   "other")
                per[layer] += ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not spans:
        raise RuntimeError(f"no device events of module {module!r} in "
                           f"{xplane_path}")
    spans.sort()
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    window = end - spans[0][0]
    total = sum(per.values())
    return {"kernel_ns": {k: round(v) for k, v in per.items()},
            "share": {k: round(v / total, 4) for k, v in per.items()},
            "busy_ns": round(busy), "window_ns": round(window),
            "idle_share": round(1.0 - busy / window, 4)}


def trace_flagship(out_dir: str, n_scans: int = 5) -> dict:
    """Profile ``n_scans`` steady prepared flagship scans and reduce the
    trace into device time per layer (loads, solve, stress).  The scan's
    optimized HLO is written beside the trace (``scan_hlo.txt``)."""
    import glob
    import pathlib

    import jax
    import jax.numpy as jnp

    import small_fem_solver_tpu as sf
    from small_fem_solver_tpu.api import _phase_scan_prepared_jit

    coarse, refined, n_seg, wave, case = _flagship_setup()
    prep = sf.prepare_condensed(coarse, refined, n_seg,
                                solve_dtype=jnp.float32)
    args = (prep, wave, case.cast(jnp.float32), 360, 15, "analytic",
            "separable", 1, "none", None)
    jax.block_until_ready(_phase_scan_prepared_jit(*args))
    hlo = _phase_scan_prepared_jit.lower(*args).compile().as_text()
    pathlib.Path(out_dir).mkdir(parents=True, exist_ok=True)
    (pathlib.Path(out_dir) / "scan_hlo.txt").write_text(hlo)
    with jax.profiler.trace(out_dir):
        jax.block_until_ready([_phase_scan_prepared_jit(*args)
                               for _ in range(n_scans)])
    path = sorted(glob.glob(f"{out_dir}/plugins/profile/*/*.xplane.pb"))[-1]
    out = reduce_trace(path, hlo, "phase_scan_prepared")
    out["n_scans"] = n_scans
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--large", action="store_true",
                    help="also time the ~100k-DOF condensed and PCG "
                         "analyses (long float64 compiles)")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--trace", metavar="DIR",
                    help="only profile the flagship scan into DIR and "
                         "print its device time per layer")
    args = ap.parse_args()
    if args.trace:
        # library kernels (cuBLAS, cuSOLVER) launched inside a CUDA graph
        # carry no HLO op name in the trace; without command buffers every
        # kernel names its op, so each can be given its layer
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_gpu_enable_command_buffer=")

    import jax

    from small_fem_solver_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: no GPU (JAX found {dev.platform!r})")
    peaks = device_peaks(dev.device_kind)
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    if args.trace:
        print(json.dumps({"trace": trace_flagship(args.trace),
                          "device": device}))
        return

    ms, secondary = measure_flagship(peaks, args.repeats)
    secondary.update(measure_assembly(peaks))
    secondary.update(measure_scatter(peaks))
    if args.large:
        jax.config.update("jax_enable_x64", True)
        secondary.update(measure_large())
    print(json.dumps({"metric": "phase_scan_360_10kdof",
                      "value": round(ms, 4), "unit": "ms",
                      "vs_baseline": round(50.0 / ms, 3),
                      "device": device, "secondary": secondary}))


if __name__ == "__main__":
    main()
