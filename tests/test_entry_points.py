"""Entry-point plumbing: the compile-cache location, the bench's peak table,
the eigensolver choice, the kinematics modes the condensed paths accept,
and chip_smoke.py's refusal to run without a GPU."""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

import small_fem_solver_tpu as sf
from small_fem_solver_tpu.utils import compile_cache

REPO = pathlib.Path(__file__).resolve().parents[1]
CACHE = str(REPO / ".jax_cache")


def _bench():
    sys.path.insert(0, str(REPO))
    try:
        import bench
    finally:
        sys.path.remove(str(REPO))
    return bench


@pytest.mark.parametrize("env_dir", [None, "/some/cache"])
def test_compile_cache_location(monkeypatch, env_dir):
    """Set, the environment variable wins and nothing is set in code;
    unset, the cache is the fixed .jax_cache/ at the repository root."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    if env_dir is None:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        assert compile_cache.enable_compile_cache() == CACHE
        assert calls == [("jax_compilation_cache_dir", CACHE)]
    else:
        monkeypatch.setenv(compile_cache.ENV_VAR, env_dir)
        assert compile_cache.enable_compile_cache() == env_dir
        assert calls == []


def test_compile_cache_dir_is_ignored_by_git():
    lines = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in lines


@pytest.mark.parametrize("kind,ok", [("NVIDIA H100 80GB HBM3", True),
                                     ("NVIDIA A100-SXM4-80GB", False),
                                     ("cpu", False)])
def test_peak_table(kind, ok):
    bench = _bench()
    if ok:
        peaks = bench.device_peaks(kind)
        assert peaks["hbm_bytes_s"] == 3.35e12
        assert peaks["f32_flops"] == 67e12 and peaks["source"]
    else:
        with pytest.raises(ValueError, match="no published peaks"):
            bench.device_peaks(kind)


def test_trace_layers_from_hlo_metadata():
    """bench._op_layers maps an HLO instruction to the named scope in its
    op_name metadata, as the per-layer trace reduction needs."""
    hlo = """
  %loop_cosine_sine_fusion = f32[8]{0} fusion(%p), kind=kLoop, metadata={op_name="jit(f)/jit(main)/loads/cos" stack_frame_id=3}
  ROOT %custom-call.2 = f32[8]{0} custom-call(%a), metadata={op_name="jit(f)/solve/dot_general"}
  %wrapped_reduce = f32[] fusion(%q), metadata={op_name="jit(f)/stress/reduce_max"}
  %copy.1 = f32[8]{0} copy(%r), metadata={op_name="jit(f)/transpose"}
"""
    assert _bench()._op_layers(hlo) == {
        "loop_cosine_sine_fusion": "loads", "custom-call.2": "solve",
        "wrapped_reduce": "stress", "copy.1": "other"}


def test_eigh_backend_auto_is_eigh_on_gpu(monkeypatch):
    """'auto' takes the full eigh (cuSOLVER) on a GPU, as on the CPU; the
    subspace iteration is only taken when asked for."""
    from small_fem_solver_tpu.ops import dynamics

    class FakeGpu:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(jax, "devices", lambda *a: [FakeGpu()])
    assert dynamics._eigh_backend("auto") == "lapack"
    assert dynamics._eigh_backend() == "lapack"
    assert dynamics._eigh_backend("subspace") == "subspace"


def _storm():
    coarse = sf.default_3leg_jacket()
    refined = sf.refine_model(coarse, 2)
    wave = sf.airy_wave(8.0, 9.4, 50.0, 1.0)
    case = sf.LoadCase(wave_dir_deg=38.0, current_dir_deg=38.0,
                       custom_sw_tonnes=1100.0, sw_mode="custom")
    return coarse, refined, wave, case


def _scan(coarse, refined, wave, case, kinematics):
    return sf.phase_scan_condensed(coarse, refined, 2, wave, case, n_steps=2,
                                   kinematics=kinematics)


def _prepared(coarse, refined, wave, case, kinematics):
    prep = sf.prepare_condensed(coarse, refined, 2)
    return sf.phase_scan_prepared(prep, wave, case, n_steps=2,
                                  kinematics=kinematics)


def _envelope(coarse, refined, wave, case, kinematics):
    from small_fem_solver_tpu.parallel.sweep import (make_case_batch,
                                                     make_wave_batch)
    waves = make_wave_batch([6.0, 8.0], 9.4, 50.0, U_c=1.0, model="airy",
                            n_modes=1, dtype=jnp.float64)
    cases = make_case_batch(case, t_analysis=jnp.zeros(2))
    return sf.design_envelope_condensed(coarse, refined, 2, waves, cases,
                                        n_steps=2, solve_dtype=jnp.float64,
                                        kinematics=kinematics)


@pytest.mark.parametrize("entry", [_scan, _prepared, _envelope])
def test_condensed_paths_reject_unknown_kinematics(entry):
    """The removed fused-kernel mode is an unknown mode like any other."""
    with pytest.raises(ValueError, match="unknown kinematics mode"):
        entry(*_storm(), "pallas")


def _run_smoke(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    r = _run_smoke(REPO, REPO / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository the script cannot pass."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path, tmp_path / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.gpu
def test_chip_smoke_on_card(gpu_card):
    """The whole smoke run on the card (the pytest process itself stays on
    the CPU, so the child is the card's one JAX process)."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
    assert gpu_card.split(",")[0] in r.stdout
