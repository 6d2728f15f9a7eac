"""Test configuration: CPU platform, 8 virtual devices, float64.

Parity with the NumPy reference requires float64; multi-device sharding
tests use a virtual 8-device CPU mesh
(`--xla_force_host_platform_device_count`), mirroring SURVEY.md section 4's
"distributed tests without a cluster" plan.
The platform is pinned through jax.config before any backend is
initialized, so the suite runs on the CPU on a machine with a GPU too, and
the persistent compilation cache that the entry points enable stays off.
Tests that need the card carry the ``gpu`` marker and take the
``gpu_card`` fixture, which skips them where there is none.
"""
import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_enable_compilation_cache", False)

import json  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402

import pytest  # noqa: E402

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Bound cumulative XLA state across the ~190-test suite.

    Every module compiles many distinct programs; with the caches never
    dropped, the full run accumulates hundreds of live CPU executables and
    eventually segfaults in the last modules (observed at ~91% with 125 GB
    RAM free — native XLA state, not Python heap).  Clearing per module
    trades a little recompilation for a bounded footprint.
    """
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def golden_default():
    return json.loads((GOLDEN_DIR / "default_case.json").read_text())


@pytest.fixture(scope="session")
def golden_variant():
    return json.loads((GOLDEN_DIR / "variant_case.json").read_text())


@pytest.fixture(scope="session")
def golden_shallow():
    return json.loads((GOLDEN_DIR / "shallow_case.json").read_text())


@pytest.fixture(scope="session")
def golden_custom_tower():
    return json.loads((GOLDEN_DIR / "custom_tower_case.json").read_text())


@pytest.fixture(scope="session")
def golden_singular():
    return json.loads((GOLDEN_DIR / "singular_case.json").read_text())


@pytest.fixture(scope="session")
def golden_autogen_4leg():
    return json.loads((GOLDEN_DIR / "autogen_4leg_case.json").read_text())


@pytest.fixture
def gpu_card():
    """The card's name from nvidia-smi; skips the test where there is none.
    Decided here, while the test runs, never at import or collection."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        pytest.skip("no NVIDIA GPU: nvidia-smi not found")
    r = subprocess.run([smi, "--query-gpu=name", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        pytest.skip("no NVIDIA GPU: nvidia-smi lists none")
    return r.stdout.strip().splitlines()[0]
