"""Test configuration: force CPU with 8 virtual devices.

Must run before jax initializes a backend; tests exercise the multi-device
sharding paths on a virtual 8-device CPU mesh and Pallas kernels in
interpreter mode. Tests that need an NVIDIA GPU carry the `gpu` marker and
take the `gpu_env` fixture, which skips them on a machine without one and
otherwise hands them the environment of a child Python that runs on the
card (this process stays on the CPU): `python -m pytest -m gpu`.
"""

import os
import shutil
import subprocess
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# persistent compilation cache: re-runs of the suite skip XLA compiles
_cache_dir = os.path.join(os.path.dirname(__file__), "..", ".jax_cache")
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", os.path.abspath(_cache_dir))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def gpu_env():
    """Environment for a child Python on the GPU; skips the test when the
    machine has none. Decided here, when the test runs, never while a
    module is imported."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("needs an NVIDIA GPU: no nvidia-smi on this machine")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    probe = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True,
    )
    if probe.stdout.strip() != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX finds {probe.stdout.strip()!r}")
    return env


@pytest.fixture(scope="session")
def small_skybox():
    """Deterministic small skybox texture, fp32 (64, 128, 4) of k/255."""
    from bhr_tpu.io.skybox import load_skybox

    return load_skybox(None, seed=7, shape=(64, 128))


@pytest.fixture(scope="session")
def rng():
    return np.random.RandomState(0)
