"""The persistent compile cache: JAX_COMPILATION_CACHE_DIR wins when set,
otherwise a fixed directory inside the checkout; every entry point turns
it on."""

import os

import jax
import pytest

from bhr_tpu.utils import compile_cache

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_selects_the_cache_dir(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert compile_cache.enable_compile_cache() == str(tmp_path / "cc")
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "cc")
    assert (tmp_path / "cc").is_dir()


def test_default_cache_dir_is_fixed_inside_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == os.path.join(REPO, ".jax_cache")
    assert compile_cache.DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")


def test_empty_env_var_falls_back_to_the_default(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    assert compile_cache.cache_dir() == compile_cache.DEFAULT_CACHE_DIR


@pytest.mark.parametrize("entry", ["app", "bench", "graft"])
def test_entry_points_enable_the_cache(monkeypatch, entry):
    """app.main, bench.main and __graft_entry__.entry all call
    enable_compile_cache."""
    import sys

    calls = []
    monkeypatch.setattr(compile_cache, "enable_compile_cache",
                        lambda: calls.append(1) or "x")
    if entry == "app":
        from bhr_tpu import app

        app.main(["--frames", "1", "--width", "8", "--height", "8",
                  "--max-steps", "2", "--chunk", "1"])
    elif entry == "bench":
        sys.path.insert(0, REPO)
        import bench

        import bhr_tpu
        from bhr_tpu.ops import pallas_trace

        class Stop(Exception):
            pass

        def stop(*a, **k):
            raise Stop

        # pretend to be on the GPU, then stop before any frame renders
        monkeypatch.setattr(pallas_trace, "kernel_mode", lambda: "compiled")
        monkeypatch.setattr(bhr_tpu, "BlackHoleRenderer", stop)
        with pytest.raises(Stop):
            bench.main()
    else:
        sys.path.insert(0, REPO)
        import __graft_entry__

        __graft_entry__.entry()
    assert calls


def test_bench_fails_without_a_gpu():
    """bench.py measures the GPU: on the CPU it exits instead of timing the
    interpreter or the CPU backend."""
    import sys

    sys.path.insert(0, REPO)
    import bench

    with pytest.raises(SystemExit, match="no GPU"):
        bench.main()
