"""The geodesic kernel compiled by Triton against the XLA oracle on the same
card, in both math tiers. The test skips without a GPU (the `gpu_env`
fixture decides when it runs); on the card, `python -m pytest -m gpu`.

The test process stays pinned to the CPU (conftest.py), so the check runs
in a child Python on the card: this file run as a script."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.gpu
def test_compiled_kernel_matches_oracle_on_the_card(gpu_env):
    env = dict(gpu_env, PYTHONPATH=REPO)
    run = subprocess.run([sys.executable, os.path.abspath(__file__)],
                         env=env, cwd=REPO, capture_output=True, text=True)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-4000:]


def _check_on_card():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bhr_tpu.core.camera import Camera
    from bhr_tpu.core.scene import SceneParams
    from bhr_tpu.ops.pallas_trace import pallas_trace_image
    from bhr_tpu.ops.trace import TraceConfig
    from bhr_tpu.renderer import BlackHoleRenderer, trace_image

    assert jax.devices()[0].platform == "gpu", jax.devices()
    cam = Camera.default()
    for fast_math in (False, True):
        for config in (
            TraceConfig(fast_math=fast_math),
            TraceConfig(integrator="rk4", adaptive=True, disk=True,
                        fast_math=fast_math),
            TraceConfig(model="kerr", disk=True, fast_math=fast_math),
        ):
            scene = SceneParams(
                screen_width=320, screen_height=180, max_steps=500,
                spin=jnp.float32(0.9 if config.model == "kerr" else 0.0))
            kern = pallas_trace_image(cam, scene, config)
            with jax.default_matmul_precision("highest"):
                orac = trace_image(cam, scene, config, use_pallas=False)
            same = (np.asarray(kern.status) == np.asarray(orac.status)) & (
                np.asarray(kern.steps) == np.asarray(orac.steps))
            m = same & (np.asarray(orac.status) != 2)
            vd = np.abs(np.asarray(kern.final_vel)
                        - np.asarray(orac.final_vel)).max(-1)
            print(config.model, config.integrator, fast_math, same.mean(),
                  (vd[m] <= 1e-4).mean())
            assert same.mean() >= 0.995
            assert (vd[m] <= 1e-4).mean() >= 0.995
    r = BlackHoleRenderer(64, 48)
    assert r.use_pallas and r.device.platform == "gpu"
    frame = np.asarray(r.render_frame())
    assert frame.shape == (48, 64, 4) and (frame[..., 3] == 255).all()


if __name__ == "__main__":
    _check_on_card()
