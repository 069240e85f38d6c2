#!/usr/bin/env python
"""Headline benchmark: 1920x1080, max_steps=500 Schwarzschild frames.

BASELINE.json's target configuration. Frames render through the fused
lax.scan animation path (the analog of the reference's continuous
animation loop, main.rs:1110-1131): one warm-up scan compiles, one more
settles, then BHR_BENCH_REPEATS timed scans of BHR_BENCH_FRAMES frames
each, every one ended with block_until_ready. The value is the median
ms/frame. Runs on a GPU only: without one it exits with an error.

Prints ONE JSON line:
  {"metric": ..., "value": <median ms/frame>, "unit": "ms", ...}

Env knobs: BHR_BENCH_W/H/STEPS/FRAMES/REPEATS, BHR_BENCH_ORACLE=1 (XLA
path), BHR_BENCH_TEXTURE=bilinear|nearest|luma (render against a 4K
equirect texture skybox instead of the analytic star field — the
reference's actual workload shape), BHR_BENCH_TEXSUB=2|checker,
BHR_BENCH_MULTIRES=N, BHR_BENCH_MODEL/DISK/INTEGRATOR/ADAPTIVE/SPIN,
BHR_BENCH_PLUGIN=path.py, BHR_BENCH_NEURAL_WEIGHTS/NEURAL_PRECISION
(surrogate asset / matmul tier).
"""

import json
import os
import sys
import time

import jax
import numpy as np


def main():
    from bhr_tpu.ops.pallas_trace import KERNEL_COMPILED, kernel_mode
    from bhr_tpu.utils.compile_cache import enable_compile_cache

    if kernel_mode() != KERNEL_COMPILED:
        raise SystemExit("bench.py measures the GPU; JAX found no GPU")
    enable_compile_cache()
    width = int(os.environ.get("BHR_BENCH_W", 1920))
    height = int(os.environ.get("BHR_BENCH_H", 1080))
    max_steps = int(os.environ.get("BHR_BENCH_STEPS", 500))
    n_frames = int(os.environ.get("BHR_BENCH_FRAMES", 120))
    use_pallas = os.environ.get("BHR_BENCH_ORACLE", "0") != "1"
    texture = os.environ.get("BHR_BENCH_TEXTURE", "")
    model = os.environ.get("BHR_BENCH_MODEL", "schwarzschild")
    spin = float(os.environ.get("BHR_BENCH_SPIN", "0.9"))
    disk = os.environ.get("BHR_BENCH_DISK", "0") == "1"
    integrator = os.environ.get("BHR_BENCH_INTEGRATOR", "euler")
    adaptive = os.environ.get("BHR_BENCH_ADAPTIVE", "0") == "1"
    # BHR_BENCH_PLUGIN=path.py benches the runtime-swapped physics tier
    # (model="custom" — the analog of the reference's --shader hot-swap,
    # src/lib.rs:425-429)
    plugin = os.environ.get("BHR_BENCH_PLUGIN", "")
    if plugin:
        model = "custom"

    from bhr_tpu import BlackHoleRenderer, SceneParams
    from bhr_tpu.animation import OrbitAnimator

    skybox = None
    texture_filter = "bilinear"
    if texture:
        # the reference's real workload: a 4K equirectangular star map
        # sampled per terminated ray (src/ray_tracer_euler.wgsl:101-105)
        from bhr_tpu.io.skybox import procedural_starfield

        skybox = procedural_starfield(2048, 4096, seed=2020)
        texture_filter = (
            texture if texture in ("bilinear", "nearest", "luma") else "luma"
        )

    texsub = os.environ.get("BHR_BENCH_TEXSUB", "1")
    texsub = texsub if texsub == "checker" else int(texsub)
    extra = {}
    if integrator == "neural":
        # Phase 5 surrogate: BHR_BENCH_NEURAL_WEIGHTS selects the asset
        # (default = the general net; the orbit-distilled *_orbit.npz is
        # the right one for this benchmark's camera path)
        w_env = os.environ.get("BHR_BENCH_NEURAL_WEIGHTS")
        if w_env:
            extra["neural_params"] = w_env
        # matmul tier: auto resolves from the asset's train_precision meta;
        # bf16/highest override (models/neural.tier_matmul_args)
        extra["neural_precision"] = os.environ.get(
            "BHR_BENCH_NEURAL_PRECISION", "auto"
        )
    if plugin:
        extra["custom_physics"] = plugin
    renderer = BlackHoleRenderer(
        width, height, integrator, use_pallas=use_pallas, skybox=skybox,
        texture_filter=texture_filter, texture_subsample=texsub,
        model=None if plugin else model,
        disk=disk, adaptive=adaptive, **extra,
    )
    import jax.numpy as jnp

    scene = SceneParams(
        screen_width=width, screen_height=height, max_steps=max_steps,
        spin=jnp.float32(spin if model.startswith("kerr") else 0.0),
    )
    anim = OrbitAnimator(renderer)

    multires = int(os.environ.get("BHR_BENCH_MULTIRES", "0"))
    if multires:
        # roadmap Phase 4-1 mode: 1/divisor-res geodesics + edge fix-up
        from bhr_tpu.core.camera import orbit_camera
        from bhr_tpu.ops.multires import render_multires

        from bhr_tpu.models.disk import DiskParams

        disk_params = (
            DiskParams.for_scene(scene.schwarzschild_radius) if disk else None
        )

        def frame_fn(c, t):
            # renderer.skybox is the packed (and tier-transformed) texture;
            # renderer._sample_filter matches it (corner-packed -> bilinear)
            return c, render_multires(
                orbit_camera(t), scene, renderer.skybox,
                disk_params, renderer._lut,
                config=renderer.config, divisor=multires,
                texture_filter=renderer._sample_filter,
                texture_subsample=texsub, packed=True,
            )

        scan = jax.jit(lambda ts: jax.lax.scan(frame_fn, 0, ts)[1])

        def run(n, start):
            ts = (jnp.arange(n, dtype=jnp.float32) + start) / 60.0
            return jax.block_until_ready(scan(ts))

    else:

        def run(n, start):
            frames = anim.render_frames(
                n, fps=60.0, start_frame=start, scene=scene, packed=True
            )
            jax.block_until_ready(frames)
            return frames

    run(n_frames, 0)  # compile
    run(n_frames, n_frames)  # the first call after compiling runs slow
    repeats = max(1, int(os.environ.get("BHR_BENCH_REPEATS", "3")))
    times_ms = []
    for rep in range(repeats):
        t0 = time.perf_counter()
        run(n_frames, n_frames * (2 + rep))
        times_ms.append((time.perf_counter() - t0) * 1000.0 / n_frames)
    value = float(np.median(times_ms))
    mray_steps = width * height * max_steps / (value / 1000.0) / 1e6
    suffix = f"_tex-{texture_filter}" if texture else ""
    if texture and texsub != 1:
        suffix += f"_texsub{texsub}"
    if multires:
        suffix += f"_multires{multires}"
    if model != "schwarzschild":
        suffix += f"_{model}"
    if disk:
        suffix += "_disk"
    if integrator != "euler":
        suffix += f"_{integrator}"
    if adaptive:
        suffix += "_adaptive"
    if integrator == "neural":
        suffix += f"_prec-{renderer.neural_precision}"
    dev = jax.devices()[0]
    print(
        json.dumps(
            {
                "metric": f"ms_per_frame_{width}x{height}_steps{max_steps}{suffix}",
                "value": value,
                "unit": "ms",
                "ms_per_frame": times_ms,
                "mray_steps_per_sec": mray_steps,
                "frames": n_frames,
                "device": {"platform": dev.platform, "kind": dev.device_kind,
                           "count": len(jax.devices())},
                "pallas": use_pallas,
                "texture": texture or None,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
