#!/usr/bin/env python
"""Pallas-Triton geodesic kernel vs the XLA oracle, on one GPU.

Times `OrbitAnimator.render_frames` (one fused lax.scan per call, warm,
ended with block_until_ready) with the kernel and with `trace_rays`,
taking turns in one process (kernel, XLA, XLA, kernel per repeat), in two
cells:

  headline  1920x1080, max_steps 500, Schwarzschild, 120 frames
  kerr4k    3840x2160, max_steps 2000, exact Kerr a*=0.9 + disk, 2 frames

The kernel runs in the library's default (exact) math tier. `--sweep`
also times the kernel in both cells over rays-per-block and
warps-per-block, and at 1080p x 500 its two math tiers (the exact sqrt +
divide renormalization against fast_math's rsqrt; the Kerr-Schild flavor
renormalizes nothing). Prints one JSON line per measurement and a summary
line; fails without a GPU.

    python scripts/kernel_ab.py [--cells headline,kerr4k] [--repeats 2] [--sweep]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

CELLS = {
    "headline": dict(width=1920, height=1080, max_steps=500, frames=120,
                     model="schwarzschild", disk=False, spin=0.0),
    "kerr4k": dict(width=3840, height=2160, max_steps=2000, frames=2,
                   model="kerr", disk=True, spin=0.9),
}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def emit(**kw):
    print(json.dumps(kw), flush=True)


def timed(anim, n, start, scene):
    t0 = time.perf_counter()
    frames = anim.render_frames(n, start_frame=start, scene=scene, packed=True)
    frames.block_until_ready()
    return (time.perf_counter() - t0) * 1e3 / n, frames


def make(cell, use_pallas, fast_math=False):
    from bhr_tpu import BlackHoleRenderer, SceneParams
    from bhr_tpu.animation import OrbitAnimator

    c = CELLS[cell]
    r = BlackHoleRenderer(c["width"], c["height"], model=c["model"],
                          disk=c["disk"], use_pallas=use_pallas,
                          fast_math=fast_math)
    scene = SceneParams(screen_width=c["width"], screen_height=c["height"],
                        max_steps=c["max_steps"], spin=jnp.float32(c["spin"]))
    return OrbitAnimator(r), scene


def ab(cell, repeats):
    c = CELLS[cell]
    n = c["frames"]
    runs = {True: make(cell, True), False: make(cell, False)}
    first = {}
    for use_pallas, (anim, scene) in runs.items():
        t0 = time.perf_counter()
        _, frames = timed(anim, n, 0, scene)
        timed(anim, n, n, scene)  # the first call after compiling runs slow
        first[use_pallas] = np.asarray(frames[0]).view(np.uint8)
        emit(cell=cell, impl="kernel" if use_pallas else "xla",
             warmup_s=round(time.perf_counter() - t0, 3))
    differ = float(np.mean(first[True] != first[False]))
    emit(cell=cell, frame0_u8_differ=differ)
    ms = {True: [], False: []}
    for rep in range(repeats):
        for use_pallas in (True, False, False, True):
            anim, scene = runs[use_pallas]
            t, _ = timed(anim, n, n * (1 + rep), scene)
            ms[use_pallas].append(t)
            emit(cell=cell, impl="kernel" if use_pallas else "xla", rep=rep,
                 ms_per_frame=t)
    out = {
        "cell": cell,
        "kernel_ms_median": float(np.median(ms[True])),
        "xla_ms_median": float(np.median(ms[False])),
        "kernel_ms": ms[True],
        "xla_ms": ms[False],
    }
    out["speedup"] = out["xla_ms_median"] / out["kernel_ms_median"]
    emit(**out)
    return out


def _time_kernel(cell, n, fast_math=False):
    """Three warm timings (ms/frame) of n-frame calls of a fresh kernel."""
    jax.clear_caches()
    anim, scene = make(cell, True, fast_math)
    timed(anim, n, 0, scene)
    timed(anim, n, 0, scene)
    return [timed(anim, n, n * (k + 1), scene)[0] for k in range(3)]


def sweep(cells):
    from bhr_tpu.ops import pallas_trace as pt

    frames = {"headline": 24, "kerr4k": 2}
    for cell in cells:
        for block, warps in ((64, 2), (128, 4), (128, 2), (256, 4), (256, 8),
                             (512, 8), (512, 16)):
            old = pt.DEFAULT_BLOCK, pt.DEFAULT_NUM_WARPS
            pt.DEFAULT_BLOCK, pt.DEFAULT_NUM_WARPS = block, warps
            emit(sweep="block_warps", cell=cell, block=block, num_warps=warps,
                 ms_per_frame=_time_kernel(cell, frames[cell]))
            pt.DEFAULT_BLOCK, pt.DEFAULT_NUM_WARPS = old
    for fast_math in (True, False) * 2:
        emit(sweep="math_tier", cell="headline", fast_math=fast_math,
             ms_per_frame=_time_kernel("headline", frames["headline"], fast_math))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="headline,kerr4k")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)

    from bhr_tpu.ops.pallas_trace import KERNEL_COMPILED, kernel_mode
    from bhr_tpu.utils.compile_cache import enable_compile_cache

    if kernel_mode() != KERNEL_COMPILED:
        raise SystemExit("kernel_ab.py measures the GPU kernel; no GPU found")
    enable_compile_cache()
    dev = jax.devices()[0]
    emit(card=card(), device_kind=dev.device_kind, count=len(jax.devices()))
    results = [ab(c, args.repeats) for c in args.cells.split(",") if c]
    if args.sweep:
        sweep(list(CELLS))
    emit(summary={r["cell"]: round(r["speedup"], 3) for r in results},
         kernel_wins_all=all(r["speedup"] > 1.0 for r in results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
