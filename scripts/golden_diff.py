#!/usr/bin/env python
"""At-scale numerics parity sweep: XLA oracle vs the Pallas kernel path,
per-pixel, across the BASELINE config suite.

The reference's WGSL render cannot be produced here (no wgpu); the
line-faithful XLA oracle (ops/trace.py transcribes ray_tracer_euler.wgsl
operation-by-operation) stands in as the reference numerics, and the
GPU kernel is diffed against it per pixel at each config's REAL
resolution.

The oracle side renders through the deflection-cache path
(cache_deflection=True): trace_rays compiled as its own program + the
staged shade_image — so the diffed IMAGE and the STATUS plane used by the
localization gate come from the SAME oracle compilation (using a second,
differently-fused compilation for the status would mislabel knife-edge
pixels).

Usage:
  python scripts/golden_diff.py [out_dir]            # config 1 only (fast)
  python scripts/golden_diff.py --all [out_dir]      # all five configs
  python scripts/golden_diff.py --configs 1,4 [dir]  # subset

Prints one JSON line per config with the per-pixel L_inf (u8 levels) and
mismatch fraction; config 1 also writes oracle/kernel PNGs and the
abs-diff visualization. Both render on the live backend (the GPU, where
the kernel is compiled; on the CPU it is interpreted and the 4K configs
take a long time).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

# (name, width, height, max_steps, renderer kwargs, scene kwargs)
CONFIGS = {
    1: ("256x256_schwarzschild_steps200", 256, 256, 200, {}, {}),
    2: ("800x600_default_steps500", 800, 600, 500, {}, {}),
    3: ("1920x1080_steps500_headline", 1920, 1080, 500, {}, {}),
    4: ("1080p_rk4_adaptive_disk_steps500", 1920, 1080, 500,
        {"integrator": "rk4", "adaptive": True, "disk": True}, {}),
    5: ("4k_kerr09_disk_steps2000", 3840, 2160, 2000,
        {"model": "kerr", "disk": True}, {"spin": 0.9}),
}


# a mismatch above this many u8 levels cannot be a ±1 quantization flip;
# the chaotic-amplification claim is asserted for these only
LARGE_THRESH = 16


def status_boundary_mask(status):
    """Pixels whose 4-neighborhood contains a different termination status."""
    b = np.zeros(status.shape, bool)
    b[:-1, :] |= status[:-1, :] != status[1:, :]
    b[1:, :] |= status[1:, :] != status[:-1, :]
    b[:, :-1] |= status[:, :-1] != status[:, 1:]
    b[:, 1:] |= status[:, 1:] != status[:, :-1]
    return b


def boundary_distance_stats_mask(b, mismatched, cap=64):
    """(max Chebyshev distance from any mismatched pixel to the nearest
    True pixel of mask `b`, fraction within 2 px). Iterative
    8-neighborhood dilation (no scipy in the image)."""
    mismatched = np.asarray(mismatched, bool)
    if not mismatched.any():
        return 0, 1.0
    if not b.any():
        return cap, 0.0
    dist = np.where(b, 0, cap).astype(np.int32)
    cur = b.copy()
    for d in range(1, cap):
        if not (mismatched & (dist >= cap)).any():
            break
        r = cur.copy()
        r[:-1] |= cur[1:]
        r[1:] |= cur[:-1]
        n = r.copy()
        n[:, :-1] |= r[:, 1:]
        n[:, 1:] |= r[:, :-1]
        dist[n & ~cur] = d
        cur = n
    md = dist[mismatched]
    return int(md.max()), float((md <= 2).mean())


def boundary_distance_stats(status, mismatched, cap=64):
    """Distance stats against ONE program's status-boundary mask.

    The claim under test: kernel-vs-oracle mismatches are 1-ulp
    FMA-contraction differences amplified by the chaotic photon-sphere /
    disk-rim flow — so every one of them must hug a termination-status
    boundary. A full-byte-wrong pixel in a region interior would show up
    here as a large distance."""
    return boundary_distance_stats_mask(status_boundary_mask(status),
                                        mismatched, cap)


def _within2_mask(b):
    """Pixels within Chebyshev distance 2 of a True pixel of `b`."""
    cur = b.copy()
    for _ in range(2):
        r = cur.copy()
        r[:-1] |= cur[1:]
        r[1:] |= cur[:-1]
        n = r.copy()
        n[:, :-1] |= r[:, 1:]
        n[:, 1:] |= r[:, :-1]
        cur = n
    return cur


def run_config(idx, out_dir, check=False):
    import jax.numpy as jnp

    from bhr_tpu import BlackHoleRenderer, Camera, SceneParams

    name, w, h, steps, rkw, skw = CONFIGS[idx]
    cam = Camera.new([15.0, 5.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    skw = {k: jnp.float32(v) for k, v in skw.items()}
    scene = SceneParams(screen_width=w, screen_height=h, max_steps=steps, **skw)

    # cache_deflection exposes the oracle's TraceResult (status plane) from
    # the SAME integration that shades the image (the cached path's staged
    # shade_image is the oracle pipeline verbatim)
    oracle = BlackHoleRenderer(w, h, use_pallas=False, cache_deflection=True,
                               **rkw)
    oracle.render_frame(cam, scene)
    a = oracle.get_image_data().astype(np.int32)
    status_oracle = np.asarray(oracle._deflection_result.status)

    kernel = BlackHoleRenderer(w, h, use_pallas=True, **rkw)
    kernel.render_frame(cam, scene)
    b = kernel.get_image_data().astype(np.int32)

    if idx == 1 and out_dir:
        oracle.save_image(os.path.join(out_dir, "oracle_256.png"))
        kernel.save_image(os.path.join(out_dir, "kernel_256.png"))

    diff = np.abs(a - b)[..., :3]
    linf_u8 = int(diff.max())
    mismatch = float((diff.max(axis=-1) > 0).mean())

    # localization proof: LARGE mismatches must sit on/next to a
    # termination-status boundary (the chaotic-amplification claim).
    # diff > 0 also counts benign ±1-LSB quantization flips — the kernel
    # fuses shading while the oracle stages it, so escape-direction LSBs
    # differ everywhere and any value near a u8 rounding edge can flip by
    # one level in a region interior. Those are reported separately and
    # are NOT expected to localize; only the chaotic amplification
    # (> LARGE_THRESH levels) is.
    from bhr_tpu.ops.pallas_trace import pallas_trace_image

    result = pallas_trace_image(cam, scene, kernel.config)
    status = np.asarray(result.status)
    max_bdist, frac_within2 = boundary_distance_stats(
        status, diff.max(axis=-1) > 0
    )
    large = diff.max(axis=-1) > LARGE_THRESH

    # The localization criterion: a 1-ulp FMA divergence between two separately
    # compiled programs can only produce a large color diff by flipping a
    # DISCRETE outcome. That shows up as either
    #   (a) proximity (<= 2 px) to a termination-status boundary in EITHER
    #       program's status plane (the ulp moves the boundary itself), or
    #   (b) the pixel's own status differing between oracle and kernel —
    #       direct evidence the trajectory sits on the chaotic fold. These
    #       pixels can be blob-INTERIOR spatially (config 4's round-3
    #       stragglers: rays hovering at the capture sphere r = 1.05 rs
    #       for hundreds of steps, oracle exhausting max_steps while the
    #       kernel captures — all 77 of them status flips, 0 hit-branch,
    #       0 unexplained).
    # A genuine interior numerics bug (smoothly wrong colors, no discrete
    # flip) stays unexplained and fails the gate; a systematic termination
    # bug would blow the large_mismatch_frac ceiling below.
    large_bdist, large_within2 = boundary_distance_stats(status, large)
    flips = status_oracle != status
    b_union = status_boundary_mask(status) | status_boundary_mask(status_oracle)
    _, large_within2_union = boundary_distance_stats_mask(b_union, large)
    explained = ~large | flips | _within2_mask(b_union)
    n_large = int(large.sum())
    large_explained = (
        float((large & explained).sum() / n_large) if n_large else 1.0
    )
    large_flip_frac = (
        float((large & flips).sum() / n_large) if n_large else 0.0
    )

    if idx == 1 and out_dir:
        from PIL import Image

        vis = np.zeros((h, w, 3), np.uint8)
        vis[..., 0] = np.clip(diff.max(axis=-1) * 64, 0, 255)
        Image.fromarray(vis, "RGB").save(os.path.join(out_dir, "absdiff_x64.png"))

    print(
        json.dumps(
            {
                "config": name,
                "linf_u8_levels": linf_u8,
                "linf_unit_scale": round(linf_u8 / 255.0, 6),
                "mismatched_pixel_frac": round(mismatch, 6),
                "max_px_to_status_boundary": max_bdist,
                "frac_mismatches_within_2px_of_boundary": round(frac_within2, 4),
                "large_mismatch_frac": round(float(large.mean()), 8),
                "large_mismatch_max_px_to_boundary": large_bdist,
                "large_mismatch_frac_within_2px": round(large_within2, 4),
                "large_frac_within_2px_union_boundary": round(
                    large_within2_union, 4
                ),
                "large_frac_status_flip": round(large_flip_frac, 4),
                "large_frac_explained": round(large_explained, 4),
                "kernel_backend": kernel.device.platform,
                "note": "oracle = line-faithful XLA transcription of "
                "ray_tracer_euler.wgsl (the reference GPU render is not "
                "producible in this environment)",
            }
        ),
        flush=True,
    )
    if check:
        # the localization gate: every large mismatch must be EXPLAINED by
        # a discrete-outcome divergence (see the criterion comment above),
        # and the quantitative ceilings keep the gate sensitive to
        # systematic bugs that WOULD localize (e.g. a wrong capture radius
        # flips statuses everywhere along the shadow edge)
        if large.any() and large_explained < 1.0:
            raise SystemExit(
                f"{name}: large (> {LARGE_THRESH} u8) mismatches not all "
                "explained by a status flip or <= 2 px proximity to an "
                f"oracle/kernel status boundary (frac={large_explained:.4f})"
            )
        if float(large.mean()) > 1e-4:
            raise SystemExit(
                f"{name}: large-mismatch fraction {float(large.mean()):.2e} "
                "> 1e-4 ceiling"
            )
        if mismatch > 0.01:
            raise SystemExit(
                f"{name}: mismatched-pixel fraction {mismatch:.4f} > 1% "
                "ceiling"
            )


def main():
    p = argparse.ArgumentParser()
    p.add_argument("out_dir", nargs="?", default="golden_diff_out")
    p.add_argument("--all", action="store_true", help="run all five configs")
    p.add_argument("--configs", help="comma-separated config indices (1-5)")
    p.add_argument("--check", action="store_true",
                   help="exit nonzero unless every large mismatch is "
                        "explained by a status flip or <= 2 px proximity "
                        "to either program's status boundary, and the "
                        "mismatch-fraction ceilings hold")
    args = p.parse_args()
    os.makedirs(args.out_dir, exist_ok=True)

    if args.configs:
        idxs = [int(x) for x in args.configs.split(",")]
    elif args.all:
        idxs = [1, 2, 3, 4, 5]
    else:
        idxs = [1]
    for i in idxs:
        run_config(i, args.out_dir, check=args.check)
    return 0


if __name__ == "__main__":
    sys.exit(main())
