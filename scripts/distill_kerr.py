#!/usr/bin/env python
"""Distill the Kerr neural surrogate for a scene, on-device, and gauge it.

Drives the production path — BlackHoleRenderer.distill() on a
model="kerr" renderer (models/neural_kerr.distill_for_scene_kerr):
oracle rollouts on the scene's (r0 band, rs, a*, camera latitude)
manifold against the exact Kerr-Schild Hamiltonian, warm-started from
the committed general net. The default arguments are the library
default scene (camera (0,5,15), rs=2, a*=0.9) — the configuration
`scripts/neural_quality.py --model kerr` gauges.

Reference: docs/ROADMAP.md:1217-1337 — GravLensX (the roadmap's cited
speedup) trains per-scene Kerr networks; >0.99 SSIM is its stated
success criterion.

Usage:
    python scripts/distill_kerr.py                       # default scene
    python scripts/distill_kerr.py --spin 0.5 --rays 4000000
    python scripts/distill_kerr.py --out bhr_tpu/assets/neural_kerr_default.npz
"""

import argparse
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, default=4_000_000)
    ap.add_argument("--steps", type=int, default=30_000)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spin", type=float, default=0.9)
    ap.add_argument("--rs", type=float, default=2.0)
    ap.add_argument("--r-margin", type=float, default=1.3)
    ap.add_argument("--cth-margin", type=float, default=0.2)
    ap.add_argument("--eval-rays", type=int, default=131_072)
    ap.add_argument("--frame-width", type=int, default=1920,
                    help="target frame shape (sets the psi-band aspect)")
    ap.add_argument("--frame-height", type=int, default=1080)
    ap.add_argument("--boundary-frac", type=float, default=None,
                    help="fraction of rays concentrated at the per-plane "
                         "critical fold (default: the library's 0.35)")
    ap.add_argument("--err-cap", type=float, default=None,
                    help="per-sample direction-error cap in degrees "
                         "(default: the library's 5.0)")
    ap.add_argument("--init", type=str, default="",
                    help="warm-start weights (default: the committed "
                         "general Kerr net)")
    ap.add_argument(
        "--out", type=str,
        default=str(REPO / "bhr_tpu" / "assets" / "neural_kerr_default.npz"),
    )
    ap.add_argument("--log", type=str, default="",
                    help="append the metrics record to this jsonl")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--train-precision", default="default",
                    choices=["default", "float32", "highest"],
                    help="matmul precision for the whole distill process "
                         "(dataset gen + training). 'default' leaves fp32 "
                         "products to the backend (bf16 or TF32 passes on "
                         "accelerators, ~0.2%% relative); 'float32'/"
                         "'highest' train fp32-native weights, which the "
                         "renderer then serves at its 'highest' tier.")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.train_precision != "default":
        jax.config.update("jax_default_matmul_precision",
                          args.train_precision)
    import jax.numpy as jnp

    from bhr_tpu import BlackHoleRenderer

    if args.quick:
        args.rays = min(args.rays, 100_000)
        args.steps = min(args.steps, 1_000)
        args.eval_rays = 16_384

    kw = {}
    if args.init:
        kw["neural_params"] = args.init
    # IMPORTANT: the scene's screen dims set the aspect ratio that
    # renderer.distill's automatic psi-band narrowing derives the
    # training band from — they must match the frames the asset will
    # serve (a 4:3 dummy scene leaves 16:9 corner pixels ~2.6 deg
    # outside the trained band; measured as the d1-d3 far-field floor).
    r = BlackHoleRenderer(
        args.frame_width, args.frame_height, integrator="neural",
        model="kerr", **kw,
    )
    scene = r.scene.replace(
        spin=jnp.float32(args.spin),
        schwarzschild_radius=jnp.float32(args.rs),
    )
    print(f"device={jax.devices()[0]} rays={args.rays} steps={args.steps} "
          f"spin={args.spin} rs={args.rs}", flush=True)
    t0 = time.time()
    extra = {}
    if args.boundary_frac is not None:
        extra["boundary_frac"] = args.boundary_frac
    if args.err_cap is not None:
        extra["err_cap_deg"] = args.err_cap
    metrics = r.distill(
        scene=scene, rays=args.rays, steps=args.steps, seed=args.seed,
        save=args.out, lr=args.lr, r_margin=args.r_margin,
        cth_margin=args.cth_margin, eval_rays=args.eval_rays, **extra,
    )
    rec = {
        "out": args.out,
        "spin": args.spin,
        "rs": args.rs,
        "rays": args.rays,
        "steps": args.steps,
        "lr": args.lr,
        "r_margin": args.r_margin,
        "cth_margin": args.cth_margin,
        "init": args.init or "general",
        "boundary_frac": extra.get("boundary_frac", "lib-default-0.35"),
        "err_cap_deg": extra.get("err_cap_deg", "lib-default-5.0"),
        "train_precision": args.train_precision,
        "wall_s": round(time.time() - t0, 1),
        **{k: round(float(v), 6) for k, v in metrics.items()},
    }
    print(json.dumps(rec), flush=True)
    if args.log:
        with open(args.log, "a") as f:
            f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
