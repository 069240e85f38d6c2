#!/usr/bin/env python
"""Train the Phase-5 neural geodesic surrogate (models/neural.py).

Generates oracle-traced training data (ops/trace.py at the library-default
workload: max_steps=500, dt=0.1), trains the MLP with Adam fully on-device
(one fused lax.scan per log window), evaluates on held-out rays, and writes
the weights to bhr_tpu/assets/neural_schwarzschild.npz (the renderer's
default for integrator="neural").

Reference: docs/ROADMAP.md:1217-1337 (the roadmap's GeodesicMLP plan;
success criteria "inference < 1/10 integration time, SSIM > 0.99").

Usage:
    python scripts/train_neural.py                 # full run (GPU)
    python scripts/train_neural.py --cpu --quick   # smoke run
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
    ap.add_argument("--eval-rays", type=int, default=262_144)
    ap.add_argument("--steps", type=int, default=40_000)
    ap.add_argument("--batch", type=int, default=16_384)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--hidden", type=str, default="96,96,96")
    ap.add_argument("--max-steps", type=int, default=500)
    ap.add_argument("--dt", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--out",
        type=str,
        default=str(REPO / "bhr_tpu" / "assets" / "neural_schwarzschild.npz"),
    )
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    ap.add_argument(
        "--dataset", type=str, default="",
        help="cached dataset npz (scripts/neural_cache_ds.py format) — "
             "skips oracle tracing; --rays/--r-range/--rs-range are then "
             "only recorded as metadata if they match the cache",
    )
    ap.add_argument(
        "--quick", action="store_true", help="tiny smoke run (CI-sized)"
    )
    ap.add_argument("--r-range", type=str, default="3,60",
                    help="camera-radius sampling range lo,hi")
    ap.add_argument("--rs-range", type=str, default="0.5,4.0",
                    help="Schwarzschild-radius sampling range lo,hi")
    ap.add_argument("--init", type=str, default="",
                    help="warm-start weights to fine-tune (distillation)")
    ap.add_argument("--fresh", action="store_true",
                    help="train from scratch even with --focus (use with a "
                         "custom --hidden; warm-starting would override the "
                         "width with the init net's)")
    ap.add_argument(
        "--focus", action="store_true",
        help="distill for the default orbit workload: narrows (r0, rs) to "
             "the benchmark manifold (r0 in [13,19], rs in [1.5,2.5]), "
             "warm-starts from the general weights, writes *_orbit.npz",
    )
    args = ap.parse_args()
    if args.focus:
        args.r_range = "13,19"
        args.rs_range = "1.5,2.5"
        default_general = str(
            REPO / "bhr_tpu" / "assets" / "neural_schwarzschild.npz"
        )
        if (
            not args.init
            and not args.fresh
            and pathlib.Path(default_general).exists()
        ):
            args.init = default_general
        if args.out == default_general:
            args.out = str(
                REPO / "bhr_tpu" / "assets" / "neural_schwarzschild_orbit.npz"
            )

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from bhr_tpu.models import neural

    if args.quick:
        args.rays = min(args.rays, 200_000)
        args.eval_rays = 32_768
        args.steps = min(args.steps, 2_000)
        args.max_steps = min(args.max_steps, 200)

    hidden = tuple(int(x) for x in args.hidden.split(","))
    r_range = tuple(float(x) for x in args.r_range.split(","))
    rs_range = tuple(float(x) for x in args.rs_range.split(","))
    warm = None
    if args.init:
        warm, init_meta = neural.load_params(args.init)
        hidden = tuple(w.shape[1] for w, _ in warm[:-1])
    key = jax.random.PRNGKey(args.seed)
    k_train, k_eval, k_fit = jax.random.split(key, 3)

    print(
        f"device={jax.devices()[0]} rays={args.rays} steps={args.steps} "
        f"hidden={hidden} max_steps={args.max_steps} r={r_range} rs={rs_range}"
        + (f" warm_start={args.init}" if args.init else ""),
        flush=True,
    )
    t0 = time.time()
    if args.dataset:
        sys.path.insert(0, str(REPO / "scripts"))
        from neural_cache_ds import load as load_cached

        dataset, eval_set, cache_meta = load_cached(args.dataset, with_meta=True)
        args.rays = int(dataset["r0"].shape[0])
        # the asset meta must record the CACHE's generation domain, not the
        # CLI args (the renderer's extrapolation warning reads it). Caches
        # written before provenance fields existed carry none — warn.
        if "r_range" in cache_meta and "rs_range" in cache_meta:
            cached_r = tuple(float(x) for x in cache_meta["r_range"])
            cached_rs = tuple(float(x) for x in cache_meta["rs_range"])
            if cached_r != r_range or cached_rs != rs_range:
                print(
                    f"note: --dataset domain r={cached_r} rs={cached_rs} "
                    f"overrides CLI r={r_range} rs={rs_range} for asset "
                    "metadata",
                    flush=True,
                )
            r_range, rs_range = cached_r, cached_rs
        else:
            print(
                "warning: dataset cache has no generation-domain fields "
                "(pre-provenance cache); asset meta records the CLI "
                f"r={r_range} rs={rs_range}, which may not match the cache",
                flush=True,
            )
    else:
        dataset = neural.make_dataset(
            k_train, args.rays, max_steps=args.max_steps, dt=args.dt,
            r_range=r_range, rs_range=rs_range,
        )
        eval_set = neural.make_dataset(
            k_eval, args.eval_rays, max_steps=args.max_steps, dt=args.dt,
            r_range=r_range, rs_range=rs_range,
        )
    cap_frac = float(dataset["captured"].mean())
    print(
        f"dataset: {time.time() - t0:.1f}s, captured fraction {cap_frac:.3f}",
        flush=True,
    )

    t1 = time.time()
    result = neural.train(
        k_fit,
        dataset,
        hidden=hidden,
        steps=args.steps,
        batch_size=args.batch,
        lr=args.lr,
        warm_start=warm,
    )
    print(
        f"train: {time.time() - t1:.1f}s, loss "
        f"{result.loss_history[0]:.5f} -> {result.final_loss:.5f}",
        flush=True,
    )

    metrics = neural.evaluate(result.params, eval_set)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    neural.save_params(
        str(out),
        result.params,
        meta=dict(
            hidden=hidden,
            max_steps=args.max_steps,
            dt=args.dt,
            train_rays=args.rays,
            train_steps=args.steps,
            r_range=r_range,
            rs_range=rs_range,
            final_loss=result.final_loss,
            **{k: v for k, v in metrics.items()},
        ),
    )
    print(json.dumps({"out": str(out), **metrics}))


if __name__ == "__main__":
    main()
