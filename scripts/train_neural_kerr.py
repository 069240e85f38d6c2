#!/usr/bin/env python
"""Train the Kerr neural geodesic surrogate (models/neural_kerr.py).

Targets come from the exact Kerr-Schild Hamiltonian oracle (ops/trace.py
model="kerr") at the library-default workload. Writes weights to
bhr_tpu/assets/neural_kerr.npz (the renderer's default for
integrator="neural" + model="kerr").

Reference: docs/ROADMAP.md:514-826 (Kerr) x :1217-1337 (GeodesicMLP);
GravLensX — the roadmap's citation — is specifically a Kerr surrogate.

Usage:
    python scripts/train_neural_kerr.py              # full run (GPU)
    python scripts/train_neural_kerr.py --cpu --quick
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
    ap.add_argument("--rays", type=int, default=8_000_000)
    ap.add_argument("--eval-rays", type=int, default=262_144)
    ap.add_argument("--steps", type=int, default=150_000)
    ap.add_argument("--batch", type=int, default=16_384)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--hidden", type=str, default="256,256,256")
    ap.add_argument("--max-steps", type=int, default=500)
    ap.add_argument("--dt", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--r-range", type=str, default="3,60")
    ap.add_argument("--rs-range", type=str, default="0.5,4.0")
    ap.add_argument("--spin-range", type=str, default="0.0,0.95")
    ap.add_argument("--init", type=str, default="",
                    help="warm-start weights to fine-tune")
    ap.add_argument(
        "--out",
        type=str,
        default=str(REPO / "bhr_tpu" / "assets" / "neural_kerr.npz"),
    )
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--cache", type=str, default="",
                    help="npz dataset cache: reuse if present, else "
                         "generate and save")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from bhr_tpu.models import neural_kerr as nk

    if args.quick:
        args.rays = min(args.rays, 200_000)
        args.eval_rays = 32_768
        args.steps = min(args.steps, 2_000)
        args.max_steps = min(args.max_steps, 200)

    hidden = tuple(int(x) for x in args.hidden.split(","))
    r_range = tuple(float(x) for x in args.r_range.split(","))
    rs_range = tuple(float(x) for x in args.rs_range.split(","))
    spin_range = tuple(float(x) for x in args.spin_range.split(","))
    warm = None
    if args.init:
        warm, _ = nk.load_params(args.init)
        hidden = tuple(w.shape[1] for w, _ in warm[:-1])
    key = jax.random.PRNGKey(args.seed)
    k_train, k_eval, k_fit = jax.random.split(key, 3)

    print(
        f"device={jax.devices()[0]} rays={args.rays} steps={args.steps} "
        f"hidden={hidden} r={r_range} rs={rs_range} spin={spin_range}",
        flush=True,
    )
    t0 = time.time()
    cache = pathlib.Path(args.cache) if args.cache else None
    if cache is not None and cache.exists():
        import jax.numpy as jnp

        z = np.load(cache)
        dataset = {
            k[6:]: jnp.asarray(z[k]) for k in z.files if k.startswith("train_")
        }
        eval_set = {
            k[5:]: jnp.asarray(z[k]) for k in z.files if k.startswith("eval_")
        }
    else:
        dataset = nk.make_dataset_kerr(
            k_train, args.rays, max_steps=args.max_steps, dt=args.dt,
            r_range=r_range, rs_range=rs_range, spin_range=spin_range,
        )
        eval_set = nk.make_dataset_kerr(
            k_eval, args.eval_rays, max_steps=args.max_steps, dt=args.dt,
            r_range=r_range, rs_range=rs_range, spin_range=spin_range,
        )
        if cache is not None:
            arrays = {f"train_{k}": np.asarray(v) for k, v in dataset.items()}
            arrays.update(
                {f"eval_{k}": np.asarray(v) for k, v in eval_set.items()}
            )
            np.savez(cache, **arrays)
    print(
        f"dataset: {time.time() - t0:.1f}s, captured fraction "
        f"{float(dataset['captured'].mean()):.3f}",
        flush=True,
    )

    t1 = time.time()
    result = nk.train(
        k_fit, dataset, hidden=hidden, steps=args.steps,
        batch_size=args.batch, lr=args.lr, warm_start=warm,
    )
    print(
        f"train: {time.time() - t1:.1f}s, loss "
        f"{result.loss_history[0]:.5f} -> {result.final_loss:.5f}",
        flush=True,
    )

    metrics = nk.evaluate(result.params, eval_set)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    nk.save_params(
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
            spin_range=spin_range,
            final_loss=result.final_loss,
            **{k: v for k, v in metrics.items()},
        ),
    )
    print(json.dumps({"out": str(out), **metrics}))


if __name__ == "__main__":
    main()
