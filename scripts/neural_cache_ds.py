#!/usr/bin/env python
"""Generate and cache oracle-traced training datasets as npz.

The envelope-parameterization iteration loop needs many trainings on the
same data; dataset generation is the expensive step, so cache it once.

Usage: python scripts/neural_cache_ds.py OUT.npz RAYS [EVAL_RAYS] [SEED]
           [R_LO,R_HI] [RS_LO,RS_HI]
"""

import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax
import numpy as np

from bhr_tpu.models import neural


def main():
    out = sys.argv[1]
    rays = int(sys.argv[2])
    eval_rays = int(sys.argv[3]) if len(sys.argv) > 3 else 262_144
    seed = int(sys.argv[4]) if len(sys.argv) > 4 else 11
    r_range = (
        tuple(float(x) for x in sys.argv[5].split(","))
        if len(sys.argv) > 5 else (3.0, 60.0)
    )
    rs_range = (
        tuple(float(x) for x in sys.argv[6].split(","))
        if len(sys.argv) > 6 else (0.5, 4.0)
    )
    key = jax.random.PRNGKey(seed)
    k_data, k_eval, _ = jax.random.split(key, 3)
    t0 = time.time()
    ds = neural.make_dataset(
        k_data, rays, max_steps=500, r_range=r_range, rs_range=rs_range
    )
    t1 = time.time()
    ev = neural.make_dataset(
        k_eval, eval_rays, max_steps=500, r_range=r_range, rs_range=rs_range
    )
    t2 = time.time()
    arrays = {f"train_{k}": np.asarray(v) for k, v in ds.items()}
    arrays.update({f"eval_{k}": np.asarray(v) for k, v in ev.items()})
    # generation provenance: consumers (train_neural.py --dataset) read
    # these back so asset metadata records the CACHE's domain, not
    # whatever the CLI args happened to be (ADVICE round-4 low)
    arrays["gen_r_range"] = np.asarray(r_range, np.float32)
    arrays["gen_rs_range"] = np.asarray(rs_range, np.float32)
    arrays["gen_max_steps"] = np.int32(500)
    arrays["gen_seed"] = np.int32(seed)
    np.savez(out, **arrays)
    print(
        f"train {rays} rays {t1 - t0:.1f}s, eval {eval_rays} rays "
        f"{t2 - t1:.1f}s -> {out}",
        flush=True,
    )


def load(path, with_meta: bool = False):
    import jax.numpy as jnp

    z = np.load(path)
    train = {
        k[6:]: jnp.asarray(z[k]) for k in z.files if k.startswith("train_")
    }
    ev = {k[5:]: jnp.asarray(z[k]) for k in z.files if k.startswith("eval_")}
    if with_meta:
        meta = {k[4:]: z[k] for k in z.files if k.startswith("gen_")}
        return train, ev, meta
    return train, ev


if __name__ == "__main__":
    main()
