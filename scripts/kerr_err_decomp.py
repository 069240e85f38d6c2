#!/usr/bin/env python
"""Decompose the Kerr surrogate's frame-level error by head and by field.

Reads a `neural_quality.py --save` dump (f_ref/f_net/vel_ref/vel_net/
cap_*), reconstructs each pixel's ray-plane basis from the camera
(core/camera.generate_rays — the same rays both renderers traced), and
splits the final-direction error into the surrogate's two regression
heads: in-plane delta (angle in the (u_hat, w_hat) plane) and
out-of-plane chi (arcsin of the n_hat component). Buckets both by the
reference deflection magnitude — the SSIM-deficit map already showed the
deficit is bulk, this says WHICH head carries it, which decides whether
the next distillation lever is the delta envelope or the chi head.

CPU-only. Usage:
  python scripts/kerr_err_decomp.py /tmp/kerr_diag.npz
"""

import json
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from bhr_tpu.core.camera import Camera, generate_rays
    from bhr_tpu.core.scene import SceneParams
    from bhr_tpu.models.neural_kerr import reduce_ray

    path = sys.argv[1] if len(sys.argv) > 1 else "/tmp/kerr_diag.npz"
    z = np.load(path)
    vel_ref = z["vel_ref"].astype(np.float32)
    vel_net = z["vel_net"].astype(np.float32)
    h, w = vel_ref.shape[:2]
    esc = (z["cap_ref"] < 0.5) & (z["cap_net"] < 0.5)

    cam = Camera.default()
    scene = SceneParams(screen_width=w, screen_height=h)
    origins, dirs = generate_rays(cam, w, h, scene.fov)
    origins = np.asarray(origins, np.float32).reshape(h, w, 3)
    dirs = np.asarray(dirs, np.float32).reshape(h, w, 3)
    red = reduce_ray(jnp.asarray(origins), jnp.asarray(dirs),
                     jnp.asarray(scene.black_hole_position))
    u_hat = np.asarray(red["u_hat"])
    w_hat = np.asarray(red["w_hat"])
    n_hat = np.asarray(red["n_hat"])
    psi = np.arctan2(np.asarray(red["s"]), np.asarray(red["c"]))

    def decomp(v):
        vn = v / np.maximum(
            np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
        au = np.sum(vn * u_hat, -1)
        aw = np.sum(vn * w_hat, -1)
        an = np.clip(np.sum(vn * n_hat, -1), -1, 1)
        return np.arctan2(aw, au), np.arcsin(an)

    phi_r, chi_r = decomp(vel_ref)
    phi_n, chi_n = decomp(vel_net)
    # in-plane error: wrap to [-pi, pi)
    dphi = np.abs((phi_n - phi_r + np.pi) % (2 * np.pi) - np.pi)
    dchi = np.abs(chi_n - chi_r)
    # total angular error for cross-check vs neural_quality's number
    nr = np.maximum(np.linalg.norm(vel_ref, axis=-1, keepdims=True), 1e-12)
    nn = np.maximum(np.linalg.norm(vel_net, axis=-1, keepdims=True), 1e-12)
    dot = np.clip(np.sum(vel_ref / nr * vel_net / nn, axis=-1), -1, 1)
    dtot = np.arccos(dot)
    defl = np.abs((phi_r - psi + np.pi) % (2 * np.pi) - np.pi)

    deg = 180 / np.pi
    m = esc
    out = {"n_escaped": int(m.sum()),
           "total_median_deg": round(float(np.median(dtot[m]) * deg), 4),
           "phi_median_deg": round(float(np.median(dphi[m]) * deg), 4),
           "chi_median_deg": round(float(np.median(dchi[m]) * deg), 4),
           "phi_p99_deg": round(float(np.percentile(dphi[m], 99) * deg), 4),
           "chi_p99_deg": round(float(np.percentile(dchi[m], 99) * deg), 4)}
    bands = []
    edges = [0.0, 0.5, 1, 2, 5, 10, 20, 60, 180]
    for lo, hi in zip(edges[:-1], edges[1:]):
        b = m & (defl * deg >= lo) & (defl * deg < hi)
        if b.sum() == 0:
            continue
        bands.append({
            "defl_band_deg": [lo, hi], "n": int(b.sum()),
            "phi_med": round(float(np.median(dphi[b]) * deg), 4),
            "chi_med": round(float(np.median(dchi[b]) * deg), 4),
            "phi_p99": round(float(np.percentile(dphi[b], 99) * deg), 4),
            "chi_p99": round(float(np.percentile(dchi[b], 99) * deg), 4),
        })
    out["bands"] = bands
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
