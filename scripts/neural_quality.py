#!/usr/bin/env python
"""Phase-5 surrogate quality at full scale: neural vs integrated frames.

Renders the headline scene (1080p x 500 steps by default) through the
geodesic integrator (the Pallas kernel on a GPU, the XLA oracle on the
CPU) and through the neural surrogate on the same device, then reports: SSIM (the roadmap's acceptance metric — target
> 0.99, docs/ROADMAP.md:1320-1336), capture-mask IoU, median / p99
angular deflection error over mutually-escaped pixels, and mean u8
error. Run on the GPU; pass --texture to compare under the 4K texture
skybox instead of the analytic star field, --precision bf16|highest to
override the asset's matmul tier, --orbit N to aggregate over N
orbit-camera frames.

Usage: python scripts/neural_quality.py [--width W --height H --steps N]
"""

import argparse
import json
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

from multires_diff import ssim  # noqa: E402  (same measurement everywhere)


def luma(frame):
    f = frame.astype(np.float32)
    return 0.2126 * f[..., 0] + 0.7152 * f[..., 1] + 0.0722 * f[..., 2]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--precision", default="auto",
                    choices=["auto", "bf16", "highest"],
                    help="inference matmul tier; 'auto' resolves from the "
                         "asset's train_precision meta "
                         "(models/neural.tier_matmul_args)")
    ap.add_argument("--texture", action="store_true")
    ap.add_argument("--orbit", type=int, default=1,
                    help="aggregate over N orbit-camera frames")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--domain", type=int, default=0,
                    help="gauge N scenes sampled across the training "
                         "domain (r0 log-uniform in [3,60], rs uniform in "
                         "[0.5,4], camera at radius r0 looking at the BH) "
                         "instead of the default scene/orbit — the honest "
                         "generality measurement for the general net")
    ap.add_argument("--save", default="", help="npz dump of frames+fields for offline analysis")
    ap.add_argument(
        "--weights",
        default="",
        help="surrogate weights to gauge (e.g. the _orbit.npz distilled "
             "net); default: the committed general net for the model",
    )
    ap.add_argument("--model", default="schwarzschild",
                    choices=["schwarzschild", "kerr"],
                    help="spacetime model: kerr gauges the Kerr surrogate "
                         "against the exact Kerr-Schild integrator")
    ap.add_argument("--spin", type=float, default=0.9,
                    help="Kerr spin a/M (fixed scenes; --domain samples "
                         "spins across [0, 0.95] instead)")
    args = ap.parse_args()
    if not args.weights:
        args.weights = str(
            REPO / "bhr_tpu" / "assets"
            / ("neural_kerr.npz" if args.model == "kerr"
               else "neural_schwarzschild.npz")
        )

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp  # noqa: F401

    from bhr_tpu import BlackHoleRenderer, SceneParams
    from bhr_tpu.core.camera import orbit_camera
    from bhr_tpu.models.neural import tier_matmul_args
    from bhr_tpu.ops.neural_trace import neural_trace_image_jit
    from bhr_tpu.ops.trace import STATUS_CAPTURED, TraceConfig
    from bhr_tpu.renderer import trace_image

    if args.model == "kerr":
        from bhr_tpu.models.neural_kerr import load_params
    else:
        from bhr_tpu.models.neural import load_params

    w, h, steps = args.width, args.height, args.steps
    spin0 = jnp.float32(args.spin if args.model == "kerr" else 0.0)
    scene = SceneParams(
        screen_width=w, screen_height=h, max_steps=steps, spin=spin0
    )
    skybox = None
    if args.texture:
        from bhr_tpu.io.skybox import procedural_starfield

        skybox = procedural_starfield(2048, 4096, seed=2020)

    kw = dict(skybox=skybox) if skybox is not None else {}
    ref = BlackHoleRenderer(w, h, model=args.model, **kw)
    net = BlackHoleRenderer(
        w, h, integrator="neural", model=args.model,
        neural_params=args.weights, neural_precision=args.precision, **kw
    )
    params, meta = load_params(args.weights)

    cfg = TraceConfig(model=args.model)
    ssims, ious, medians, p99s, mean_u8 = [], [], [], [], []
    if args.domain:
        # deterministic domain sample matching models/neural.sample_rays'
        # (r0, rs) distribution; r0 >= 1.3 rs mirrors the training floor
        rng = np.random.default_rng(7)
        r0s = np.exp(rng.uniform(np.log(3.0), np.log(60.0), args.domain))
        rss = rng.uniform(0.5, 4.0, args.domain)
        rss = np.minimum(rss, r0s / (1.6 if args.model == "kerr" else 1.3))
        spins = (
            rng.uniform(0.0, 0.95, args.domain)
            if args.model == "kerr"
            else np.zeros(args.domain)
        )
        scenes = []
        for r0, rs, sp in zip(r0s, rss, spins):
            cam_k = __import__("bhr_tpu").Camera.new(
                [0.0, float(r0) * 0.316, float(r0) * 0.949],
                [0.0, 0.0, 0.0], [0.0, 1.0, 0.0],
            )
            scenes.append((
                cam_k,
                SceneParams(screen_width=w, screen_height=h,
                            max_steps=steps,
                            schwarzschild_radius=jnp.float32(rs),
                            spin=jnp.float32(sp)),
                round(float(r0), 2), round(float(rs), 3),
            ))
    else:
        scenes = None
    n_frames = args.domain or args.orbit
    for k in range(n_frames):
        if scenes is not None:
            cam, scene, r0_k, rs_k = scenes[k]
        else:
            cam = (
                orbit_camera(k / 3.0)
                if args.orbit > 1
                else __import__("bhr_tpu").Camera.default()
            )
        f_ref = np.asarray(ref.render_frame(cam, scene)).astype(np.int32)
        f_net = np.asarray(net.render_frame(cam, scene)).astype(np.int32)
        ssims.append(ssim(luma(f_ref), luma(f_net)))
        mean_u8.append(float(np.abs(f_ref - f_net)[..., :3].mean()))

        # deflection-field comparison (independent of shading)
        res_ref = trace_image(cam, scene, cfg, use_pallas=ref.use_pallas)
        res_net = neural_trace_image_jit(
            net.neural_params, cam, scene,
            **tier_matmul_args(net.neural_precision),
        )
        cap_r = np.asarray(res_ref.status == STATUS_CAPTURED)
        cap_n = np.asarray(res_net.status == STATUS_CAPTURED)
        ious.append(
            float(
                np.logical_and(cap_r, cap_n).sum()
                / max(np.logical_or(cap_r, cap_n).sum(), 1)
            )
        )
        live = ~cap_r & ~cap_n
        dot = np.clip(
            np.asarray(
                (res_ref.final_vel * res_net.final_vel).sum(-1)
            )[live],
            -1.0,
            1.0,
        )
        err = np.degrees(np.arccos(dot))
        if err.size == 0:
            # an all-captured frame (camera at the r0 >= 1.3 rs domain
            # floor renders pure shadow): no live rays to compare —
            # deflection error is vacuously zero
            err = np.zeros(1, np.float32)
        medians.append(float(np.median(err)))
        p99s.append(float(np.percentile(err, 99)))
        if scenes is not None:
            scene_rec = {"r0": r0_k, "rs": rs_k}
            if args.model == "kerr":
                scene_rec["spin"] = round(float(scene.spin), 3)
            print(json.dumps({
                "scene": scene_rec,
                "ssim": round(ssims[-1], 5),
                "capture_iou": round(ious[-1], 5),
                "median_deg": round(medians[-1], 4),
                "p99_deg": round(p99s[-1], 3),
            }), flush=True)
        if args.save and k == 0:
            np.savez(
                args.save,
                f_ref=f_ref.astype(np.uint8),
                f_net=f_net.astype(np.uint8),
                cap_ref=cap_r,
                cap_net=cap_n,
                status_ref=np.asarray(res_ref.status),
                vel_ref=np.asarray(res_ref.final_vel),
                vel_net=np.asarray(res_net.final_vel),
            )

    print(
        json.dumps(
            {
                "config": f"{w}x{h}x{steps}"
                + ("_kerr" if args.model == "kerr" else "")
                + ("_texture" if args.texture else "")
                + (f"_domain{args.domain}" if args.domain else "")
                + f"_prec-{net.neural_precision}",
                "frames": n_frames,
                "ssim": round(float(np.mean(ssims)), 5),
                "ssim_min": round(float(np.min(ssims)), 5),
                "capture_iou": round(float(np.mean(ious)), 5),
                "median_deg": round(float(np.mean(medians)), 4),
                "p99_deg": round(float(np.mean(p99s)), 3),
                "mean_u8_err": round(float(np.mean(mean_u8)), 3),
                "weights_meta": {
                    k: (v.tolist() if hasattr(v, "tolist") else v)
                    for k, v in meta.items()
                },
            }
        )
    )


if __name__ == "__main__":
    main()
