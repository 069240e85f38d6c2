#!/usr/bin/env python
"""On-card smoke test of the renderer's main path (NVIDIA GPU).

One process, one GPU. Each phase drives what a user calls —
`BlackHoleRenderer.render_frame`, `OrbitAnimator.render_frames`,
`bhr_tpu.app.main` — with the Pallas-Triton geodesic kernel compiled for
the card, and checks it against the XLA oracle (`ops/trace.trace_rays`)
on the same card at real widths:

  compile    the kernel for every model x integrator at 1080p x 500
  headline   1920x1080 x 500 Schwarzschild frame vs the oracle, in both
             math tiers (exact: the library default; fast_math: the app's); PNG
  animation  120 frames of the fused-scan animator (ms/frame, info only)
  cli        `python -m bhr_tpu.app` at 800x600x200: PNGs + 12-column CSV
  config4    rk4 + adaptive + disk at 1080p x 500, both math tiers
  kerr4k     3840x2160 exact Kerr a*=0.9 + disk x 2000 steps
  texture    2048x4096 procedural skybox, bilinear / nearest / luma
  multires   divisor 3 vs the full-resolution oracle frame
  heatmap    per-ray step counts (debug mode) vs the oracle
  plugin     the Paczynski-Wiita plug-in physics
  neural     every committed surrogate asset: SSIM, capture-mask IoU

Kernel-vs-oracle contract (tests/test_pallas_parity.py): status and steps
agree on >= 99.5% of pixels, final directions within 1e-4 where they
agree, and at most 0.5% of uint8 frame pixels differ.

`--multi` runs only the four-GPU path at 1080p x 500 as (dp, sp) = (2, 2)
and (1, 4): the sharded row bands' status and step planes
(`parallel/mesh.trace_band`) must equal the single-device kernel's exactly,
and `parallel/mesh.render_animation_sharded`'s frames must match a
single-device render pixel for pixel to within 4 uint8 levels on at most
2e-5 of the values, with its psum luminance telemetry within 1e-3.

The last line of standard output is {"ok": true, "device": {...}}; any
failed phase exits non-zero without it, and so does a machine without a
GPU.

    python chip_smoke.py [--multi] [--out DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
W, H, STEPS = 1920, 1080, 500
KERR4K = (3840, 2160, 2000)  # width, height, max_steps
SKY = (2048, 4096)
STATUS_FRAC, VEL_ATOL, U8_FRAC = 0.995, 1e-4, 0.005
# multires at divisor 3 against the full-resolution oracle frame: about four
# times the H100 readings (mean 0.0098 uint8 levels, 1.1e-4 off by > 16)
MULTIRES_MEAN, MULTIRES_OFF = 0.04, 5e-4
# sharded vs single-device frames: separately compiled programs (the orbit
# camera's basis too) round a few values differently. H100 readings, 8
# frames: 3.7e-6 of the values by up to 2 levels (exact tier), 4.3e-6 by 1
# (fast_math); a band bug would shift shadow-edge or star pixels by far more
MULTI_U8_FRAC, MULTI_U8_MAX = 2e-5, 4


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def check(ok, message):
    """A failed comparison fails its phase (never stripped like `assert`)."""
    if not ok:
        raise RuntimeError(message)


class Smoke:
    def __init__(self, out_dir):
        self.out = out_dir
        self.failed = []

    @contextlib.contextmanager
    def phase(self, name):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            yield
        except Exception:
            traceback.print_exc()
            self.failed.append(name)
            print(f"== {name} FAILED", flush=True)
        else:
            print(f"== {name} ok ({time.perf_counter() - t0:.1f} s)", flush=True)


def report(name, **kw):
    print(json.dumps({"phase": name, **kw}), flush=True)


def compare_traces(name, kern, orac):
    """The kernel-vs-oracle contract on TraceResults."""
    sk, so = np.asarray(kern.status), np.asarray(orac.status)
    same = (sk == so) & (np.asarray(kern.steps) == np.asarray(orac.steps))
    m = same & (so != 2)  # captured rays' directions are never shaded
    vd = np.abs(np.asarray(kern.final_vel) - np.asarray(orac.final_vel)).max(-1)
    vel_ok = float((vd[m] <= VEL_ATOL).mean()) if m.any() else 1.0
    counts = np.bincount(so.ravel(), minlength=4).tolist()
    report(name, status_steps_agree=float(same.mean()), vel_within_1e4=vel_ok,
           vel_max_diff=float(vd[m].max()) if m.any() else 0.0,
           oracle_status_counts=counts)
    check(same.mean() >= STATUS_FRAC, f"{name}: status/steps agree {same.mean()}")
    check(vel_ok >= STATUS_FRAC, f"{name}: directions within 1e-4 on {vel_ok}")


def compare_frames(name, kern, orac, frac=U8_FRAC, max_abs=255):
    a, b = np.asarray(kern), np.asarray(orac)
    check(a.shape == b.shape and a.dtype == b.dtype == np.uint8,
          f"{name}: frames {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    differ = float((a != b).mean())
    worst = int(np.abs(a.astype(int) - b).max())
    report(name, u8_differ=differ, u8_max_abs=worst)
    check(differ <= frac, f"{name}: {differ:.6f} of uint8 pixels differ")
    check(worst <= max_abs, f"{name}: uint8 values differ by up to {worst}")


def luma(frame):
    f = np.asarray(frame, np.float32)
    return 0.2126 * f[..., 0] + 0.7152 * f[..., 1] + 0.0722 * f[..., 2]


def single_card(smoke: Smoke):
    import jax
    import jax.numpy as jnp

    from bhr_tpu import BlackHoleRenderer, Camera, SceneParams
    from bhr_tpu.animation import OrbitAnimator
    from bhr_tpu.core.scene import DEBUG_STEPS
    from bhr_tpu.io.image import save_image
    from bhr_tpu.io.skybox import procedural_starfield
    from bhr_tpu.models.disk import DiskParams, blackbody_lut
    from bhr_tpu.ops.pallas_trace import pallas_trace_image
    from bhr_tpu.ops.trace import TraceConfig
    from bhr_tpu.renderer import shade_image, trace_image
    from bhr_tpu.utils.plugin import load_plugin

    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from multires_diff import ssim

    plugin = os.path.join(HERE, "examples", "plugins", "paczynski_wiita.py")
    cam = Camera.default()
    scene = SceneParams(screen_width=W, screen_height=H, max_steps=STEPS)

    def oracle(camera, scn, cfg):
        with jax.default_matmul_precision("highest"):
            return jax.block_until_ready(
                trace_image(camera, scn, cfg, use_pallas=False))

    def oracle_frame(result, camera, scn, cfg, skybox=None, **kw):
        disk = DiskParams.for_scene(scn.schwarzschild_radius) if cfg.disk else None
        lut = blackbody_lut() if cfg.disk else None
        with jax.default_matmul_precision("highest"):
            return shade_image(result, camera, scn, skybox, disk, lut,
                               tonemap="passthrough", **kw)

    with smoke.phase("compile"):
        accel, cap = load_plugin(plugin)
        configs = [TraceConfig(model=m, integrator=i)
                   for m in ("schwarzschild", "kerr", "kerr_lt", "flat")
                   for i in ("euler", "rk4", "leapfrog")]
        configs.append(TraceConfig(model="custom", custom_accel=accel,
                                   custom_capture_factor=cap))
        for cfg in configs:
            t0 = time.perf_counter()
            fn = jax.jit(lambda c, cfg=cfg: pallas_trace_image(c, scene, cfg))
            mem = fn.lower(cam).compile().memory_analysis()
            report("compile", model=cfg.model, integrator=cfg.integrator,
                   compile_s=round(time.perf_counter() - t0, 2),
                   memory_analysis=str(mem))

    renderer = BlackHoleRenderer(W, H)
    ref = {}
    with smoke.phase("headline"):
        check(renderer.use_pallas, "the GPU default must be the kernel")
        check(not renderer.config.fast_math, "the library default is exact")
        frame = renderer.render_frame(cam, scene)
        ref["result"] = oracle(cam, scene, renderer.config)
        ref["frame"] = oracle_frame(ref["result"], cam, scene, renderer.config)
        fast = BlackHoleRenderer(W, H, fast_math=True)
        for tier, r in (("exact", renderer), ("fast_math", fast)):
            compare_traces(f"headline {tier}",
                           trace_image(cam, scene, r.config, use_pallas=True),
                           ref["result"])
            compare_frames(f"headline {tier}", r.render_frame(cam, scene),
                           ref["frame"])
        path = os.path.join(smoke.out, "headline_1080p.png")
        save_image(frame, path)
        with open(path, "rb") as fh:
            check(fh.read(8) == b"\x89PNG\r\n\x1a\n", f"{path} is no PNG")

    with smoke.phase("animation"):
        anim = OrbitAnimator(renderer)
        anim.render_frames(120, scene=scene, packed=True).block_until_ready()
        anim.render_frames(120, start_frame=120, scene=scene,
                           packed=True).block_until_ready()
        t0 = time.perf_counter()
        anim.render_frames(120, start_frame=240, scene=scene,
                           packed=True).block_until_ready()
        report("animation", frames=120,
               ms_per_frame=(time.perf_counter() - t0) * 1e3 / 120)

    with smoke.phase("cli"):
        from bhr_tpu.app import main as app_main

        out = os.path.join(smoke.out, "cli")
        tag = f"smoke{os.getpid()}"
        rc = app_main(["--frames", "16", "--width", "800", "--height", "600",
                       "--max-steps", "200", "--out", out, "--perf-log", tag])
        check(rc == 0, f"app exited {rc}")
        pngs = sorted(glob.glob(os.path.join(out, "frame_*.png")))
        check(len(pngs) == 16, f"{len(pngs)} PNGs: {pngs}")
        for p in pngs:
            with open(p, "rb") as fh:
                check(fh.read(8) == b"\x89PNG\r\n\x1a\n", f"{p} is no PNG")
        [csv] = glob.glob(os.path.join("measurements", f"perf_log_{tag}_*.csv"))
        rows = [line.rstrip("\n").split(",") for line in open(csv)]
        check(len(rows) >= 17 and all(len(r) == 12 for r in rows),
              f"CSV shape: {len(rows)} rows, first {rows[:2]}")
        report("cli", pngs=len(pngs), csv_rows=len(rows) - 1, csv_columns=12)

    def vs_oracle(name, r, camera, scn):
        kframe = r.render_frame(camera, scn)
        orac = oracle(camera, scn, r.config)
        compare_traces(name, trace_image(camera, scn, r.config, use_pallas=True),
                       orac)
        compare_frames(name, kframe, oracle_frame(orac, camera, scn, r.config))

    with smoke.phase("config4"):
        for tier in (False, True):
            r = BlackHoleRenderer(W, H, "rk4", adaptive=True, disk=True,
                                  fast_math=tier)
            vs_oracle(f"config4 {'fast_math' if tier else 'exact'}", r, cam,
                      scene)

    with smoke.phase("kerr4k"):
        kw, kh, ksteps = KERR4K
        r = BlackHoleRenderer(kw, kh, model="kerr", disk=True)
        scn = SceneParams(screen_width=kw, screen_height=kh, max_steps=ksteps,
                          spin=jnp.float32(0.9))
        vs_oracle("kerr4k", r, cam, scn)

    with smoke.phase("texture"):
        sky = procedural_starfield(*SKY, seed=2020)
        for tier in ("bilinear", "nearest", "luma"):
            r = BlackHoleRenderer(W, H, skybox=sky, texture_filter=tier)
            compare_frames(
                f"texture_{tier}", r.render_frame(cam, scene),
                oracle_frame(ref["result"], cam, scene, r.config,
                             skybox=r.skybox, texture_filter=r._sample_filter),
            )

    with smoke.phase("multires"):
        frame = np.asarray(renderer.render_frame_multires(cam, scene, divisor=3))
        full = np.asarray(ref["frame"]).astype(np.int32)
        diff = np.abs(frame.astype(np.int32)[..., :3] - full[..., :3])
        off = float((diff.max(-1) > 16).mean())
        report("multires", divisor=3, mean_u8_err=float(diff.mean()),
               off_by_16_frac=off, ssim=ssim(luma(frame), luma(full)))
        check(diff.mean() < MULTIRES_MEAN and off < MULTIRES_OFF,
              f"multires error {diff.mean()}, off fraction {off}")

    with smoke.phase("heatmap"):
        dbg = scene.replace(debug_mode=DEBUG_STEPS)
        compare_frames("heatmap", renderer.render_frame(cam, dbg),
                       oracle_frame(ref["result"], cam, dbg, renderer.config))

    with smoke.phase("plugin"):
        r = BlackHoleRenderer(W, H, custom_physics=plugin)
        vs_oracle("plugin", r, cam, scene)

    with smoke.phase("neural"):
        from bhr_tpu.models.neural import tier_matmul_args
        from bhr_tpu.ops.neural_trace import neural_trace_image

        kerr_scene = scene.replace(spin=jnp.float32(0.9))
        kerr_ref = oracle(cam, kerr_scene, TraceConfig(model="kerr"))
        refs = {
            "schwarzschild": (scene, ref["result"], ref["frame"]),
            "kerr": (kerr_scene, kerr_ref,
                     oracle_frame(kerr_ref, cam, kerr_scene, TraceConfig())),
        }
        low_iou = []
        for asset in sorted(glob.glob(os.path.join(HERE, "bhr_tpu", "assets", "*.npz"))):
            model = "kerr" if "kerr" in os.path.basename(asset) else "schwarzschild"
            scn, orac, oframe = refs[model]
            r = BlackHoleRenderer(W, H, "neural", model=model, neural_params=asset)
            frame = np.asarray(r.render_frame(cam, scn))
            net = neural_trace_image(r.neural_params, cam, scn,
                                     **tier_matmul_args(r.neural_precision))
            cn = np.asarray(net.status) == 2
            co = np.asarray(orac.status) == 2
            iou = float((cn & co).sum() / max((cn | co).sum(), 1))
            report("neural", asset=os.path.basename(asset),
                   tier=r.neural_precision,
                   ssim=ssim(luma(frame), luma(oframe)), capture_iou=iou)
            if iou < 0.99:
                low_iou.append((os.path.basename(asset), iou))
        check(not low_iou, f"capture-mask IoU below 0.99: {low_iou}")


def multi_card(smoke: Smoke):
    import jax
    from jax.sharding import PartitionSpec as P

    from bhr_tpu import BlackHoleRenderer, SceneParams
    from bhr_tpu.animation import OrbitAnimator
    from bhr_tpu.core.camera import orbit_camera
    from bhr_tpu.ops.pallas_trace import pallas_trace_image
    from bhr_tpu.parallel.mesh import make_mesh, render_animation_sharded, trace_band

    n_frames = 8
    scene = SceneParams(screen_width=W, screen_height=H, max_steps=STEPS)
    renderer = BlackHoleRenderer(W, H)
    cfg = renderer.config
    cams = [orbit_camera(jax.numpy.float32(t), radius=15.0, height=5.0,
                         rotation_speed=0.3) for t in (0.0, 0.5)]

    def planes_of(result):
        return result.status, result.steps, result.final_vel

    # the scene is an argument of both programs, as in every render path: a
    # closed-over fov is constant-folded in one program and not in the
    # other, and tan(fov / 2) then differs by an ulp
    single_trace = jax.jit(
        lambda c, s: planes_of(pallas_trace_image(c, s, cfg)))

    def sharded_trace(mesh):
        band_h = -(-H // mesh.shape["sp"])

        def band(c, s):
            row0 = jax.lax.axis_index("sp") * band_h
            return planes_of(trace_band(c, s, row0, band_h, config=cfg,
                                        use_pallas=True))

        return jax.jit(jax.shard_map(band, mesh=mesh, in_specs=(P(), P()),
                                     out_specs=(P("sp"),) * 3,
                                     check_vma=False))

    with smoke.phase("multi"):
        check(len(jax.devices()) == 4, f"needs 4 GPUs: {jax.devices()}")
        anim = OrbitAnimator(renderer)
        single = np.asarray(anim.render_frames(n_frames, scene=scene))
        anim.render_frames(n_frames, scene=scene).block_until_ready()
        t0 = time.perf_counter()
        anim.render_frames(n_frames, scene=scene).block_until_ready()
        report("multi", dp_sp="one device", frames=n_frames,
               ms_per_frame=(time.perf_counter() - t0) * 1e3 / n_frames)
        ref_lum = single[..., 1].astype(np.float64).mean(axis=(1, 2))
        ref_planes = [[np.asarray(a) for a in single_trace(c, scene)]
                      for c in cams]
        times = np.arange(n_frames, dtype=np.float32) / np.float32(60.0)
        for shape in ((2, 2), (1, 4)):
            mesh = make_mesh(4, shape=shape)
            fn = sharded_trace(mesh)
            for k, c in enumerate(cams):
                status, steps, vel = (np.asarray(a)[:H] for a in fn(c, scene))
                ref_status, ref_steps, ref_vel = ref_planes[k]
                report("multi planes", dp_sp=list(shape), camera=k,
                       status_differ=int((status != ref_status).sum()),
                       steps_differ=int((steps != ref_steps).sum()),
                       vel_differ=int((vel != ref_vel).any(-1).sum()))
                check(np.array_equal(status, ref_status)
                      and np.array_equal(steps, ref_steps),
                      f"{shape}: sharded status/steps planes differ")
            frames, lums = render_animation_sharded(times, scene, None, mesh,
                                                    config=cfg)
            frames = np.asarray(frames)
            jax.block_until_ready(render_animation_sharded(
                times, scene, None, mesh, config=cfg))
            t0 = time.perf_counter()
            jax.block_until_ready(render_animation_sharded(
                times, scene, None, mesh, config=cfg))
            ms = (time.perf_counter() - t0) * 1e3 / n_frames
            lum_err = float(np.abs(np.asarray(lums) - ref_lum).max())
            report("multi", dp_sp=list(shape), frames=n_frames,
                   pixels_differ=int((frames != single).any(-1).sum()),
                   psum_lum_max_abs_err=lum_err, ms_per_frame=ms)
            compare_frames(f"multi {shape}", frames, single,
                           frac=MULTI_U8_FRAC, max_abs=MULTI_U8_MAX)
            check(lum_err < 1e-3, f"{shape}: luminance telemetry off by {lum_err}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU sharded path")
    ap.add_argument("--out", default=os.path.join(HERE, "smoke_out"))
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from bhr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    os.makedirs(args.out, exist_ok=True)
    print(card(), flush=True)
    smoke = Smoke(args.out)
    t0 = time.perf_counter()
    (multi_card if args.multi else single_card)(smoke)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    if smoke.failed:
        print(f"FAILED phases: {smoke.failed}", file=sys.stderr)
        return 1
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
