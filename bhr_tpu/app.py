"""Application mode: the headless real-time animation loop + CLI.

The analog of the reference's windowed winit app (reference: src/main.rs).
There is no display surface on a headless GPU host, so "application mode" renders
the same orbiting-camera animation headlessly — frames stream to a PNG
sequence via the native async writer instead of a swapchain — while
reproducing the app-mode behaviors:

  * CLI flags --perf-log / --duration / --debug-steps (main.rs:14-32);
    --shader becomes --integrator/--model (the kernel-selection axis);
  * orbit camera angle = t*0.3, radius 15, height 5 (main.rs:851-869);
  * per-frame scene with max_steps=200 (main.rs:878);
  * PerformanceStats with 10-frame warmup + CSV PerfLogger (main.rs:36-262);
  * benchmark auto-exit after --duration seconds (main.rs:836-848).

Unlike the reference — which syncs the host every frame (blocking timestamp
readback, main.rs:887-921) — the default hot loop here fuses `--chunk`
frames into one on-device lax.scan per dispatch (zero host round-trips
inside a chunk; the design of animation.py applied to live mode). Per-frame
statistics attribute the chunk bracket evenly; the gpu_time column reports
the bracket minus the calibrated fixed dispatch overhead (see
utils/timing.py). `--chunk 1`
restores the reference-style per-frame dispatch loop.
"""

from __future__ import annotations

import argparse
import os
import time

import jax
import numpy as np

from .animation import APP_MAX_STEPS
from .core.camera import orbit_camera
from .core.scene import DEBUG_NONE, DEBUG_STEPS, SceneParams
from .renderer import BlackHoleRenderer
from .utils.perf import PerfLogger, PerformanceStats
from .utils.timing import TimestampQuery, calibrate_dispatch_overhead_ms

DEFAULT_CHUNK = 8


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bhr-tpu",
        description="GPU black hole raytracer (animation/benchmark mode)",
    )
    # reference flags (main.rs:14-32)
    p.add_argument("--perf-log", metavar="TAG", help="record a performance CSV with this version tag")
    p.add_argument("--duration", type=float, metavar="SECONDS", help="auto-exit after N seconds (benchmarking)")
    p.add_argument("--debug-steps", action="store_true", help="step-count heatmap debug mode")
    p.add_argument("--integrator", default="euler",
                   choices=["euler", "rk4", "leapfrog", "neural"],
                   help="geodesic integrator (replaces the reference --shader "
                        "hot-swap); leapfrog = the roadmap's symplectic "
                        "comparator (ROADMAP.md:179-190); neural = the "
                        "Phase-5 MLP surrogate (ROADMAP.md:1217-1337, "
                        "Schwarzschild only)")
    # extensions beyond the reference
    p.add_argument("--model", default="schwarzschild",
                   choices=["schwarzschild", "kerr", "kerr_lt", "flat"],
                   help="spacetime model: kerr = exact Kerr-Schild geodesics, "
                        "kerr_lt = cheap Lense-Thirring approximation")
    p.add_argument("--plugin", metavar="PATH",
                   help="runtime physics plugin: a .py file defining "
                        "acceleration(rel, vel, r, r2, rs, spin) -> (ax, ay, "
                        "az) on component-plane tuples (+ optional "
                        "CAPTURE_FACTOR). The true analog of the reference's "
                        "--shader hot-swap (lib.rs:425-429): the function is "
                        "traced into the device kernel at run time. "
                        "Overrides --model.")
    p.add_argument("--spin", type=float, default=0.9, help="Kerr spin a/M (used with --model kerr)")
    p.add_argument("--adaptive", action="store_true", help="adaptive step size")
    p.add_argument("--disk", action="store_true", help="render the accretion disk")
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--max-steps", type=int, default=APP_MAX_STEPS)
    p.add_argument("--frames", type=int, default=0, help="stop after N frames (0 = until --duration/Ctrl-C)")
    p.add_argument("--fps", type=float, default=60.0, help="animation time base (frame t = i/fps)")
    p.add_argument("--chunk", type=int, default=0,
                   help="frames fused per on-device scan dispatch "
                        f"(0 = default {DEFAULT_CHUNK}; 1 = per-frame dispatch, "
                        "wall-clock camera, reference-style loop)")
    p.add_argument("--skybox", metavar="PATH",
                   help="equirect skybox image (.exr incl. PIZ / .png / .jpg); "
                        "default: the analytic procedural star field — the "
                        "reference hardcodes assets/starmap_2020_4k.exr "
                        "(lib.rs:406-411), which is not distributed")
    p.add_argument("--texture-filter", default="nearest",
                   choices=["bilinear", "nearest", "luma"],
                   help="skybox sampling tier (only with --skybox): nearest = "
                        "1 gather/pixel (real-time), bilinear = exact "
                        "corner-rows slice-3 row gather (1 index/pixel), "
                        "luma = exact-bilinear luminance + subsampled "
                        "chroma at ~1.25 indices")
    p.add_argument("--texture-subsample", default="1", metavar="N|checker",
                   help="texture gather-count reduction (only with --skybox): "
                        "N>1 samples colors on a 1/N grid of the full-res "
                        "directions (indices / N^2); 'checker' samples half "
                        "the pixels exactly and reconstructs the holes "
                        "(an approximation: fewer gathers, lower SSIM)")
    p.add_argument("--tonemap", default="passthrough",
                   choices=["passthrough", "reinhard", "srgb"],
                   help="display transfer curve (the display.wgsl slot; the "
                        "reference's pass is a plain sample = passthrough)")
    p.add_argument("--multires", type=int, default=0, metavar="N",
                   help="render with 1/N-resolution geodesics + shadow-edge "
                        "fix-up (roadmap Phase 4-1, an approximation mode); "
                        "incompatible with --debug-steps")
    p.add_argument("--neural-weights", metavar="PATH",
                   help="surrogate weights for --integrator neural (default: "
                        "the committed general net, or neural_kerr.npz with "
                        "--model kerr; the *_orbit[_xl].npz assets are "
                        "distilled for the default orbit scene)")
    p.add_argument("--out", metavar="DIR", help="write frames as PNGs into DIR")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="stream the live render as MJPEG over HTTP on PORT "
                        "(open http://localhost:PORT/ in a browser) — the "
                        "headless analog of the reference's winit window + "
                        "display pass (main.rs:264-1147, display.wgsl)")
    p.add_argument("--fast-math", action=argparse.BooleanOptionalAction, default=True,
                   help="approximate rsqrt renormalization in the kernel's hot "
                        "loop: the app default (the library defaults to exact "
                        "math); --no-fast-math selects the exact tier")
    p.add_argument("--oracle", action="store_true", help="use the XLA oracle path instead of the Pallas kernel")
    p.add_argument("--verbose", "-v", action="store_true",
                   help="debug logging (the env_logger analog, main.rs:1135)")
    p.add_argument("--overlay", action="store_true",
                   help="draw the perf overlay (and the heatmap legend with "
                        "--debug-steps) onto saved frames — the egui GUI analog")
    return p


def _write_host_frame(args, host_frame, index, stats):
    """Overlay (optional) + submit one RGBA frame to the native PNG writer."""
    from .io import native

    if args.overlay:
        from .utils.overlay import draw_legend_onto, draw_performance_overlay

        host_frame = draw_performance_overlay(host_frame, stats)
        if args.debug_steps:
            host_frame = draw_legend_onto(host_frame, max_steps=args.max_steps)
    native.submit_frame(
        os.path.join(args.out, f"frame_{index:05d}.png"), host_frame
    )


def _chunked_loop(args, renderer, scene, stats, logger, chunk) -> int:
    """Fused-scan hot loop: `chunk` frames per device dispatch.

    The camera is a pure function of frame index (t = i / fps), making the
    run deterministic and the scan fusable; per-frame stats attribute each
    chunk bracket evenly across its frames.
    """
    from .animation import OrbitAnimator

    anim = OrbitAnimator(renderer)

    def render_chunk(start_frame):
        frames = anim.render_frames(
            chunk, fps=args.fps, start_frame=start_frame, scene=scene, packed=True
        )
        jax.block_until_ready(frames)
        return frames

    # compile + warm outside the timed loop
    warm = render_chunk(-chunk)
    _ = jax.device_get(warm[0, 0, 0])
    overhead_ms = calibrate_dispatch_overhead_ms()
    print(f"Fused-scan mode: chunk={chunk}, dispatch overhead ~{overhead_ms:.1f} ms")

    frame_idx = 0
    first_frame_time = None
    while True:
        if args.duration is not None:
            if first_frame_time is None:
                first_frame_time = time.perf_counter()
                print(f"Benchmark started. Will run for {args.duration} seconds.")
            elif time.perf_counter() - first_frame_time >= args.duration:
                elapsed = time.perf_counter() - first_frame_time
                print(f"Benchmark duration reached ({elapsed:.2f}s). Exiting...")
                break

        t0 = time.perf_counter()
        frames = render_chunk(frame_idx)
        bracket_ms = (time.perf_counter() - t0) * 1000.0
        device_ms = max(bracket_ms - overhead_ms, 0.0) / chunk

        n_use = chunk
        if args.frames:
            n_use = min(chunk, args.frames - frame_idx)

        host_ms = 0.0
        streamer = getattr(args, "_streamer", None)
        if args.out or streamer is not None:
            t_h0 = time.perf_counter()
            # ascontiguousarray: .view(uint8) needs a contiguous buffer
            host = np.ascontiguousarray(jax.device_get(frames)).view(np.uint8)
            host = host.reshape(host.shape[0], host.shape[1], -1, 4)
            if args.out:
                for k in range(n_use):
                    _write_host_frame(args, host[k], frame_idx + k, stats)
            if streamer is not None:
                # always-latest semantics: publish the newest frame of the
                # chunk (a browser can't display 60 fps x chunk anyway)
                streamer.submit(host[n_use - 1])
            host_ms = (time.perf_counter() - t_h0) * 1000.0

        frame_ms = bracket_ms / chunk + host_ms / max(n_use, 1)
        # cpu_time_ms in fused mode = the host's actual per-frame share:
        # the calibrated dispatch overhead amortized over the chunk plus
        # any PNG writeback. (The reference's column is per-frame host
        # cost, main.rs:1048-1056; a fused loop's host is otherwise idle,
        # so 0.00 would be honest but mean something different.)
        cpu_ms = overhead_ms / chunk + host_ms / max(n_use, 1)
        for _ in range(n_use):
            stats.record_frame_time_ms(frame_ms)
            stats.update_cpu_time(cpu_ms)
            stats.update_gpu_time(device_ms)
            if logger is not None:
                logger.log_frame(stats)
        frame_idx += n_use
        if args.frames and frame_idx >= args.frames:
            break
    return frame_idx


def _per_frame_loop(args, renderer, scene, stats, logger) -> int:
    """Reference-style loop: one dispatch + host sync per frame
    (main.rs:1110-1131). The camera tracks wall-clock time unless --frames
    pins the time base to the frame index."""
    warm = renderer.render_frame(orbit_camera(0.0), scene)  # compile outside timing
    _ = jax.device_get(warm[0, 0, 0])
    overhead_ms = calibrate_dispatch_overhead_ms()

    start = time.perf_counter()
    first_frame_time = None
    frame_idx = 0
    while True:
        stats.update_frame_time()
        cpu_start = time.perf_counter()

        if args.duration is not None:
            if first_frame_time is None:
                first_frame_time = time.perf_counter()
                print(f"Benchmark started. Will run for {args.duration} seconds.")
            elif time.perf_counter() - first_frame_time >= args.duration:
                elapsed = time.perf_counter() - first_frame_time
                print(f"Benchmark duration reached ({elapsed:.2f}s). Exiting...")
                break

        # camera is a pure function of elapsed time (main.rs:851-869)
        t = time.perf_counter() - start if args.frames == 0 else frame_idx / args.fps
        camera = orbit_camera(t)

        q = TimestampQuery(overhead_ms=overhead_ms)
        if getattr(renderer, "multires", 0):
            q.begin()
            frame = renderer.render_frame_multires(
                camera, scene, divisor=renderer.multires
            )
            frame.block_until_ready()
            q.end()
        else:
            frame = renderer.render_frame(camera, scene, timestamp_query=q)

        streamer = getattr(args, "_streamer", None)
        if args.out or streamer is not None:
            host = np.asarray(jax.device_get(frame))
            if args.out:
                _write_host_frame(args, host, frame_idx, stats)
            if streamer is not None:
                streamer.submit(host)

        cpu_ms = (time.perf_counter() - cpu_start) * 1000.0
        stats.update_cpu_time(cpu_ms)
        if q.gpu_time_ms is not None:
            stats.update_gpu_time(q.gpu_time_ms)
        if logger is not None:
            logger.log_frame(stats)

        frame_idx += 1
        if args.frames and frame_idx >= args.frames:
            break
    return frame_idx


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import logging

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.WARNING,
        format="%(levelname)s %(name)s: %(message)s",
    )

    plugin = None
    if args.plugin:
        from .utils.plugin import load_plugin

        load_plugin(args.plugin)  # fail fast on a bad plugin file
        plugin = args.plugin
        args.model = "custom"

    if args.multires and args.debug_steps:
        raise SystemExit("--multires is incompatible with --debug-steps")
    texsub = (
        args.texture_subsample
        if args.texture_subsample == "checker"
        else int(args.texture_subsample)
    )
    renderer = BlackHoleRenderer(
        args.width,
        args.height,
        args.integrator,
        model=None if plugin else args.model,
        custom_physics=plugin,
        adaptive=args.adaptive,
        disk=args.disk,
        fast_math=args.fast_math,
        use_pallas=False if args.oracle else None,
        skybox=args.skybox,
        texture_filter=args.texture_filter,
        texture_subsample=texsub,
        tonemap=args.tonemap,
        multires=args.multires,
        neural_params=args.neural_weights,
    )
    chunk = args.chunk if args.chunk > 0 else DEFAULT_CHUNK
    print(
        f"Device: {renderer.device} (pallas={'on' if renderer.use_pallas else 'off'}, "
        f"chunk={chunk})"
    )

    stats = PerformanceStats()
    logger = None
    if args.perf_log:
        try:
            logger = PerfLogger(args.perf_log)
        except OSError as e:  # degrade to no logging (main.rs:534-542)
            print(f"Warning: failed to create performance log: {e}")

    scene = SceneParams(
        schwarzschild_radius=2.0,
        # plugins get --spin too (their accel signature receives it)
        spin=args.spin if args.model.startswith(("kerr", "custom")) else 0.0,
        screen_width=args.width,
        screen_height=args.height,
        max_steps=args.max_steps,
        debug_mode=DEBUG_STEPS if args.debug_steps else DEBUG_NONE,
    )

    if args.out:
        os.makedirs(args.out, exist_ok=True)

    args._streamer = None
    if args.serve is not None:
        from .io.viewer import FrameStreamer

        args._streamer = FrameStreamer(args.serve)
        print(f"Live view: {args._streamer.url}")

    frame_idx = 0
    rc = 0
    try:
        if chunk > 1:
            frame_idx = _chunked_loop(args, renderer, scene, stats, logger, chunk)
        else:
            frame_idx = _per_frame_loop(args, renderer, scene, stats, logger)
    except KeyboardInterrupt:
        print("Interrupted.")
    except jax.errors.JaxRuntimeError as e:
        # device-loss analog of the reference's SurfaceError handling
        # (main.rs:1113-1117): log and exit, don't hang
        print(f"Device error, exiting: {e}")
        rc = 1
    finally:
        if args.out:
            from .io import native

            failures = native.drain()
            if failures:
                print(f"Warning: {failures} frame write(s) failed")
        if args._streamer is not None:
            args._streamer.close()
        if logger is not None:
            logger.close()

    print(
        f"{frame_idx} frames | avg {stats.avg_fps():.1f} FPS "
        f"(min {stats.min_fps():.1f} / max {stats.max_fps():.1f}) | "
        f"avg device {stats.avg_gpu_time():.2f} ms"
    )
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
