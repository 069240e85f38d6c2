"""Animation: fused multi-frame rendering with zero host round-trips.

The analog of the reference's windowed animation loop (reference:
src/main.rs:264-1147): an orbiting camera (angle = t * 0.3 rad/s, radius 15,
height 5, looking at the origin — main.rs:851-869) rendered frame after
frame. Where the reference round-trips the host every frame (uniform writes,
blocking timestamp readback — main.rs:887-921), here N frames are fused into
one `lax.scan` whose carry never leaves the device; the host sees pixels
only at chunk boundaries, where the native async PNG writer picks them up.

The animation is a pure function of frame index, so it is deterministic and
resumable: render_frames(start_frame=k) continues an interrupted run
bit-exactly (SURVEY.md §5 checkpoint/resume note).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from .core.camera import orbit_camera
from .models.disk import DiskParams
from .renderer import BlackHoleRenderer, render_image

# App-mode animation uses max_steps=200 (reference: src/main.rs:878).
APP_MAX_STEPS = 200


@functools.partial(
    jax.jit,
    static_argnames=(
        "config",
        "use_pallas",
        "tonemap",
        "seed",
        "packed",
        "camera_fn",
        "texture_filter",
        "texture_subsample",
        "multires",
        "neural_precision",
    ),
)
def render_frames_scan(
    times,
    scene,
    skybox,
    disk_params,
    lut,
    orbit=None,
    *,
    config,
    use_pallas,
    tonemap="passthrough",
    seed=2020,
    packed=False,
    camera_fn=None,
    texture_filter="bilinear",
    texture_subsample=1,
    multires=0,
    neural_params=None,
    neural_precision="bf16",
):
    """Render frames at `times` (fp32[F]) in one fused lax.scan.

    The camera path is either the reference orbit — `orbit` =
    (rotation_speed, radius, height) as traced scalars — or an arbitrary
    jax-traceable `camera_fn(t) -> Camera` (static; a new function object
    retraces). Returns uint8 (F, H, W, 4) — or packed u32 (F, H, W) when
    `packed` — all frames rendered on device with no host sync. Internally
    the scan carries the packed-u32 frame format (well-tiled planes); the
    uint8 view is a single bitcast at the end.
    """
    from .ops.sampling import unpack_frame

    if camera_fn is None:
        speed, radius, height = orbit

        def camera_fn(t):
            return orbit_camera(t, radius=radius, height=height, rotation_speed=speed)

    def step(carry, t):
        cam = camera_fn(t)
        if multires:
            # roadmap Phase 4-1 approximation inside the fused scan:
            # 1/multires-res geodesics + edge fix-up (ops/multires.py)
            from .ops.multires import render_multires

            frame = render_multires(
                cam,
                scene,
                skybox,
                disk_params,
                lut,
                config=config,
                divisor=multires,
                texture_filter=texture_filter,
                texture_subsample=texture_subsample,
                seed=seed,
                packed=True,
            )
        else:
            frame = render_image(
                cam,
                scene,
                skybox,
                disk_params,
                lut,
                config=config,
                use_pallas=use_pallas,
                tonemap=tonemap,
                seed=seed,
                packed=True,
                texture_filter=texture_filter,
                texture_subsample=texture_subsample,
                neural_params=neural_params,
                neural_precision=neural_precision,
            )
        return carry, frame

    _, frames = jax.lax.scan(step, 0, times)
    return frames if packed else unpack_frame(frames)


class PathAnimator:
    """Animation driver over an arbitrary camera path.

    `camera_fn(t) -> Camera` must be jax-traceable (pure jnp); the whole
    animation still fuses into one on-device lax.scan. Generalizes the
    reference's hardcoded orbit (main.rs:851-869).
    """

    def __init__(self, renderer: BlackHoleRenderer, camera_fn):
        self.renderer = renderer
        self.camera_fn = camera_fn

    def _scan_kwargs(self):
        return dict(camera_fn=self.camera_fn)

    def frame_times(self, n_frames: int, fps: float = 60.0, start_frame: int = 0):
        idx = jnp.arange(start_frame, start_frame + n_frames, dtype=jnp.float32)
        return idx / jnp.float32(fps)

    def render_frames(
        self,
        n_frames: int,
        fps: float = 60.0,
        start_frame: int = 0,
        scene=None,
        packed: bool = False,
    ) -> jnp.ndarray:
        """All frames fused in one scan -> uint8 (F, H, W, 4) device array
        (packed u32 (F, H, W) when `packed=True`)."""
        r = self.renderer
        scene = scene if scene is not None else r.scene
        disk_params = (
            DiskParams.for_scene(scene.schwarzschild_radius) if r.config.disk else None
        )
        return render_frames_scan(
            self.frame_times(n_frames, fps, start_frame),
            scene,
            r.skybox,
            disk_params,
            r._lut,
            config=r.config,
            use_pallas=r.use_pallas,
            tonemap=r.tonemap,
            seed=r.skybox_seed,
            packed=packed,
            texture_filter=r._sample_filter,
            texture_subsample=r.texture_subsample,
            multires=r.multires,
            neural_params=r.neural_params,
            neural_precision=r.neural_precision,
            **self._scan_kwargs(),
        )

    def _manifest(self, n_frames, fps, start_frame, scene):
        """Render-run fingerprint for the manifest sidecar: everything that
        changes frame content (resuming under a different configuration
        would silently mix incompatible frames)."""
        import numpy as np  # noqa: F811 (module-level too; explicit here)

        r = self.renderer
        scene = scene if scene is not None else r.scene
        def f(x):
            return np.asarray(x, np.float32).tolist()
        return {
            "width": r.width,
            "height": r.height,
            "fps": fps,
            "max_steps": int(scene.max_steps),
            "integrator": r.config.integrator,
            "model": r.config.model,
            "adaptive": r.config.adaptive,
            "disk": r.config.disk,
            "tonemap": r.tonemap,
            "texture_filter": r._sample_filter,
            "texture_subsample": str(r.texture_subsample),
            "skybox": "texture" if r.skybox is not None else f"procedural:{r.skybox_seed}",
            "multires": getattr(r, "multires", 0),
            "scene": {
                "black_hole_position": f(scene.black_hole_position),
                "schwarzschild_radius": f(scene.schwarzschild_radius),
                "fov": f(scene.fov),
                "spin": f(scene.spin),
            },
            "camera_path": self._path_fingerprint(),
        }

    def _path_fingerprint(self):
        fn = self.camera_fn
        return f"custom:{getattr(fn, '__qualname__', repr(fn))}"

    def render_to_dir(
        self,
        out_dir: str,
        n_frames: int,
        fps: float = 60.0,
        start_frame: int = 0,
        chunk_size: int = 16,
        scene=None,
        resume: bool = False,
    ) -> list[str]:
        """Chunked render -> PNG sequence via the native async writer.

        Frames land as frame_{index:05d}.png. With `resume=True`, frames
        already on disk are skipped and rendering continues from the first
        missing index — bit-exact, because the animation is a pure function
        of frame index (the checkpoint/resume story of SURVEY.md §5: the
        rendered frames ARE the checkpoints).

        A `manifest.json` sidecar records the full render configuration;
        resuming into a directory whose manifest disagrees raises instead
        of silently mixing frames from incompatible configurations.
        """
        import json

        from .io import native

        os.makedirs(out_dir, exist_ok=True)
        manifest = self._manifest(n_frames, fps, start_frame, scene)
        mpath = os.path.join(out_dir, "manifest.json")
        if os.path.exists(mpath):
            try:
                existing = json.load(open(mpath))
            except (OSError, json.JSONDecodeError):
                existing = None
            if resume and existing is not None and existing != manifest:
                diff = {
                    k for k in set(existing) | set(manifest)
                    if existing.get(k) != manifest.get(k)
                }
                raise ValueError(
                    f"resume=True but {mpath} was written by a different "
                    f"render configuration (differs in: {sorted(diff)}); "
                    "use a fresh directory or matching settings"
                )
        with open(mpath, "w") as fh:
            json.dump(manifest, fh, indent=1)
        paths = []
        done = 0
        if resume:
            while done < n_frames:
                idx = start_frame + done
                path = os.path.join(out_dir, f"frame_{idx:05d}.png")
                if not os.path.exists(path):
                    break
                paths.append(path)
                done += 1
        while done < n_frames:
            n = min(chunk_size, n_frames - done)
            frames = self.render_frames(n, fps, start_frame + done, scene, packed=True)
            # ascontiguousarray: .view(uint8) needs a contiguous buffer
            host = np.ascontiguousarray(jax.device_get(frames)).view(np.uint8)
            host = host.reshape(host.shape[0], host.shape[1], -1, 4)
            for k in range(n):
                idx = start_frame + done + k
                path = os.path.join(out_dir, f"frame_{idx:05d}.png")
                native.submit_frame(path, host[k])
                paths.append(path)
            done += n
        failures = native.drain()
        if failures:
            raise IOError(f"{failures} frame write(s) failed under {out_dir}")
        return paths

    def save_video(
        self, path: str, n_frames: int, fps: float = 30.0, scene=None, quality: int = 90
    ):
        """Render + export an MJPEG AVI (pure Python; no ffmpeg needed)."""
        from .io.video import write_mjpeg_avi

        frames = np.asarray(jax.device_get(self.render_frames(n_frames, fps, 0, scene)))
        write_mjpeg_avi(path, frames, fps=fps, quality=quality)

    def save_gif(self, path: str, n_frames: int, fps: float = 60.0, scene=None):
        """Small-animation convenience (PIL; no ffmpeg in the image)."""
        from PIL import Image

        frames = np.asarray(jax.device_get(self.render_frames(n_frames, fps, 0, scene)))
        imgs = [Image.fromarray(f, "RGBA").convert("P") for f in frames]
        imgs[0].save(
            path,
            save_all=True,
            append_images=imgs[1:],
            duration=int(1000.0 / fps),
            loop=0,
        )


class OrbitAnimator(PathAnimator):
    """Orbiting-camera animation driver (the reference app's path)."""

    def __init__(
        self,
        renderer: BlackHoleRenderer,
        rotation_speed: float = 0.3,  # main.rs:853
        radius: float = 15.0,  # main.rs:854
        height: float = 5.0,  # main.rs:855
    ):
        super().__init__(renderer, camera_fn=None)
        self.rotation_speed = rotation_speed
        self.radius = radius
        self.height = height

    def _scan_kwargs(self):
        orbit = (
            jnp.float32(self.rotation_speed),
            jnp.float32(self.radius),
            jnp.float32(self.height),
        )
        return dict(orbit=orbit)

    def _path_fingerprint(self):
        return (
            f"orbit:speed={float(self.rotation_speed)}"
            f",radius={float(self.radius)},height={float(self.height)}"
        )

