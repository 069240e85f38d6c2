"""Renderer engine: the public API layer.

JAX analog of the reference's `GpuContext` + `BlackHoleRenderer`
(reference: src/lib.rs:144-201, 317-703). The API surface preserves the
reference names and defaults so the published notebook workflow ports
directly (SURVEY.md §3.5):

    ctx = TpuContext.new()
    renderer = BlackHoleRenderer.new_with_context(ctx, 800, 600)
    camera = Camera.new([15, 5, 0], [0, 0, 0], [0, 1, 0])
    scene = SceneParams(schwarzschild_radius=2.0, ...)
    renderer.render_frame(camera, scene)
    renderer.save_image("black_hole_render.png")

Where the reference took a WGSL `shader_path` to hot-swap integrators
(src/main.rs:30, lib.rs:425-429), this renderer takes an `integrator` /
`model` config axis ("euler"/"rk4" x "schwarzschild"/"kerr"/"flat") — paths
containing "euler"/"rk4" are accepted and mapped for backward parity.

The whole frame pipeline (ray-gen -> geodesic kernel -> skybox gather ->
tonemap -> rgba8) is one jit program; the rendered frame stays in HBM until
`get_image_data`/`save_image` crosses to the host (the only transfer,
mirroring lib.rs:613-686's explicit readback boundary).
"""

from __future__ import annotations

import asyncio
import functools
import inspect
import logging

import jax
import jax.numpy as jnp
import numpy as np

from .core.camera import Camera, generate_rays
from .core.scene import SceneParams
from .io import image as image_io
from .io.skybox import load_skybox
from .models.disk import DiskParams, blackbody_lut
from .models.neural import NEURAL_TIERS, inference_tier
from .ops import display as display_ops
from .ops.pallas_trace import KERNEL_COMPILED, kernel_mode, pallas_trace_image
from .ops.shading import shade_planes_packed
from .ops.sampling import (
    pack_texture_rgba8,
    sample_equirect_packed,
    unpack_frame,
)
from .ops.starfield import procedural_background
from .ops.trace import TraceConfig, trace_rays


class TpuContext:
    """Device context — the analog of GpuContext (reference: lib.rs:144-201).

    Owns the jax device the renderer computes on. `new()` takes JAX's
    default device (a GPU when one is present, else the CPU), the moral
    equivalent of wgpu's PowerPreference::HighPerformance adapter request
    (lib.rs:159-166).
    """

    def __init__(self, device=None):
        self.device = device if device is not None else jax.devices()[0]

    @classmethod
    def new(cls) -> "TpuContext":
        return cls()

    @property
    def platform(self) -> str:
        return self.device.platform

    def __repr__(self):
        return f"TpuContext(device={self.device})"


# Reference-name alias: code written against the reference's `GpuContext`
# keeps working.
GpuContext = TpuContext

logger = logging.getLogger("bhr_tpu")


def _integrator_from_path(name: str) -> tuple[str, str]:
    """Map an integrator name or legacy shader path to (integrator, model)."""
    low = name.lower()
    model = "kerr" if "kerr" in low else "schwarzschild"
    if "kerr_lt" in low or "lense" in low:
        model = "kerr_lt"
    if "flat" in low:
        model = "flat"
    if "neural" in low or "mlp" in low:
        # roadmap Phase 5 surrogate (models/neural.py) — Schwarzschild only
        integrator = "neural"
    elif "rk4" in low:
        integrator = "rk4"
    elif "leapfrog" in low or "verlet" in low:
        integrator = "leapfrog"
    else:
        integrator = "euler"
    return integrator, model


@functools.partial(
    jax.jit,
    static_argnames=(
        "config",
        "use_pallas",
        "tonemap",
        "seed",
        "packed",
        "texture_filter",
        "texture_subsample",
        "neural_precision",
    ),
)
def render_image(
    camera: Camera,
    scene: SceneParams,
    skybox,
    disk_params,
    lut,
    *,
    config: TraceConfig,
    use_pallas: bool,
    tonemap: str = "passthrough",
    seed: int = 2020,
    packed: bool = False,
    texture_filter: str = "bilinear",
    texture_subsample: int = 1,
    neural_params=None,
    neural_precision: str = "bf16",
):
    """Pure jittable frame pipeline.

    `use_pallas` traces with the Pallas-Triton geodesic kernel
    (ops/pallas_trace.py); otherwise with the XLA oracle (ops/trace.py). `skybox` is a packed-u32 (Ht, Wt) equirect
    texture, or None for the analytic procedural star field
    (ops/starfield.py). Returns uint8 (H, W, 4), or the packed u32 (H, W)
    frame when `packed=True` (see sampling.unpack_frame).
    """
    if config.integrator == "neural":
        # roadmap Phase 5: the deflection field comes from the MLP
        # surrogate (batched matmuls) instead of geodesic integration
        from .models.neural import tier_matmul_args
        from .ops.neural_trace import neural_trace_image

        result = neural_trace_image(
            neural_params, camera, scene, **tier_matmul_args(neural_precision)
        )
    else:
        result = trace_image(camera, scene, config, use_pallas=use_pallas)
    return shade_image(
        result,
        camera,
        scene,
        skybox,
        disk_params,
        lut,
        tonemap=tonemap,
        seed=seed,
        packed=packed,
        texture_filter=texture_filter,
        texture_subsample=texture_subsample,
    )


def trace_image(camera, scene, config, *, use_pallas):
    """TraceResult for the full frame: Pallas kernel or XLA oracle."""
    if use_pallas:
        return pallas_trace_image(camera, scene, config)
    origins, dirs = generate_rays(
        camera, scene.screen_width, scene.screen_height, scene.fov
    )
    return trace_rays(
        origins,
        dirs,
        scene.black_hole_position,
        scene.schwarzschild_radius,
        scene.spin,
        scene.max_steps,
        config,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "tonemap", "seed", "packed", "texture_filter", "texture_subsample",
    ),
)
def shade_image(
    result,
    camera,
    scene,
    skybox,
    disk_params,
    lut,
    *,
    tonemap: str,
    seed: int = 2020,
    packed: bool = False,
    texture_filter: str = "bilinear",
    texture_subsample: int = 1,
):
    """The shading epilogue as a standalone jit program: TraceResult ->
    frame. render_image dispatches through it; the static-camera
    deflection cache (roadmap Phase 4-4) re-runs ONLY this per frame."""
    if skybox is None:
        background = functools.partial(procedural_background, seed=seed)
    elif texture_filter == "luma" and scene.debug_mode == 0:
        # luma tier: exact-bilinear luminance per pixel, chroma on a
        # subsampled grid (texture_subsample, default 2)
        from .ops.sampling import sample_equirect_packed_luma

        chroma_sub = (
            texture_subsample
            if isinstance(texture_subsample, int) and texture_subsample > 1
            else 2
        )
        sub_rgb = sample_equirect_packed_luma(
            skybox,
            result.final_vel[..., 0],
            result.final_vel[..., 1],
            result.final_vel[..., 2],
            result.status,
            chroma_sub=chroma_sub,
        )
        background = lambda vx, vy, vz: sub_rgb
    elif texture_subsample != 1 and scene.debug_mode == 0:
        # gather-count attack: sample the texture on a subset of the
        # full-res directions, reconstruct the rest (see sampling module);
        # "checker" = half-count checkerboard, int sub = 1/sub^2 grid
        from .ops.sampling import (
            sample_equirect_packed_checkerboard,
            sample_equirect_packed_subsampled,
        )

        planes = (
            result.final_vel[..., 0],
            result.final_vel[..., 1],
            result.final_vel[..., 2],
            result.status,
        )
        if texture_subsample == "checker":
            sub_rgb = sample_equirect_packed_checkerboard(
                skybox, *planes, filter=texture_filter
            )
        else:
            sub_rgb = sample_equirect_packed_subsampled(
                skybox, *planes, texture_subsample, filter=texture_filter
            )
        background = lambda vx, vy, vz: sub_rgb
    else:
        background = functools.partial(
            sample_equirect_packed, skybox, filter=texture_filter
        )
    tm = display_ops.TONEMAPS[tonemap]
    frame = shade_planes_packed(
        result,
        background,
        scene.max_steps,
        debug_mode=scene.debug_mode,
        bh_pos=scene.black_hole_position,
        rs=scene.schwarzschild_radius,
        camera_position=camera.position,
        disk_params=disk_params,
        blackbody_lut=lut,
        tonemap=None if tonemap == "passthrough" else tm,
    )
    return frame if packed else unpack_frame(frame)


class BlackHoleRenderer:
    """Black-hole ray-tracing engine (reference: src/lib.rs:317-703)."""

    def __init__(
        self,
        width: int = 800,
        height: int = 600,
        integrator: str = "euler",
        *,
        model: str | None = None,
        context: TpuContext | None = None,
        skybox=None,
        use_pallas: bool | None = None,
        fast_math: bool = False,
        adaptive: bool = False,
        disk: bool = False,
        tonemap: str = "passthrough",
        dt: float | None = None,
        skybox_seed: int = 2020,
        texture_filter: str = "bilinear",
        texture_subsample: int = 1,
        multires: int = 0,
        cache_deflection: bool = False,
        neural_params=None,
        neural_precision: str = "auto",
        custom_physics=None,
    ):
        """`fast_math` selects the Pallas kernel's approximate math tier
        (TraceConfig.fast_math): faster on the GPU, within the oracle parity
        contract. The default is the exact tier; the XLA oracle
        (`use_pallas=False`) is always exact."""
        self.context = context or TpuContext.new()
        self.width = int(width)
        self.height = int(height)
        integ, path_model = _integrator_from_path(integrator)
        # runtime-swappable physics (the reference's --shader hot-swap,
        # lib.rs:425-429): a .py path / module / callable providing
        # acceleration(rel, vel, r, r2, rs, spin) on component planes
        extra_cfg = {}
        if custom_physics is not None:
            from .utils.plugin import load_plugin

            if model not in (None, "custom"):
                raise ValueError(
                    f"custom_physics conflicts with model={model!r}; leave "
                    "model unset (it becomes 'custom')"
                )
            accel_fn, cap = load_plugin(custom_physics)
            extra_cfg = {
                "custom_accel": accel_fn,
                "custom_capture_factor": cap,
            }
            model = "custom"
        elif model == "custom":
            raise ValueError("model='custom' needs custom_physics=")
        self.config = TraceConfig(
            integrator=integ,
            model=model or path_model,
            adaptive=adaptive,
            disk=disk,
            fast_math=bool(fast_math),
            **({"dt": dt} if dt is not None else {}),
            **extra_cfg,
        )
        # roadmap Phase 5 neural surrogate: Schwarzschild or exact Kerr
        # deflection (models/neural.py, models/neural_kerr.py) — no
        # disk/adaptive/debug
        self.neural_params = None
        # matmul tier of the surrogate: it must match the precision the
        # weights were trained at (models/neural.tier_matmul_args); "auto"
        # resolves from the asset meta below
        if neural_precision not in ("auto", *NEURAL_TIERS):
            raise ValueError(
                f"neural_precision must be auto/{'/'.join(NEURAL_TIERS)}, "
                f"got {neural_precision!r}"
            )
        self.neural_precision = neural_precision
        if integ == "neural":
            neural_model = model or path_model
            if neural_model not in ("schwarzschild", "kerr"):
                raise ValueError(
                    "integrator='neural' supports model='schwarzschild' or "
                    f"'kerr' (got {neural_model!r}); surrogates are trained "
                    "on those dynamics (models/neural.py, "
                    "models/neural_kerr.py)"
                )
            if adaptive or disk:
                raise ValueError(
                    "integrator='neural' does not support adaptive stepping "
                    "or the accretion disk — it predicts only the final "
                    "direction and capture status (docs/ROADMAP.md:1217-1337)"
                )
            if multires:
                raise ValueError(
                    "integrator='neural' has no multires mode (the surrogate "
                    "already skips integration; there is no low-res geodesic "
                    "pass to save)"
                )
            if neural_model == "kerr":
                from .models.neural_kerr import load_params
            else:
                from .models.neural import load_params

            if neural_params is None:
                import pathlib

                asset = (
                    "neural_kerr.npz"
                    if neural_model == "kerr"
                    else "neural_schwarzschild.npz"
                )
                default = pathlib.Path(__file__).parent / "assets" / asset
                if not default.exists():
                    script = (
                        "scripts/train_neural_kerr.py"
                        if neural_model == "kerr"
                        else "scripts/train_neural.py"
                    )
                    raise FileNotFoundError(
                        f"no trained surrogate weights at {default}; run "
                        f"{script} (or pass neural_params=)"
                    )
                neural_params = str(default)
            self._neural_domain = None
            self._neural_spin_range = None
            if isinstance(neural_params, (str, bytes)):
                neural_params, meta = load_params(neural_params)
                if "r_range" in meta and "rs_range" in meta:
                    self._neural_domain = (
                        tuple(np.asarray(meta["r_range"], np.float32)),
                        tuple(np.asarray(meta["rs_range"], np.float32)),
                    )
                if "spin_range" in meta:
                    self._neural_spin_range = tuple(
                        np.asarray(meta["spin_range"], np.float32)
                    )
                if self.neural_precision == "auto":
                    self.neural_precision = inference_tier(
                        meta.get("train_precision")
                    )
            self.neural_params = jax.device_put(
                neural_params, self.context.device
            )
        if self.neural_precision == "auto":
            # no asset meta to consult (raw param pytree, or no surrogate):
            # the committed assets' training tier
            self.neural_precision = inference_tier(None)
        mode = kernel_mode(self.context.platform)
        if use_pallas is None:
            # the kernel is the GPU path; the XLA oracle is the CPU default
            use_pallas = mode == KERNEL_COMPILED
        self.use_pallas = bool(use_pallas)
        self.tonemap = tonemap

        # default camera/scene (reference: lib.rs:354-370)
        self.camera = Camera.default()
        self.scene = SceneParams(
            screen_width=self.width, screen_height=self.height
        )
        # skybox: None -> analytic procedural star field (gather-free fast
        # path); a path/array -> decode + pack + upload (the analog of
        # load_texture_from_file + queue.write_texture, lib.rs:208-267)
        if texture_filter == "fast":
            raise ValueError(
                "the 'fast' prefiltered tier was removed (a 512 MB table "
                "for an approximation); use 'luma' (bilinear-exact "
                "luminance at ~nearest gather count) instead"
            )
        if texture_filter not in ("bilinear", "nearest", "luma"):
            raise ValueError(
                f"texture_filter must be bilinear/nearest/luma, got {texture_filter!r}"
            )
        self.texture_filter = texture_filter
        # int > 1: texture color sampled on a 1/sub grid of the full-res
        # directions and bilinearly upsampled (gather cost / sub^2);
        # "checker": half the pixels sampled in a checkerboard, holes
        # reconstructed from distance-1 neighbors (gather cost / 2, the
        # star-preserving quality point). Captured samples excluded either
        # way (ops/sampling).
        if texture_subsample == "checker":
            self.texture_subsample = "checker"
        elif int(texture_subsample) < 1:
            raise ValueError("texture_subsample must be >= 1 or 'checker'")
        else:
            self.texture_subsample = int(texture_subsample)
        self._sample_filter = texture_filter
        if skybox is None:
            self.skybox = None
        else:
            tex = load_skybox(skybox)
            packed = jax.device_put(
                pack_texture_rgba8(tex), self.context.device
            )
            if texture_filter == "bilinear":
                # exact bilinear at ONE slice-3 row gather/pixel: the three
                # channel corner-words of a footprint sit contiguously
                # (ops/sampling.corner_pack_texture_rows)
                from .ops.sampling import corner_pack_texture_rows

                packed = jax.jit(corner_pack_texture_rows)(packed)
            elif texture_filter == "luma":
                # exact-bilinear LUMINANCE at 1 gather/pixel + subsampled
                # chroma (ops/sampling.luma_pack_texture)
                from .ops.sampling import luma_pack_texture

                packed = jax.jit(luma_pack_texture)(packed)
            self.skybox = packed
        self.skybox_seed = int(skybox_seed)
        # multires divisor for the ANIMATION path (PathAnimator /
        # render_frames_scan / app --multires): 0 = full resolution.
        # render_frame stays full-res; use render_frame_multires for
        # single frames.
        if multires and int(multires) < 0:
            raise ValueError("multires divisor must be >= 0")
        self.multires = int(multires)
        self._lut = jax.device_put(blackbody_lut(), self.context.device) if disk else None
        # static-camera deflection caching (reference roadmap Phase 4-4,
        # docs/ROADMAP.md:1100-1209): when enabled, render_frame keeps the
        # traced deflection field and re-runs ONLY the shading epilogue as
        # long as the camera/scene geometry is unchanged — texture /
        # tonemap / seed edits then cost ~the shading pass. Frames always
        # go through the staged pipeline so cached and uncached renders
        # are identical.
        self.cache_deflection = bool(cache_deflection)
        self._deflection_key = None
        self._deflection_result = None
        self._last_frame = None
        logger.info(
            "BlackHoleRenderer %dx%d on %s: integrator=%s model=%s pallas=%s "
            "skybox=%s",
            self.width, self.height, self.context.device, self.config.integrator,
            self.config.model, self.use_pallas,
            "texture" if self.skybox is not None else "procedural",
        )

    # -- constructors matching the reference API (lib.rs:339, 351) ---------

    @classmethod
    def new(cls, width: int, height: int, shader_path: str = "euler", **kw):
        return cls(width, height, shader_path, **kw)

    @classmethod
    def new_with_context(
        cls, context: TpuContext, width: int, height: int, shader_path: str = "euler", **kw
    ):
        return cls(width, height, shader_path, context=context, **kw)

    # -- the hot path (lib.rs:550-590) --------------------------------------

    def render_frame(
        self,
        camera: Camera | None = None,
        scene: SceneParams | None = None,
        timestamp_query=None,
    ) -> jnp.ndarray:
        """Render one frame; returns (and retains) the uint8 RGBA device array.

        `timestamp_query` optionally receives device timing: pass a
        TimestampQuery (utils/timing.py) and its gpu_time_ms is populated —
        the analog of the wgpu timestamp-query plumbing (lib.rs:569-577).
        """
        camera = camera if camera is not None else self.camera
        scene = scene if scene is not None else self.scene
        if (scene.screen_width, scene.screen_height) != (self.width, self.height):
            scene = scene.replace(screen_width=self.width, screen_height=self.height)
        if (
            self.config.integrator == "neural"
            and getattr(self, "_neural_domain", None) is not None
        ):
            # weights carry their trained (r0, rs) domain; outside it the
            # surrogate extrapolates with unknown quality — warn, don't fail
            r_rng, rs_rng = self._neural_domain
            r0 = float(
                np.linalg.norm(
                    np.asarray(camera.position, np.float32)
                    - np.asarray(scene.black_hole_position, np.float32)
                )
            )
            rs_v = float(np.asarray(scene.schwarzschild_radius, np.float32))
            if not (r_rng[0] <= r0 <= r_rng[1] and rs_rng[0] <= rs_v <= rs_rng[1]):
                logger.warning(
                    "neural surrogate extrapolating outside its trained "
                    "domain: camera r0=%.1f (trained %.1f-%.1f), rs=%.2f "
                    "(trained %.2f-%.2f) — quality is unvalidated there; "
                    "retrain with scripts/train_neural.py or use the "
                    "general weights",
                    r0, r_rng[0], r_rng[1], rs_v, rs_rng[0], rs_rng[1],
                )
        # independent of the (r0, rs) domain check: weights saved with a
        # spin_range but no r_range/rs_range meta must still warn
        sp_rng = getattr(self, "_neural_spin_range", None)
        if self.config.integrator == "neural" and sp_rng is not None:
            spin_v = float(np.asarray(scene.spin, np.float32))
            if not sp_rng[0] <= spin_v <= sp_rng[1]:
                logger.warning(
                    "Kerr neural surrogate extrapolating outside its "
                    "trained spin range: a*=%.2f (trained %.2f-%.2f)",
                    spin_v, sp_rng[0], sp_rng[1],
                )
        disk_params = (
            DiskParams.for_scene(scene.schwarzschild_radius) if self.config.disk else None
        )
        if timestamp_query is not None:
            timestamp_query.begin()
        if self.cache_deflection and scene.debug_mode == 0:
            frame = self._render_cached(camera, scene, disk_params)
            if timestamp_query is not None:
                frame.block_until_ready()
                timestamp_query.end()
            self.camera = camera
            self.scene = scene
            self._last_frame = frame
            return frame
        frame = render_image(
            camera,
            scene,
            self.skybox,
            disk_params,
            self._lut,
            config=self.config,
            use_pallas=self.use_pallas,
            tonemap=self.tonemap,
            seed=self.skybox_seed,
            texture_filter=self._sample_filter,
            texture_subsample=self.texture_subsample,
            neural_params=self.neural_params,
            neural_precision=self.neural_precision,
        )
        if timestamp_query is not None:
            frame.block_until_ready()
            timestamp_query.end()
        self.camera = camera
        self.scene = scene
        self._last_frame = frame
        return frame

    def _static_key(self, camera, scene):
        """Geometry fingerprint: anything that changes the traced
        deflection field (camera basis, BH params, fov, steps, config)."""
        arrs = (
            camera.position, camera.forward, camera.right, camera.up,
            scene.black_hole_position, scene.schwarzschild_radius,
            scene.fov, scene.spin,
        )
        return (
            tuple(np.asarray(a, np.float32).tobytes() for a in arrs),
            scene.max_steps, scene.screen_width, scene.screen_height,
            self.config, self.use_pallas, self.neural_precision,
        )

    def _render_cached(self, camera, scene, disk_params):
        """Phase 4-4 path: trace once per camera/scene geometry, reshade
        every frame (renderer.shade_image)."""
        key = self._static_key(camera, scene)
        if key != self._deflection_key:
            if self.config.integrator == "neural":
                from .models.neural import tier_matmul_args
                from .ops.neural_trace import neural_trace_image_jit

                result = neural_trace_image_jit(
                    self.neural_params, camera, scene,
                    **tier_matmul_args(self.neural_precision),
                )
            else:
                result = trace_image(
                    camera, scene, self.config, use_pallas=self.use_pallas
                )
            self._deflection_key = key
            self._deflection_result = result
        return shade_image(
            self._deflection_result,
            camera,
            scene,
            self.skybox,
            disk_params,
            self._lut,
            tonemap=self.tonemap,
            seed=self.skybox_seed,
            texture_filter=self._sample_filter,
            texture_subsample=self.texture_subsample,
        )

    def render_frame_multires(self, camera=None, scene=None, *, divisor=3,
                              **kw):
        """Approximate frame via 1/divisor-resolution geodesics + shadow-edge
        fix-up (reference roadmap Phase 4-1; ops/multires.py). The star
        field / texture shades at FULL resolution on the interpolated
        deflection field, so only the lensing geometry is coarse. Disk configs interpolate the hit-position field
        the same way (ops/multires.py docstring); debug modes are not
        supported."""
        from .ops.multires import render_multires

        if self.config.integrator == "neural":
            raise ValueError("multires is not supported with integrator='neural'")
        camera = camera if camera is not None else self.camera
        scene = scene if scene is not None else self.scene
        if scene.screen_width != self.width or scene.screen_height != self.height:
            scene = scene.replace(screen_width=self.width, screen_height=self.height)
        kw.setdefault("texture_subsample", self.texture_subsample)
        disk_params = (
            DiskParams.for_scene(scene.schwarzschild_radius)
            if self.config.disk else None
        )
        frame = render_multires(
            camera, scene, self.skybox, disk_params, self._lut,
            config=self.config, divisor=divisor,
            texture_filter=self._sample_filter, seed=self.skybox_seed, **kw,
        )
        self.camera = camera
        self.scene = scene
        self._last_frame = frame
        return frame

    def distill(self, camera=None, scene=None, *, rays=1_000_000,
                steps=8_000, seed=0, save=None, **kw):
        """Distill the neural surrogate for THIS scene, on-device, in-place.

        The generality story of the Phase-5 surrogate (reference
        docs/ROADMAP.md:1217-1337): the general net covers the full
        (r0, rs) domain; per-scene distilled weights target the roadmap's
        >0.99 star-field SSIM bar on their scene class. Distillation
        closes most, not provably all, of the general-net gap; gauge a
        new scene with scripts/neural_quality.py. This makes distillation a
        first-class renderer operation instead of an offline pipeline:
        generate oracle rollouts on the scene's (r0, rs) manifold,
        fine-tune the current weights (width preserved, so the
        already-compiled frame functions are reused as-is), and swap them in.

        Returns the held-out metrics dict (median/p99 deflection error in
        degrees, capture accuracy, final loss). `save` optionally writes
        the distilled weights as an .npz reloadable via neural_params=.
        Extra kw (lr, r_margin, max_steps, dt, ...) forward to
        models.neural.distill_for_scene.
        """
        if self.config.integrator != "neural":
            raise ValueError(
                "distill() requires integrator='neural' (it retrains the "
                "surrogate; construct the renderer with integrator='neural')"
            )
        camera = camera if camera is not None else self.camera
        scene = scene if scene is not None else self.scene
        rel = np.asarray(camera.position, np.float32) - np.asarray(
            scene.black_hole_position, np.float32
        )
        r0 = float(np.linalg.norm(rel))
        rs = float(np.asarray(scene.schwarzschild_radius, np.float32))
        kw.setdefault("max_steps", int(scene.max_steps))
        kw.setdefault("dt", float(self.config.dt))
        if self.config.model == "kerr":
            # Kerr distillation also pins the spin and the camera's polar
            # latitude (Kerr is axisymmetric, not spherically symmetric;
            # models/neural_kerr.distill_for_scene_kerr)
            from .models.neural_kerr import distill_for_scene_kerr
            from .models.neural_kerr import save_params as save_kerr

            spin = float(np.asarray(scene.spin, np.float32))
            cth0 = float(rel[1] / max(r0, 1e-12))
            kw.setdefault("cth0", cth0)
            if "psi_range" not in kw:
                # Concentrate the direction sweep on the psi band this
                # frame actually covers (psi = angle from the outward
                # radial u_hat). Mirror the ray-gen formula
                # (core/camera.generate_rays) on a coarse numpy grid —
                # psi's extremes live on the image boundary or at the
                # BH's projection — and pad by ~2 deg; if the BH
                # projects inside the frame, psi_max is pi exactly.
                ff = float(np.tan(float(np.asarray(scene.fov)) * 0.5))
                aspect = float(scene.screen_width) / float(
                    scene.screen_height
                )
                g = np.linspace(-1.0, 1.0, 49, dtype=np.float32)
                uu, vv = np.meshgrid(g * aspect * ff, g * ff)
                basis = np.stack(
                    [
                        np.asarray(camera.forward, np.float32),
                        np.asarray(camera.right, np.float32),
                        np.asarray(camera.up, np.float32),
                    ]
                )
                d = (
                    basis[0]
                    + uu[..., None] * basis[1]
                    + vv[..., None] * basis[2]
                ).reshape(-1, 3)
                d /= np.linalg.norm(d, axis=-1, keepdims=True)
                u_hat = (rel / max(r0, 1e-12)).astype(np.float32)
                psi = np.arccos(np.clip(d @ u_hat, -1.0, 1.0))
                pad = float(np.radians(2.0))
                p_lo = max(0.0, float(psi.min()) - pad)
                p_hi = min(float(np.pi), float(psi.max()) + pad)
                if p_hi > np.pi - 2.0 * pad:
                    p_hi = float(np.pi)
                kw["psi_range"] = (p_lo, p_hi)
            params, metrics, domain, spin_range = distill_for_scene_kerr(
                seed, r0, rs, spin, base_params=self.neural_params,
                rays=rays, steps=steps, **kw,
            )
            self._neural_spin_range = spin_range
            extra_meta = {"spin_range": spin_range, "cth0": kw["cth0"]}
            save_fn = save_kerr
        else:
            from .models.neural import distill_for_scene, save_params

            params, metrics, domain = distill_for_scene(
                seed, r0, rs, base_params=self.neural_params,
                rays=rays, steps=steps, **kw,
            )
            extra_meta = {}
            save_fn = save_params
        self.neural_params = jax.device_put(params, self.context.device)
        self._neural_domain = domain
        # weights are native to the matmul precision they trained at
        # (models/neural.mlp_apply precision note): record it so loaders
        # can auto-select the matching inference tier.
        tp = jax.config.jax_default_matmul_precision
        tp = "default" if tp is None else str(tp)
        self.neural_precision = inference_tier(tp)
        if save:
            save_fn(
                str(save), params,
                meta=dict(
                    r_range=domain[0], rs_range=domain[1],
                    max_steps=kw["max_steps"], train_rays=rays,
                    train_steps=steps, train_precision=tp,
                    **extra_meta, **metrics,
                ),
            )
        return metrics

    # -- readback & I/O (lib.rs:613-702) ------------------------------------

    @property
    def output_texture_view(self) -> jnp.ndarray:
        """The last rendered frame, still on device (lib.rs:595-597)."""
        if self._last_frame is None:
            self.render_frame()
        return self._last_frame

    def get_image_data(self) -> np.ndarray:
        """Device frame -> host uint8 (H, W, 4) (lib.rs:613-686)."""
        return image_io.get_image_data(self.output_texture_view)

    def save_image(self, path: str) -> None:
        """Save the last frame; format by extension (lib.rs:692-702)."""
        image_io.save_image(self.output_texture_view, path)

    @property
    def device(self):
        return self.context.device

    @property
    def queue(self):
        """Reference-API parity accessor (lib.rs:605-607); jax has no
        separate queue object — returns the device."""
        return self.context.device


def block_on(value):
    """Run an awaitable to completion, or pass plain values through.

    API-parity helper for the reference's Jupyter `block_on`
    (reference: src/lib.rs:712-716). The renderer is synchronous, so
    ported notebook cells like `block_on(GpuContext.new())` just work.
    """
    if inspect.isawaitable(value):
        return asyncio.new_event_loop().run_until_complete(value)
    return value
