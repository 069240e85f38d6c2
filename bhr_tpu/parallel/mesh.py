"""Multi-device rendering over a jax device mesh.

The reference is single-device (SURVEY.md §2.2); its only parallelism is
SPMD over pixels within one GPU. Across several GPUs:

  * **sp** (spatial axis): the pixel-row dimension of a frame is sharded
    across devices — each device ray-traces a horizontal band. Rays are
    embarrassingly parallel, so the band render needs *zero*
    communication; ray-gen takes the band's global row offset.
  * **dp** (data axis): animation frames are batch-sharded across devices;
    each device scans its subset of frame times.

Collectives run only for reductions (the frame-luminance telemetry psum
below, which XLA hands to NCCL) and any host-side gather of the final
sharded image — the hot loop itself never communicates.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.camera import generate_rays, orbit_camera
from ..ops.pallas_trace import KERNEL_COMPILED, kernel_mode, pallas_trace_image
from ..ops.sampling import sample_equirect_packed, unpack_frame
from ..ops.shading import shade_planes_packed
from ..ops.starfield import procedural_background
from ..ops.trace import TraceConfig, trace_rays


def make_mesh(n_devices: int | None = None, axis_names=("dp", "sp"), shape=None) -> Mesh:
    """Build a (dp, sp) mesh over the available devices.

    Default shape puts as many devices as possible on sp (intra-frame
    banding) with dp absorbing the rest — for 8 devices: (2, 4).
    """
    devices = jax.devices()
    n = n_devices or len(devices)
    devices = devices[:n]
    if shape is None:
        if n == 1:
            shape = (1, 1)
        else:
            dp = 2 if n % 2 == 0 else 1
            shape = (dp, n // dp)
    import numpy as np

    return Mesh(np.asarray(devices).reshape(shape), axis_names)


def _platform(mesh: Mesh) -> str:
    return mesh.devices.flat[0].platform


def trace_band(camera, scene, row0, band_h, *, config, use_pallas):
    """TraceResult of rows [row0, row0+band_h) of the full image: the
    Pallas kernel with the band's row offset, or the XLA oracle on the
    band's rays."""
    local_shape = (band_h, scene.screen_width)
    if use_pallas:
        return pallas_trace_image(
            camera, scene, config, row0=row0, local_shape=local_shape,
        )
    origins, dirs = generate_rays(
        camera,
        scene.screen_width,
        scene.screen_height,
        scene.fov,
        row_offset=row0,
        local_shape=local_shape,
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


def _render_band(
    camera,
    scene,
    skybox,
    disk_params,
    lut,
    row0,
    band_h,
    *,
    config,
    use_pallas,
    tonemap,
    seed=2020,
    texture_filter="bilinear",
    neural_params=None,
    neural_precision="bf16",
    multires=0,
):
    """Render rows [row0, row0+band_h) of the full image -> packed u32 band.

    `skybox` is a packed-u32 texture or None (analytic star field).
    """
    from ..ops.display import TONEMAPS

    if multires:
        # roadmap Phase 4-1 over the mesh: each device renders its band's
        # low-res geodesics (+ halo) and edge fix-up — pixel-identical to
        # the single-device render_multires (ops/multires.py docstring)
        from ..ops.multires import render_multires_band

        return render_multires_band(
            camera, scene, skybox, disk_params,
            row0=row0, band_h=band_h, config=config, divisor=multires,
            texture_filter=texture_filter, seed=seed,
        )
    if config.integrator == "neural":
        # Phase-5 surrogate band: the MLP deflection field is trivially
        # row-shardable (pure per-pixel matmul batch)
        from ..models.neural import tier_matmul_args
        from ..ops.neural_trace import neural_trace_image

        result = neural_trace_image(
            neural_params, camera, scene, row0=row0,
            local_shape=(band_h, scene.screen_width),
            **tier_matmul_args(neural_precision),
        )
    else:
        result = trace_band(camera, scene, row0, band_h, config=config,
                            use_pallas=use_pallas)
    if skybox is None:
        background = functools.partial(procedural_background, seed=seed)
    elif texture_filter == "luma" and scene.debug_mode == 0:
        # luma tier per band; the chroma subsample grid anchors at the
        # band's first row, so chroma phases differ from a single-device
        # render by < 1 px of chroma smoothing (luma is exact either way)
        from ..ops.sampling import sample_equirect_packed_luma

        sub_rgb = sample_equirect_packed_luma(
            skybox,
            result.final_vel[..., 0],
            result.final_vel[..., 1],
            result.final_vel[..., 2],
            result.status,
        )
        background = lambda vx, vy, vz: sub_rgb
    else:
        background = functools.partial(
            sample_equirect_packed, skybox, filter=texture_filter
        )
    tm = TONEMAPS[tonemap]
    return shade_planes_packed(
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


@functools.lru_cache(maxsize=128)
def _frame_program(
    mesh, band_h, config, use_pallas, tonemap, seed, texture_filter,
    multires, neural_precision,
):
    """Build (once per static configuration) the jitted sharded-frame
    program. Callers hit this cache instead of re-closing and re-jitting a
    fresh shard_map every invocation — the second call with the same mesh
    and config does zero retracing (jax.jit caches per argument shape on
    the returned program object)."""

    def shard_fn(camera, scene, skybox, disk_params, lut, neural_params):
        row0 = jax.lax.axis_index("sp") * band_h
        return _render_band(
            camera, scene, skybox, disk_params, lut, row0, band_h,
            config=config, use_pallas=use_pallas, tonemap=tonemap, seed=seed,
            texture_filter=texture_filter, neural_params=neural_params,
            neural_precision=neural_precision, multires=multires,
        )

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P()),
        out_specs=P("sp"),
        check_vma=False,
    )
    return jax.jit(fn)


def render_frame_sharded(
    camera,
    scene,
    skybox,
    mesh: Mesh,
    *,
    config: TraceConfig = TraceConfig(),
    disk_params=None,
    lut=None,
    use_pallas: bool | None = None,
    tonemap: str = "passthrough",
    seed: int = 2020,
    texture_filter: str = "bilinear",
    neural_params=None,
    neural_precision: str = "bf16",
    multires: int = 0,
):
    """One frame with pixel rows sharded over the mesh's 'sp' axis.

    Returns the uint8 (H, W, 4) image, sharded over rows (NamedSharding
    P('sp')); jax.device_get assembles it on the host. Heights that do not
    divide over sp are band-padded (each device renders ceil(H/sp) rows;
    the out-of-frame tail rows are sliced off).
    """
    if use_pallas is None:
        use_pallas = kernel_mode(_platform(mesh)) == KERNEL_COMPILED
    n_sp = mesh.shape["sp"]
    height = scene.screen_height
    band_h = -(-height // n_sp)  # ceil: pad the last band past the image
    if multires and (config.integrator == "neural" or tonemap != "passthrough"):
        raise ValueError("sharded multires supports geodesic integrators "
                         "with passthrough tonemap only")
    program = _frame_program(
        mesh, band_h, config, bool(use_pallas), tonemap, seed,
        texture_filter, int(multires), neural_precision,
    )
    packed = program(camera, scene, skybox, disk_params, lut, neural_params)
    return unpack_frame(packed[:height])


def render_animation_sharded(
    times,
    scene,
    skybox,
    mesh: Mesh,
    *,
    orbit=(0.3, 15.0, 5.0),
    config: TraceConfig = TraceConfig(),
    disk_params=None,
    lut=None,
    use_pallas: bool | None = None,
    tonemap: str = "passthrough",
    with_stats: bool = True,
    seed: int = 2020,
    texture_filter: str = "bilinear",
    neural_params=None,
    neural_precision: str = "bf16",
    multires: int = 0,
):
    """Animation with frames sharded over 'dp' and rows over 'sp'.

    `times` is fp32[F] with F divisible by mesh dp size; heights that do
    not divide over sp are band-padded like render_frame_sharded. Each
    device scans its local frames and renders its row band — the full
    (dp x sp) mesh is busy with zero hot-loop communication. When
    `with_stats`, a per-frame mean-luminance telemetry scalar is
    psum-reduced over 'sp' (the collective exercising the mesh) and
    returned alongside the frames; band-padding rows past the real image
    height are masked out of the reduction, so the mean is exact for any
    height.
    """
    if use_pallas is None:
        use_pallas = kernel_mode(_platform(mesh)) == KERNEL_COMPILED
    n_dp = mesh.shape["dp"]
    n_sp = mesh.shape["sp"]
    height = scene.screen_height
    if len(times) % n_dp:
        raise ValueError(f"len(times)={len(times)} must divide over dp={n_dp}")
    band_h = -(-height // n_sp)  # ceil: pad the last band past the image
    if multires and (config.integrator == "neural" or tonemap != "passthrough"):
        raise ValueError("sharded multires supports geodesic integrators "
                         "with passthrough tonemap only")
    program = _animation_program(
        mesh, band_h, tuple(float(x) for x in orbit), config,
        bool(use_pallas), tonemap, with_stats, seed,
        texture_filter, int(multires), neural_precision,
    )
    frames, lums = program(times, scene, skybox, disk_params, lut, neural_params)
    frames = unpack_frame(frames[:, :height])
    if with_stats:
        return frames, lums
    return frames


@functools.lru_cache(maxsize=128)
def _animation_program(
    mesh, band_h, orbit, config, use_pallas, tonemap, with_stats,
    seed, texture_filter, multires, neural_precision,
):
    """Jitted sharded-animation program, cached per static configuration
    (see _frame_program)."""
    n_sp = mesh.shape["sp"]
    speed, radius, cam_h = [jnp.float32(x) for x in orbit]

    def shard_fn(times, scene, skybox, disk_params, lut, neural_params):
        row0 = jax.lax.axis_index("sp") * band_h

        def step(carry, t):
            cam = orbit_camera(t, radius=radius, height=cam_h, rotation_speed=speed)
            band = _render_band(
                cam, scene, skybox, disk_params, lut, row0, band_h,
                config=config, use_pallas=use_pallas, tonemap=tonemap, seed=seed, texture_filter=texture_filter,
                neural_params=neural_params,
                neural_precision=neural_precision, multires=multires,
            )
            if with_stats:
                g_chan = ((band >> 8) & jnp.uint32(0xFF)).astype(jnp.float32)
                # mask band-padding rows past the real image height so the
                # telemetry mean is exact for non-dividing heights
                rows = jax.lax.broadcasted_iota(jnp.int32, band.shape, 0) + row0
                valid = (rows < scene.screen_height).astype(jnp.float32)
                denom = jnp.float32(scene.screen_height * scene.screen_width)
                lum = jax.lax.psum(jnp.sum(g_chan * valid) / denom, "sp")
            else:
                lum = jnp.float32(0.0)
            return carry, (band, lum)

        _, (bands, lums) = jax.lax.scan(step, 0, times)
        return bands, lums

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P("dp"), P(), P(), P(), P(), P()),
        out_specs=(P("dp", "sp"), P("dp")),
        check_vma=False,
    )
    return jax.jit(fn)


def shard_image(image, mesh: Mesh):
    """Place an existing image with rows sharded over 'sp' (utility)."""
    return jax.device_put(image, NamedSharding(mesh, P("sp")))
