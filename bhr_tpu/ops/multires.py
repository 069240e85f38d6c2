"""Multi-resolution rendering: the reference roadmap's Phase 4-1.

SpaceEngine-style two-pass scheme (reference: docs/ROADMAP.md:826-946):
geodesics are integrated at 1/divisor resolution, the resulting DEFLECTION
field (final ray directions) is interpolated to full resolution, and
shading runs at full resolution on the interpolated directions — so the
star field / texture stays pixel-sharp while the expensive integration
runs on divisor^2 x fewer rays. Shadow-edge pixels, where interpolating
the deflection field is invalid (it blends captured and escaped rays),
are detected and re-integrated at full resolution.

Design choices (vs the reference's fragment-shader warp):

  * The deflection upsample is GATHER-FREE: for an integer divisor the
    bilinear sample positions fall on `divisor` static phases per axis
    (x_low = (j + 0.5)/d - 0.5), so upsampling is shift-and-blend on
    whole planes — elementwise work XLA fuses, no per-pixel indexing
    (ops/resample.py).
  * Edge re-integration is a MASKED full-resolution kernel pass
    (pallas_trace_image(mask=...)): masked-off rays start finished, and a
    block whose rays are all masked never enters its integration loop —
    blocks of rays, not pixels, are the skip granularity, so the pass
    costs roughly (edge block fraction) x (full render).
  * Everything is static-shaped and jit-compatible: one compiled program
    per (scene shape, divisor), usable inside the fused lax.scan
    animation path.

This is an APPROXIMATION mode (the reference targets SSIM > 0.95, not
parity): non-edge pixels shade with interpolated directions. Accuracy is
bounded by the smoothness of the deflection field away from the photon
ring; tests/test_multires.py pins the flat-space exactness, the edge
detector, and the full-pipeline error budget.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .pallas_trace import pallas_trace_image
from .resample import neighbor_max as _neighbor_max
from .resample import shift as _shift
from .resample import upsample_bilinear
from .shading import shade_planes_packed
from .starfield import procedural_background
from .trace import TraceConfig, TraceResult
from .sampling import sample_equirect_packed, unpack_frame


def deflection_edges(vel_planes, status, threshold: float):
    """Low-res mask of pixels whose deflection field cannot be interpolated.

    A pixel is an edge when any 4-neighbor differs in termination status
    (shadow boundary: captured vels are frozen garbage for shading) or in
    deflection by more than `threshold` (photon-ring whirl, where the
    field's curvature outruns bilinear accuracy). Dilated by one pixel so
    the full-res bilinear support of every flagged sample is covered.
    """
    st = status.astype(jnp.float32)
    diff = jnp.zeros_like(st)
    for axis in (0, 1):
        for s in (-1, 1):
            d = jnp.zeros_like(st)
            for v in vel_planes:
                d = jnp.maximum(d, jnp.abs(_shift(v, s, axis) - v))
            d = jnp.maximum(d, jnp.abs(_shift(st, s, axis) - st) * 1e6)
            diff = jnp.maximum(diff, d)
    edge = (diff > threshold).astype(jnp.float32)
    return _neighbor_max(edge)  # dilate 1


def _shade_multires(
    result,
    camera,
    scene,
    skybox,
    disk_params,
    config,
    *,
    texture_filter,
    texture_subsample,
    seed,
    packed,
):
    """Shared shading epilogue on interpolated/fixed deflection planes."""
    vx = result.final_vel[..., 0]
    vy = result.final_vel[..., 1]
    vz = result.final_vel[..., 2]
    status = result.status
    if skybox is None:
        background = functools.partial(procedural_background, seed=seed)
    elif texture_filter == "luma":
        from .sampling import sample_equirect_packed_luma

        chroma_sub = (
            texture_subsample
            if isinstance(texture_subsample, int) and texture_subsample > 1
            else 2
        )
        sub_rgb = sample_equirect_packed_luma(
            skybox, vx, vy, vz, status, chroma_sub=chroma_sub
        )
        background = lambda *_: sub_rgb
    elif texture_subsample != 1:
        # gather-count attack composed with multires: texture color on a
        # subset of the (already interpolated) full-res directions
        from .sampling import (
            sample_equirect_packed_checkerboard,
            sample_equirect_packed_subsampled,
        )

        if texture_subsample == "checker":
            sub_rgb = sample_equirect_packed_checkerboard(
                skybox, vx, vy, vz, status, filter=texture_filter
            )
        else:
            sub_rgb = sample_equirect_packed_subsampled(
                skybox, vx, vy, vz, status, texture_subsample,
                filter=texture_filter,
            )
        background = lambda *_: sub_rgb
    else:
        background = functools.partial(
            sample_equirect_packed, skybox, filter=texture_filter
        )
    # the multires epilogue stays gather-free: the blackbody LUT evaluates
    # as a clamp-sum select chain (models/disk.py temperature_to_color_select)
    frame = shade_planes_packed(
        result,
        background,
        scene.max_steps,
        bh_pos=scene.black_hole_position,
        rs=scene.schwarzschild_radius,
        camera_position=camera.position,
        disk_params=disk_params,
        blackbody_lut="select" if config.disk else None,
    )
    return frame if packed else unpack_frame(frame)


@functools.partial(
    jax.jit,
    static_argnames=(
        "config", "divisor", "texture_filter", "texture_subsample", "seed",
        "edge_fix", "edge_threshold", "packed",
    ),
)
def render_multires(
    camera,
    scene,
    skybox=None,
    disk_params=None,
    blackbody_lut=None,
    *,
    config: TraceConfig = TraceConfig(),
    divisor: int = 3,
    texture_filter: str = "bilinear",
    texture_subsample: int = 1,
    seed: int = 2020,
    edge_fix: bool = True,
    edge_threshold: float = 0.05,
    packed: bool = False,
):
    """Render one frame with 1/divisor-resolution geodesics (+ edge fix-up).

    Returns uint8 (H, W, 4), or the packed u32 (H, W) frame when
    `packed=True`.

    Disk configs (round 3): the low pass runs with the disk enabled, the
    hit-POSITION planes are bilinearly upsampled alongside the deflection
    field (the hit field is smooth inside the disk annulus; every
    mixed-status support lands in the edge mask and is re-traced at full
    resolution), and shading evaluates the exact emission model per full-res
    pixel on the interpolated hit state. Pass `disk_params`/`blackbody_lut`
    (models/disk.py) with a `config.disk` TraceConfig. Debug (heatmap)
    modes need true per-pixel step counts and stay unsupported.
    """
    if config.disk and disk_params is None:
        raise ValueError("config.disk needs disk_params + blackbody_lut")
    if scene.debug_mode != 0:
        raise ValueError("multires does not support debug modes")
    height, width = scene.screen_height, scene.screen_width
    lh = -(-height // divisor)
    lw = -(-width // divisor)
    # the STRIDED low pass traces every divisor-th pixel of the FULL image
    # (same scene dims in ray-gen), so low pixel (i, j) is exactly full
    # pixel (i*divisor, j*divisor) for any width/height — no resampling
    # convention mismatch and no aspect drift for non-dividing sizes
    low = pallas_trace_image(
        camera, scene, config, local_shape=(lh, lw), stride=divisor
    )
    lvx = low.final_vel[..., 0]
    lvy = low.final_vel[..., 1]
    lvz = low.final_vel[..., 2]
    out_shape = (height, width)
    vx = upsample_bilinear(lvx, divisor, out_shape)
    vy = upsample_bilinear(lvy, divisor, out_shape)
    vz = upsample_bilinear(lvz, divisor, out_shape)
    if config.disk:
        # hit-position planes for the disk emission model; smooth wherever
        # the 2x2 support shares a status (mixed supports are edge-fixed)
        pos_up = [
            upsample_bilinear(low.final_pos[..., k], divisor, out_shape)
            for k in range(3)
        ]
    status_up = jnp.repeat(
        jnp.repeat(low.status, divisor, axis=0), divisor, axis=1
    )[: height, : width]

    if edge_fix:
        edge_low = deflection_edges((lvx, lvy, lvz), low.status, edge_threshold)
        edge = jnp.repeat(
            jnp.repeat(edge_low, divisor, axis=0), divisor, axis=1
        )[: height, : width]
        fix = pallas_trace_image(camera, scene, config, mask=edge)
        em = edge > 0.0
        vx = jnp.where(em, fix.final_vel[..., 0], vx)
        vy = jnp.where(em, fix.final_vel[..., 1], vy)
        vz = jnp.where(em, fix.final_vel[..., 2], vz)
        status = jnp.where(em, fix.status, status_up)
        if config.disk:
            pos_up = [
                jnp.where(em, fix.final_pos[..., k], pos_up[k])
                for k in range(3)
            ]
    else:
        status = status_up

    result = TraceResult(
        final_pos=(
            jnp.stack(pos_up, axis=-1)
            if config.disk
            else jnp.zeros((height, width, 3), jnp.float32)
        ),
        final_vel=jnp.stack([vx, vy, vz], axis=-1),
        status=status,
        steps=jnp.zeros((height, width), jnp.int32),
    )
    del blackbody_lut  # gather-free epilogue (see _shade_multires)
    return _shade_multires(
        result, camera, scene, skybox, disk_params, config,
        texture_filter=texture_filter, texture_subsample=texture_subsample,
        seed=seed, packed=packed,
    )


def render_multires_band(
    camera,
    scene,
    skybox=None,
    disk_params=None,
    *,
    row0,
    band_h: int,
    config: TraceConfig = TraceConfig(),
    divisor: int = 3,
    texture_filter: str = "bilinear",
    texture_subsample: int = 1,
    seed: int = 2020,
    edge_fix: bool = True,
    edge_threshold: float = 0.05,
):
    """Rows [row0, row0+band_h) of a multires frame -> packed u32 (band_h, W).

    The mesh-sharded form of render_multires (parallel/mesh.py band-shards
    frames over the 'sp' axis); `row0` may be a traced value
    (lax.axis_index * band_h). Pixel-identical to the single-device
    render_multires by construction:

      * the strided low pass traces this band's low rows plus a 2-row halo
        (the edge mask at a low row depends on rows +-2 through the
        shift-diff + dilation), and in-kernel ray-gen makes low row g of
        any band bit-identical to low row g of the full-frame pass;
      * halo rows outside the image's low grid are replaced by
        edge-clamped copies, reproducing resample.shift's border clamping
        and deflection_edges' border behavior exactly;
      * the corner-aligned upsample phases are shift-invariant under the
        divisor-aligned band origin, and the masked fix-up re-traces the
        same full-res pixels the full-frame pass would.

    tests/test_parallel.py asserts sharded == single equality. Chroma /
    texture-subsample grids anchor at the band's first row (the same
    documented band-phase caveat as the sharded luma tier).
    """
    if config.disk and disk_params is None:
        raise ValueError("config.disk needs disk_params")
    if scene.debug_mode != 0:
        raise ValueError("multires does not support debug modes")
    height, width = scene.screen_height, scene.screen_width
    d = int(divisor)
    lh_full = -(-height // d)
    lw = -(-width // d)
    halo = 2
    # the band's low-row span is <= ceil(band_h/d) + 2 (non-aligned row0
    # adds one partial row at each end), plus the halo
    n_low = -(-band_h // d) + 2 + 2 * halo
    row0 = jnp.asarray(row0, jnp.int32)
    q0 = row0 // d  # first low row whose full row intersects the band
    low0 = q0 - halo
    low = pallas_trace_image(
        camera, scene, config, local_shape=(n_low, lw), stride=d,
        row0=low0 * d,
    )
    # clamp out-of-image low rows to the image's border rows (see docstring)
    src = jnp.clip(low0 + jnp.arange(n_low, dtype=jnp.int32), 0, lh_full - 1) - low0

    def _cl(plane):
        return jnp.take(plane, src, axis=0)

    lvx = _cl(low.final_vel[..., 0])
    lvy = _cl(low.final_vel[..., 1])
    lvz = _cl(low.final_vel[..., 2])
    lstatus = _cl(low.status)
    up_shape = (n_low * d, width)
    off = row0 - low0 * d  # band offset into the upsampled halo block

    def _band(plane):
        return jax.lax.dynamic_slice_in_dim(plane, off, band_h, 0)

    vx = _band(upsample_bilinear(lvx, d, up_shape))
    vy = _band(upsample_bilinear(lvy, d, up_shape))
    vz = _band(upsample_bilinear(lvz, d, up_shape))
    if config.disk:
        pos_up = [
            _band(upsample_bilinear(_cl(low.final_pos[..., k]), d, up_shape))
            for k in range(3)
        ]
    status_up = _band(
        jnp.repeat(jnp.repeat(lstatus, d, axis=0), d, axis=1)[:, :width]
    )

    if edge_fix:
        edge_low = deflection_edges((lvx, lvy, lvz), lstatus, edge_threshold)
        edge = _band(
            jnp.repeat(jnp.repeat(edge_low, d, axis=0), d, axis=1)[:, :width]
        )
        fix = pallas_trace_image(
            camera, scene, config, mask=edge, row0=row0,
            local_shape=(band_h, width),
        )
        em = edge > 0.0
        vx = jnp.where(em, fix.final_vel[..., 0], vx)
        vy = jnp.where(em, fix.final_vel[..., 1], vy)
        vz = jnp.where(em, fix.final_vel[..., 2], vz)
        status = jnp.where(em, fix.status, status_up)
        if config.disk:
            pos_up = [
                jnp.where(em, fix.final_pos[..., k], pos_up[k])
                for k in range(3)
            ]
    else:
        status = status_up

    result = TraceResult(
        final_pos=(
            jnp.stack(pos_up, axis=-1)
            if config.disk
            else jnp.zeros((band_h, width, 3), jnp.float32)
        ),
        final_vel=jnp.stack([vx, vy, vz], axis=-1),
        status=status,
        steps=jnp.zeros((band_h, width), jnp.int32),
    )
    return _shade_multires(
        result, camera, scene, skybox, disk_params, config,
        texture_filter=texture_filter, texture_subsample=texture_subsample,
        seed=seed, packed=True,
    )
