"""Shading stage: turn integration results into colors.

Implements the termination shading of `trace_ray`/`main` (reference:
src/ray_tracer_euler.wgsl:154-170, 203-211): escaped and step-exhausted rays
sample the skybox with their final velocity, captured rays are black, and
debug mode 1 replaces everything with the step-count heatmap. Disk hits
(roadmap feature) shade with the relativistic thin-disk emission model.

Runs as plain XLA after the geodesic kernel so the skybox gather and the
disk LUT lookup fuse with quantization into one memory-bound epilogue.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.scene import DEBUG_STEPS
from ..models import disk as disk_model
from .heatmap import steps_to_color
from .sampling import quantize_rgba8, sample_equirect
from .trace import STATUS_CAPTURED, STATUS_DISK, TraceResult


def shade(
    result: TraceResult,
    skybox: jnp.ndarray,
    max_steps: int,
    debug_mode: int = 0,
    bh_pos=None,
    rs=None,
    camera_position=None,
    disk_params: disk_model.DiskParams | None = None,
    blackbody_lut: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """TraceResult -> fp32 (..., 3) linear color."""
    if debug_mode == DEBUG_STEPS:
        return steps_to_color(result.steps, max_steps)

    background = sample_equirect(skybox, result.final_vel)[..., :3]
    color = jnp.where(
        (result.status == STATUS_CAPTURED)[..., None],
        jnp.zeros((), jnp.float32),
        background,
    )
    if disk_params is not None:
        hit_rel = result.final_pos - bh_pos
        observer_r = jnp.sqrt(jnp.sum((camera_position - bh_pos) ** 2, axis=-1))
        emission = disk_model.disk_emission(
            hit_rel, result.final_vel, observer_r, rs, disk_params, blackbody_lut
        )
        color = jnp.where((result.status == STATUS_DISK)[..., None], emission, color)
    return color


def shade_to_rgba8(*args, tonemap=None, **kwargs) -> jnp.ndarray:
    """shade() then optional tonemap then rgba8unorm quantization (wgsl:213-214)."""
    color = shade(*args, **kwargs)
    if tonemap is not None:
        color = tonemap(color)
    return quantize_rgba8(color)


def shade_planes_packed(
    result: TraceResult,
    background,
    max_steps: int,
    debug_mode: int = 0,
    bh_pos=None,
    rs=None,
    camera_position=None,
    disk_params=None,
    blackbody_lut=None,
    tonemap=None,
) -> jnp.ndarray:
    """Planar shading epilogue -> packed uint32 RGBA frame.

    The production variant of shade(): every intermediate is a well-tiled
    (H, W) component plane (no 3-wide minor dimensions), and the output is
    one packed u32 plane (see sampling.pack_rgba8_planes). `background` is
    a callable (dx, dy, dz) -> (r, g, b) planes — either the analytic star
    field (ops/starfield.py) or a packed-texture sampler closure
    (sampling.sample_equirect_packed).
    """
    from ..core.scene import DEBUG_STEPS
    from .sampling import pack_rgba8_planes

    if debug_mode == DEBUG_STEPS:
        rgb = steps_to_color(result.steps, max_steps)
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        return pack_rgba8_planes(r, g, b)

    vx = result.final_vel[..., 0]
    vy = result.final_vel[..., 1]
    vz = result.final_vel[..., 2]
    r, g, b = background(vx, vy, vz)
    captured = result.status == STATUS_CAPTURED
    zero = jnp.zeros((), jnp.float32)
    r = jnp.where(captured, zero, r)
    g = jnp.where(captured, zero, g)
    b = jnp.where(captured, zero, b)
    if disk_params is not None:
        hit_rel = result.final_pos - bh_pos
        observer_r = jnp.sqrt(jnp.sum((camera_position - bh_pos) ** 2, axis=-1))
        emission = disk_model.disk_emission(
            hit_rel, result.final_vel, observer_r, rs, disk_params, blackbody_lut
        )
        is_disk = result.status == STATUS_DISK
        r = jnp.where(is_disk, emission[..., 0], r)
        g = jnp.where(is_disk, emission[..., 1], g)
        b = jnp.where(is_disk, emission[..., 2], b)
    if tonemap is not None:
        r, g, b = tonemap(r), tonemap(g), tonemap(b)
    return pack_rgba8_planes(r, g, b)
