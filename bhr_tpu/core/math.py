"""Vector math primitives shared by host- and device-side code.

JAX re-implementation of the reference's vector utilities
(reference: src/lib.rs:119-135) and the shader-side direction->UV mapping
(reference: src/ray_tracer_euler.wgsl:93-98).

Everything here is pure jnp, fp32, and safe to call inside jit / Pallas
kernels (no data-dependent Python control flow).
"""

from __future__ import annotations

import jax.numpy as jnp

TWO_PI = 6.28318530718  # matches 2.0 * 3.14159265359 in wgsl:95
PI = 3.14159265359  # wgsl:96


def normalize(v: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Normalize with a zero-length guard.

    Mirrors the host-side `normalize` (reference: src/lib.rs:119-126), which
    returns the input unchanged when the length is zero.
    """
    v = jnp.asarray(v)
    length = jnp.sqrt(jnp.sum(v * v, axis=axis, keepdims=True))
    return jnp.where(length > 0.0, v / jnp.where(length > 0.0, length, 1.0), v)


def normalize_unguarded(v: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Shader-style normalize: v / |v| with no zero guard.

    Used inside the geodesic hot loop (reference: wgsl:140, 166) where the
    vector is never zero. Uses an IEEE sqrt + divide so CPU-jax, GPU XLA and
    the Pallas kernel agree bit-for-bit on the same inputs.
    """
    length = jnp.sqrt(jnp.sum(v * v, axis=axis, keepdims=True))
    return v / length


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Cross product of 3-vectors (reference: src/lib.rs:129-135)."""
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    return jnp.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        axis=-1,
    )


def dot(a: jnp.ndarray, b: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Elementwise-batched dot product over the last axis."""
    return jnp.sum(a * b, axis=axis)


def direction_to_equirectangular_uv(direction: jnp.ndarray) -> jnp.ndarray:
    """Map a 3D direction to equirectangular UV coordinates.

    Mirrors `direction_to_equirectangular_uv` (reference: wgsl:93-98):
        u = 0.5 + atan2(z, x) / (2*pi)
        v = 0.5 - asin(y) / pi
    The direction is re-normalized first, exactly as the shader does.
    """
    n = normalize_unguarded(direction)
    u = 0.5 + jnp.arctan2(n[..., 2], n[..., 0]) / TWO_PI
    # clip guards asin against |y| marginally > 1 from fp rounding
    v = 0.5 - jnp.arcsin(jnp.clip(n[..., 1], -1.0, 1.0)) / PI
    return jnp.stack([u, v], axis=-1)
