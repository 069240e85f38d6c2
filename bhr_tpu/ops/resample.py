"""Gather-free static-phase plane resampling (shared helpers).

For an integer factor the bilinear sample positions of an upsample fall on
`factor` static phases per axis, so upsampling is shift-and-blend over whole
planes — elementwise work, no per-pixel indexing. Used by the multi-resolution
renderer (ops/multires.py, deflection-field upsample) and the subsampled
texture sampler (ops/sampling.sample_equirect_packed_subsampled).

All helpers are CORNER-aligned: the low grid holds samples of full-
resolution pixels j*factor, so full pixel q*factor + p interpolates low
pixels q and q+1 with weight p/factor — phase 0 is a bit-exact copy of the
low sample.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def shift(plane, s, axis):
    """plane[clip(i + s)] along `axis` (edge clamp) — concat/slice, no gather."""
    if s == 0:
        return plane
    n = plane.shape[axis]
    if s == 1:
        body = jax.lax.slice_in_dim(plane, 1, n, axis=axis)
        last = jax.lax.slice_in_dim(plane, n - 1, n, axis=axis)
        return jax.lax.concatenate([body, last], axis)
    if s == -1:
        first = jax.lax.slice_in_dim(plane, 0, 1, axis=axis)
        body = jax.lax.slice_in_dim(plane, 0, n - 1, axis=axis)
        return jax.lax.concatenate([first, body], axis)
    raise ValueError(s)


def upsample_axis(plane, factor: int, axis: int):
    """Bilinear x`factor` upsample along one axis, static phases, clamped."""
    phases = []
    for p in range(factor):
        frac = jnp.float32(p / factor)
        if p == 0:
            phases.append(plane)
            continue
        hi = shift(plane, 1, axis)
        phases.append(plane * (1.0 - frac) + hi * frac)
    stacked = jnp.stack(phases, axis=axis + 1)
    shape = list(plane.shape)
    shape[axis] *= factor
    return stacked.reshape(shape)


def upsample_bilinear(plane, factor: int, out_shape):
    """(lh, lw) -> bilinear (lh*factor, lw*factor), cropped to out_shape."""
    up = upsample_axis(upsample_axis(plane, factor, 0), factor, 1)
    return up[: out_shape[0], : out_shape[1]]


def _sel_matrix(n_in: int, stride: int, offset: int = 0):
    """One-hot selection matrix (n_out, n_in): out[i] = in[i*stride+offset]."""
    n_out = -(-(n_in - offset) // stride)
    m = jnp.zeros((n_out, n_in), jnp.float32)
    idx = jnp.arange(n_out) * stride + offset
    return m.at[jnp.arange(n_out), idx].set(1.0)


def subsample_mm(plane, stride: int, offset: int = 0):
    """plane[offset::stride, offset::stride] as two one-hot matmuls.

    Selection matmuls are exact (one term per output row, HIGHEST
    precision). Whether they beat a plain strided slice on the GPU is
    unmeasured (ROADMAP A4).
    """
    h, w = plane.shape
    sr = _sel_matrix(h, stride, offset)
    sc = _sel_matrix(w, stride, offset)
    dot = functools.partial(
        jnp.matmul,
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    return dot(sr, dot(plane, sc.T))


def neighbor_max(plane):
    """3x3 neighborhood max (separable, shift-based)."""
    m = jnp.maximum(jnp.maximum(shift(plane, -1, 0), shift(plane, 1, 0)), plane)
    return jnp.maximum(jnp.maximum(shift(m, -1, 1), shift(m, 1, 1)), m)
