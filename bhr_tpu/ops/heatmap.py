"""Step-count heatmap for the debug visualization mode.

Reproduces `steps_to_color` (reference: src/ray_tracer_euler.wgsl:114-135):
blue -> cyan -> green -> yellow -> red over t = steps / max_steps, in four
linear segments. Written branch-free (nested selects become vectorized
wheres) — the vectorized form of the shader's if/else chain.
"""

from __future__ import annotations

import jax.numpy as jnp

_BLUE = jnp.array([0.0, 0.0, 1.0], jnp.float32)
_CYAN = jnp.array([0.0, 1.0, 1.0], jnp.float32)
_GREEN = jnp.array([0.0, 1.0, 0.0], jnp.float32)
_YELLOW = jnp.array([1.0, 1.0, 0.0], jnp.float32)
_RED = jnp.array([1.0, 0.0, 0.0], jnp.float32)


def _mix(a, b, t):
    return a + (b - a) * t[..., None]


def steps_to_color(steps: jnp.ndarray, max_steps: int) -> jnp.ndarray:
    """steps int (...,) -> fp32 (..., 3) heatmap color."""
    t = steps.astype(jnp.float32) / jnp.float32(max_steps)
    c0 = _mix(_BLUE, _CYAN, t * 4.0)
    c1 = _mix(_CYAN, _GREEN, (t - 0.25) * 4.0)
    c2 = _mix(_GREEN, _YELLOW, (t - 0.5) * 4.0)
    c3 = _mix(_YELLOW, _RED, (t - 0.75) * 4.0)
    out = jnp.where((t < 0.25)[..., None], c0, c1)
    out = jnp.where((t < 0.5)[..., None], out, c2)
    out = jnp.where((t < 0.75)[..., None], out, c3)
    return out
