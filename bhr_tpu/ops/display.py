"""Display stage: the analog of the reference's fullscreen display pass.

The reference's display.wgsl is a pass-through fullscreen-quad sample of the
compute output into the swapchain (reference: src/display.wgsl:12-29); its
CLAUDE.md positions it as the future tonemap slot. Here the "display pass"
is a composable tonemap function applied between shading and quantization —
XLA fuses it into the render epilogue, the idiomatic replacement for a
second GPU pass.

`Vertex`/`QUAD_VERTICES` are provided for API parity with the reference
library exports (reference: src/lib.rs:79-112); headless rendering has no vertex
stage, so they are plain data.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class Vertex:
    """Fullscreen-quad vertex (reference: src/lib.rs:79-96). Data-only."""

    position: tuple[float, float]


# Triangle-strip fullscreen quad (reference: src/lib.rs:99-112).
QUAD_VERTICES = (
    Vertex((-1.0, -1.0)),
    Vertex((1.0, -1.0)),
    Vertex((-1.0, 1.0)),
    Vertex((1.0, 1.0)),
)


def passthrough(color: jnp.ndarray) -> jnp.ndarray:
    """Identity display transform (reference display.wgsl behavior)."""
    return color


def reinhard(color: jnp.ndarray) -> jnp.ndarray:
    """Reinhard x/(1+x) — same operator the EXR loader applies (lib.rs:295)."""
    return color / (1.0 + color)


def srgb_encode(color: jnp.ndarray) -> jnp.ndarray:
    """Linear -> sRGB transfer function (the app's surface preferred an sRGB
    format, reference: src/main.rs:346-351)."""
    c = jnp.clip(color, 0.0, 1.0)
    return jnp.where(c <= 0.0031308, 12.92 * c, 1.055 * jnp.power(c, 1.0 / 2.4) - 0.055)


TONEMAPS = {
    "passthrough": passthrough,
    "reinhard": reinhard,
    "srgb": srgb_encode,
}
