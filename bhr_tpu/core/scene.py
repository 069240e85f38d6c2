"""Scene parameter data model.

JAX analog of the reference's `SceneParams` uniform struct
(reference: src/lib.rs:63-75, src/ray_tracer_euler.wgsl:15-25). The wgpu
16-byte-alignment padding fields are ABI artifacts and are not replicated.

Design note: continuously varying physical quantities (black-hole position,
Schwarzschild radius, fov, Kerr spin) are pytree *data* so they can change
per-frame inside a jitted lax.scan without retracing. Quantities that change
the compiled program shape (image size, max_steps, debug mode, integrator)
are *static* metadata — changing them triggers one recompile, exactly like
swapping the WGSL shader did in the reference (src/main.rs:30 --shader).
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

# Workload-defining constants of the reference integrator
# (reference: wgsl:142 dt, wgsl:154 escape radius, wgsl:62 capture factor).
DEFAULT_DT = 0.1
ESCAPE_RADIUS = 100.0
CAPTURE_FACTOR = 1.05

# Debug modes (reference: wgsl:23, 204-211).
DEBUG_NONE = 0
DEBUG_STEPS = 1


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SceneParams:
    """Scene configuration.

    Defaults mirror the reference library defaults
    (reference: src/lib.rs:360-370): r_s = 2.0, fov = pi/3, max_steps = 500.
    """

    # --- dynamic (pytree data): can vary per frame under one jit trace ---
    black_hole_position: jnp.ndarray = dataclasses.field(
        default_factory=lambda: jnp.zeros(3, jnp.float32)
    )
    schwarzschild_radius: jnp.ndarray = dataclasses.field(
        default_factory=lambda: jnp.float32(2.0)
    )
    fov: jnp.ndarray = dataclasses.field(
        default_factory=lambda: jnp.float32(math.pi / 3.0)
    )
    # Kerr spin parameter a/M in [0, 1); 0.0 == Schwarzschild.
    spin: jnp.ndarray = dataclasses.field(default_factory=lambda: jnp.float32(0.0))

    # --- static metadata: part of the compiled program ---
    screen_width: int = dataclasses.field(default=800, metadata=dict(static=True))
    screen_height: int = dataclasses.field(default=600, metadata=dict(static=True))
    max_steps: int = dataclasses.field(default=500, metadata=dict(static=True))
    debug_mode: int = dataclasses.field(default=DEBUG_NONE, metadata=dict(static=True))

    def replace(self, **kw) -> "SceneParams":
        return dataclasses.replace(self, **kw)

    @property
    def width(self) -> int:
        return self.screen_width

    @property
    def height(self) -> int:
        return self.screen_height


def _split_fields():
    data, meta = [], []
    for f in dataclasses.fields(SceneParams):
        (meta if f.metadata.get("static") else data).append(f.name)
    return data, meta


# register_dataclass above used field metadata implicitly only in newer JAX;
# re-register explicitly to be version-robust.
_DATA_FIELDS, _META_FIELDS = _split_fields()
try:  # pragma: no cover - depends on jax version behavior
    jax.tree_util.register_dataclass(
        SceneParams, data_fields=_DATA_FIELDS, meta_fields=_META_FIELDS
    )
except ValueError:
    # already registered with identical layout
    pass
