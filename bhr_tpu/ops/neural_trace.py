"""Frame-level neural-surrogate tracing (reference roadmap Phase 5).

Renders the deflection field of a whole frame as batched matmuls
instead of geodesic integration: per-pixel ray-gen (identical to the
integrator paths), reduced-coordinate features, one MLP forward pass over
the (H*W, F) pixel batch, and reconstruction into the standard
TraceResult so the entire shading stack (star field, texture tiers,
tonemap, packed frames) applies unchanged.

Status semantics: the surrogate classifies each ray as captured (black)
or escaped (background along the predicted final direction). The
reference dynamics' third outcome — still integrating at max_steps —
also shades as background (reference: src/ray_tracer_euler.wgsl:170), so
collapsing it into ESCAPED is shading-equivalent. Step counts are not
predicted; debug heatmaps are unsupported on this path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.camera import Camera, generate_rays
from ..models.neural import predict_directions
from ..models.neural_kerr import N_FEATURES_KERR, predict_directions_kerr
from .trace import STATUS_CAPTURED, STATUS_ESCAPED, TraceResult


def neural_trace_image(
    params,
    camera: Camera,
    scene,
    *,
    dtype=jnp.float32,
    precision=None,
    row0=0,
    local_shape=None,
) -> TraceResult:
    """Predict the (H, W) deflection field for one frame.

    `params`: MLP weights (models/neural.py), or the Kerr surrogate's
    (models/neural_kerr.py) — dispatched on the static input-feature
    width (16 Schwarzschild / 22 Kerr; spin then comes from the scene).
    `dtype` selects the matmul operand type and `precision` the product
    precision — together the inference tier, which must match the
    weights' training precision (models/neural.tier_matmul_args). `row0` / `local_shape` render a row band of the
    full image (mesh-sharded rendering, parallel/mesh.py) — UVs always
    reference the full frame.
    """
    h, w = local_shape or (scene.screen_height, scene.screen_width)
    origins, dirs = generate_rays(
        camera, scene.screen_width, scene.screen_height, scene.fov,
        row_offset=row0, local_shape=(h, w),
    )
    # flatten to a (N, 3) batch: one big matmul per layer
    flat_o = origins.reshape(-1, 3)
    flat_d = dirs.reshape(-1, 3)
    if params[0][0].shape[0] == N_FEATURES_KERR:
        vel, captured = predict_directions_kerr(
            params,
            flat_o,
            flat_d,
            scene.black_hole_position,
            scene.schwarzschild_radius,
            scene.spin,
            dtype=dtype,
            precision=precision,
        )
    else:
        vel, captured = predict_directions(
            params,
            flat_o,
            flat_d,
            scene.black_hole_position,
            scene.schwarzschild_radius,
            dtype=dtype,
            precision=precision,
        )
    vel = vel.reshape(h, w, 3)
    captured = captured.reshape(h, w)
    status = jnp.where(
        captured,
        jnp.int32(STATUS_CAPTURED),
        jnp.int32(STATUS_ESCAPED),
    )
    steps = jnp.full((h, w), scene.max_steps, jnp.int32)
    return TraceResult(
        final_pos=origins, final_vel=vel, status=status, steps=steps
    )


# standalone-jit flavor for callers outside a jit scope (e.g. the
# Phase 4-4 deflection cache, which reshades a stored TraceResult)
neural_trace_image_jit = jax.jit(
    neural_trace_image,
    static_argnames=("dtype", "precision", "row0", "local_shape"),
)
