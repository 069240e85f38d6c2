"""Camera data model and ray generation.

JAX analog of the reference's `Camera` struct + look-at constructor
(reference: src/lib.rs:15-59) and the per-pixel ray-generation block of the
compute shader (reference: src/ray_tracer_euler.wgsl:183-198).

The wgpu padding fields are an ABI artifact of the uniform-buffer layout and
are intentionally not replicated; a Camera here is a jax pytree of fp32
arrays, usable directly as a jit argument and inside lax.scan over frames.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .math import cross, normalize


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera basis. All fields are fp32[3] arrays.

    Matches the field semantics of reference src/lib.rs:17-26.
    """

    position: jnp.ndarray
    forward: jnp.ndarray
    right: jnp.ndarray
    up: jnp.ndarray

    @classmethod
    def new(cls, position, look_at, up) -> "Camera":
        """Look-at constructor (reference: src/lib.rs:35-59).

        forward = normalize(look_at - position)
        right   = normalize(forward x up)
        up      = normalize(right x forward)
        """
        position = jnp.asarray(position, jnp.float32)
        look_at = jnp.asarray(look_at, jnp.float32)
        up = jnp.asarray(up, jnp.float32)
        forward = normalize(look_at - position)
        right = normalize(cross(forward, up))
        up_ortho = normalize(cross(right, forward))
        return cls(position=position, forward=forward, right=right, up=up_ortho)

    # Alias so both `Camera.new(...)` (reference name) and
    # `Camera.look_at(...)` (idiomatic) work.
    look_at = new

    @classmethod
    def default(cls) -> "Camera":
        """Default library camera (reference: src/lib.rs:354-358)."""
        return cls.new([0.0, 5.0, 15.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])


def generate_rays(
    camera: Camera,
    width: int,
    height: int,
    fov,
    *,
    row_offset=0,
    col_offset=0,
    local_shape: tuple[int, int] | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-pixel primary ray directions for a (height, width) image.

    Mirrors the shader's ray-gen exactly (reference: wgsl:183-198):
      u = (x / W - 0.5) *  2 * aspect     (pixel index, NOT pixel center)
      v = (y / H - 0.5) * -2              (Y flipped)
      dir = normalize(fwd + right*u*tan(fov/2) + up*v*tan(fov/2))

    Returns (origins, directions), each fp32[height, width, 3]. Origins are
    the broadcast camera position. `row_offset`/`col_offset`/`local_shape`
    generate rays for a band of the full image (mesh-sharded rendering):
    UVs always reference the full `width`/`height`.
    """
    fov = jnp.asarray(fov, jnp.float32)
    local_h, local_w = local_shape or (height, width)
    xs = jnp.arange(local_w, dtype=jnp.float32) + jnp.asarray(col_offset, jnp.float32)
    ys = jnp.arange(local_h, dtype=jnp.float32) + jnp.asarray(row_offset, jnp.float32)
    u = (xs / jnp.float32(width) - 0.5) * 2.0
    v = (ys / jnp.float32(height) - 0.5) * -2.0
    aspect = jnp.float32(width) / jnp.float32(height)
    u = u * aspect
    fov_factor = jnp.tan(fov * 0.5)
    uu, vv = jnp.meshgrid(u, v)  # (H, W)
    d = (
        camera.forward[None, None, :]
        + camera.right[None, None, :] * (uu * fov_factor)[..., None]
        + camera.up[None, None, :] * (vv * fov_factor)[..., None]
    )
    d = d / jnp.sqrt(jnp.sum(d * d, axis=-1, keepdims=True))
    origins = jnp.broadcast_to(camera.position, d.shape)
    return origins, d


def orbit_camera(t, radius=15.0, height=5.0, rotation_speed=0.3) -> Camera:
    """Equatorial orbit camera as a pure function of time.

    Mirrors the app's animation loop (reference: src/main.rs:851-869):
    angle = t * 0.3 rad/s, camera at (r*cos, h, r*sin), always looking at the
    origin with +Y up. Being a pure function of `t`, animations are
    deterministic and resumable by frame index.
    """
    t = jnp.asarray(t, jnp.float32)
    angle = t * jnp.float32(rotation_speed)
    pos = jnp.stack(
        [
            jnp.float32(radius) * jnp.cos(angle),
            jnp.broadcast_to(jnp.float32(height), angle.shape),
            jnp.float32(radius) * jnp.sin(angle),
        ],
        axis=-1,
    )
    return Camera.new(pos, jnp.zeros(3, jnp.float32), jnp.array([0.0, 1.0, 0.0], jnp.float32))
