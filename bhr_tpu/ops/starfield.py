"""Analytic procedural star field: gather-free skybox evaluation.

The reference samples a 4K equirectangular EXR texture per ray
(reference: src/ray_tracer_euler.wgsl:101-105). The default skybox here
is evaluated *analytically* instead, with no texture gathers: a
deterministic hash-based star field computed per pixel with elementwise
arithmetic in the fused shading epilogue. Zero memory traffic, infinite
resolution, bit-identical between the XLA oracle and Pallas paths (both
call this same jnp function outside the kernel).

User-provided textures (EXR/PNG) still use the bilinear gather path in
ops/sampling.py, matching the reference sampler semantics.

Visual recipe mirrors io/skybox.py's texture generator: power-law star
brightness, blue-white..orange temperature tint, a soft sinusoidal
galactic band, and the Reinhard x/(1+x) tone map the reference applies to
its EXR (src/lib.rs:294-303).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

TWO_PI = 6.28318530718
PI = 3.14159265359

# star lattice resolution (cells over the full equirect domain)
GRID_W = 512
GRID_H = 256


def _hash(x):
    """lowbias32-style integer hash on uint32 planes (elementwise)."""
    x = x.astype(jnp.uint32)
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _unit(h):
    """uint32 -> fp32 in [0, 1).

    Goes through the top 24 bits as int32: 24 bits is exactly
    representable in fp32.
    """
    return (h >> 8).astype(jnp.int32).astype(jnp.float32) * jnp.float32(
        1.0 / 16777216.0
    )


def procedural_background(dx, dy, dz, seed: int = 2020):
    """Default star field: cube-face hash lattice, transcendental-free.

    dx/dy/dz are fp32 (...,) direction components (not necessarily unit);
    returns (r, g, b) planes in [0, 1]. Built from rsqrt, floor, an int
    hash and selects — no atan2/asin/sin — so it stays cheap in the fused
    XLA shading epilogue. Star cells live on cube faces (near-uniform solid-angle
    density — better than equirect cells, which cluster at the poles).
    """
    n_inv = jax.lax.rsqrt(dx * dx + dy * dy + dz * dz)
    nx, ny, nz = dx * n_inv, dy * n_inv, dz * n_inv
    ax, ay, az = jnp.abs(nx), jnp.abs(ny), jnp.abs(nz)

    # dominant-axis cube projection: face id in 0..5, in-face coords s,t
    x_major = (ax >= ay) & (ax >= az)
    y_major = (~x_major) & (ay >= az)
    z_major = ~(x_major | y_major)
    maj = jnp.where(x_major, ax, jnp.where(y_major, ay, az))
    inv_maj = 1.0 / maj
    s = jnp.where(x_major, ny, jnp.where(y_major, nz, nx)) * inv_maj
    t = jnp.where(x_major, nz, jnp.where(y_major, nx, ny)) * inv_maj
    axis = jnp.where(x_major, 0, jnp.where(y_major, 1, 2)).astype(jnp.int32)
    sign_bit = (
        jnp.where(x_major, nx, jnp.where(y_major, ny, nz)) < 0.0
    ).astype(jnp.int32)
    face = axis * 2 + sign_bit  # 0..5

    grid = 96  # cells per face edge
    fs = (s + 1.0) * (0.5 * grid)
    ft = (t + 1.0) * (0.5 * grid)
    cs0 = jnp.floor(fs).astype(jnp.int32)
    ct0 = jnp.floor(ft).astype(jnp.int32)

    r = jnp.zeros_like(fs)
    g = jnp.zeros_like(fs)
    b = jnp.zeros_like(fs)
    for dds in (-1, 0, 1):
        for ddt in (-1, 0, 1):
            cs = jnp.clip(cs0 + dds, 0, grid - 1)
            ct = jnp.clip(ct0 + ddt, 0, grid - 1)
            h = _hash(
                (face * grid * grid + cs * grid + ct).astype(jnp.uint32)
                + jnp.uint32(seed * 2654435761 & 0xFFFFFFFF)
            )
            h2 = _hash(h)
            h3 = _hash(h2)
            h4 = _hash(h3)
            su = (cs0 + dds).astype(jnp.float32) + _unit(h)
            sv = (ct0 + ddt).astype(jnp.float32) + _unit(h2)
            du = fs - su
            dv = ft - sv
            d2 = du * du + dv * dv
            tt_ = _unit(h3)
            t2 = tt_ * tt_
            t4 = t2 * t2
            bright = t4 * t4 * 2.5 + 0.04
            fall = jnp.maximum(0.0, 1.0 - d2 * 18.0)
            glow = fall * fall
            amp = bright * glow * glow
            temp = _unit(h4)
            r = r + amp * (0.75 + 0.25 * temp)
            # parabola 4t(1-t) stands in for sin(pi t) (no trig in-kernel)
            g = g + amp * (0.80 + 0.15 * (4.0 * temp * (1.0 - temp)))
            b = b + amp * (1.00 - 0.45 * temp)

    # galactic band around the equator; azimuthal wobble via
    # sin(2*az) = 2*nx*nz/(nx^2+nz^2) — no trig
    h2d = nx * nx + nz * nz
    wobble = 2.0 * nx * nz / jnp.maximum(h2d, 1e-6)
    tband = (ny - 0.12 * wobble) * (1.0 / 0.11)
    band = 1.0 / (1.0 + tband * tband)
    band = band * band
    r = r + band * 0.035
    g = g + band * 0.033
    b = b + band * 0.045

    r = r / (1.0 + r)
    g = g / (1.0 + g)
    b = b / (1.0 + b)
    return r, g, b


def procedural_background_equirect(dx, dy, dz, seed: int = 2020):
    """Equirectangular-lattice star field (the original formulation; uses
    atan2/asin).

    dx/dy/dz are fp32 (...,) direction components (not necessarily unit).
    """
    inv = jax.lax.rsqrt(dx * dx + dy * dy + dz * dz)
    u = 0.5 + jnp.arctan2(dz, dx) / TWO_PI
    v = 0.5 - jnp.arcsin(jnp.clip(dy * inv, -1.0, 1.0)) / PI

    uu = u * GRID_W
    vv = jnp.clip(v, 0.0, 1.0 - 1e-6) * GRID_H
    cx0 = jnp.floor(uu).astype(jnp.int32)
    cy0 = jnp.floor(vv).astype(jnp.int32)

    r = jnp.zeros_like(u)
    g = jnp.zeros_like(u)
    b = jnp.zeros_like(u)
    # 3x3 neighborhood so stars straddling cell borders render whole
    for ddy in (-1, 0, 1):
        for ddx in (-1, 0, 1):
            cx = jnp.mod(cx0 + ddx, GRID_W)  # wrap in U (seam-safe)
            cy = jnp.clip(cy0 + ddy, 0, GRID_H - 1)
            h = _hash(
                cx.astype(jnp.uint32)
                + cy.astype(jnp.uint32) * jnp.uint32(GRID_W)
                + jnp.uint32(seed * 2654435761 & 0xFFFFFFFF)
            )
            h2 = _hash(h)
            h3 = _hash(h2)
            h4 = _hash(h3)
            # star sub-cell position
            su = (cx0 + ddx).astype(jnp.float32) + _unit(h)
            sv = (cy0 + ddy).astype(jnp.float32) + _unit(h2)
            du = uu - su
            dv = vv - sv
            d2 = du * du + dv * dv
            # power-law brightness: u^8 tail, most stars dim, few bright
            t = _unit(h3)
            t2 = t * t
            t4 = t2 * t2
            bright = t4 * t4 * 2.5 + 0.04
            # compact quartic falloff, star core radius ~0.12 cell
            fall = jnp.maximum(0.0, 1.0 - d2 * 18.0)
            glow = fall * fall
            amp = bright * glow * glow
            # temperature tint (same ramp as io/skybox.py)
            temp = _unit(h4)
            r = r + amp * (0.75 + 0.25 * temp)
            g = g + amp * (0.80 + 0.15 * jnp.sin(PI * temp))
            b = b + amp * (1.00 - 0.45 * temp)

    # galactic band (matches io/skybox.py band shape, rational falloff)
    band_center = 0.5 + 0.12 * jnp.sin(TWO_PI * u + 0.7)
    tband = (v - band_center) * (1.0 / 0.075)
    band = 1.0 / (1.0 + tband * tband)
    band = band * band
    r = r + band * 0.035
    g = g + band * 0.033
    b = b + band * 0.045

    # Reinhard x/(1+x), like the EXR ingest (lib.rs:294-303)
    r = r / (1.0 + r)
    g = g / (1.0 + g)
    b = b / (1.0 + b)
    return r, g, b
