"""Equirectangular skybox sampling and RGBA8 quantization.

Reproduces the wgpu sampler semantics the reference binds for the skybox
(reference: src/lib.rs:414-421): bilinear filtering, address mode Repeat in
U (the panorama wraps at the seam) and ClampToEdge in V, on an Rgba8Unorm
texture (so texels are k/255 values). Texel centers sit at (i + 0.5) / N,
matching GPU normalized texture coordinates.

The gather runs as a fused XLA op *outside* the Pallas geodesic kernel:
rays only need the skybox at termination, so sampling escape directions in
XLA keeps the hot kernel free of HBM gathers (SURVEY.md section 7, hard
parts).
"""

from __future__ import annotations

import math
import os

import jax
import jax.numpy as jnp

from ..core.math import direction_to_equirectangular_uv


def sample_equirect(texture: jnp.ndarray, directions: jnp.ndarray) -> jnp.ndarray:
    """Bilinear equirectangular sample.

    texture: fp32 (H, W, C) with values in [0, 1] (quantized to k/255 by the
    loader, emulating Rgba8Unorm storage). directions: fp32 (..., 3).
    Returns fp32 (..., C).
    """
    uv = direction_to_equirectangular_uv(directions)
    return sample_bilinear(texture, uv[..., 0], uv[..., 1])


def sample_bilinear(texture: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Bilinear texture sample with Repeat-U / Clamp-V addressing."""
    h, w = texture.shape[0], texture.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    x0 = jnp.mod(x0f.astype(jnp.int32), w)  # Repeat in U (lib.rs:415)
    x1 = jnp.mod(x0 + 1, w)
    y0 = jnp.clip(y0f.astype(jnp.int32), 0, h - 1)  # ClampToEdge in V (lib.rs:416)
    y1 = jnp.clip(y0f.astype(jnp.int32) + 1, 0, h - 1)
    t00 = texture[y0, x0]
    t10 = texture[y0, x1]
    t01 = texture[y1, x0]
    t11 = texture[y1, x1]
    top = t00 * (1.0 - fx) + t10 * fx
    bot = t01 * (1.0 - fx) + t11 * fx
    return top * (1.0 - fy) + bot * fy


def pack_texture_rgba8(texture) -> jnp.ndarray:
    """fp32 (H, W, C) k/255 texture -> packed uint32 (H, W) RGBA plane.

    Packing all four channels into one u32 word cuts a bilinear sample
    from 12-16 gathers to 4 (one per corner), with cheap shift/mask
    unpacks.
    """
    t = jnp.asarray(texture)
    q = jnp.round(jnp.clip(t, 0.0, 1.0) * 255.0).astype(jnp.uint32)
    a = q[..., 3] if t.shape[-1] > 3 else jnp.full(t.shape[:-1], 255, jnp.uint32)
    return q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | (a << 24)


def _unpack_rgb(word):
    s = jnp.float32(1.0 / 255.0)
    r = (word & jnp.uint32(0xFF)).astype(jnp.float32) * s
    g = ((word >> 8) & jnp.uint32(0xFF)).astype(jnp.float32) * s
    b = ((word >> 16) & jnp.uint32(0xFF)).astype(jnp.float32) * s
    return r, g, b



def _corner_layout(tex) -> str | None:
    """Identify a corner-packed exact-bilinear table by shape.

    "rows"   — interleaved (H+1, W, 3) (corner_pack_texture_rows);
    "planes" — planar (3, H+1, W) (corner_pack_texture);
    None     — plain packed (H, W).
    (A 3-texel-wide planar table would be ambiguous; equirect textures are
    never 3 px wide.)
    """
    if tex.ndim != 3:
        return None
    return "rows" if tex.shape[-1] == 3 else "planes"


def _scramble_mult(n: int) -> int | None:
    """Multiplier for the corner-rows index scramble, or None to disable.

    The rows table is stored PERMUTED by f' = (f * A) mod N and the sampler
    applies the same map to its indices — bit-identical output. The
    permutation spreads the spatially coherent footprint indices of a
    smooth deflection field; whether that helps or hurts a cached GPU
    memory hierarchy is unmeasured (ROADMAP A4), and BHR_TEX_SCRAMBLE=0
    turns it off.

    Correctness constraints: A*(n-1) must not overflow u32 (no x64 by
    default — the golden-ratio constant wraps mod 2^32 and is NOT injective),
    and gcd(A, n) == 1 for bijectivity. Deterministic in n, so the table
    builder and the sampler always agree."""
    if os.environ.get("BHR_TEX_SCRAMBLE", "1") == "0":
        return None
    limit = (2**32 - 1) // max(n - 1, 1)
    for a in (509, 503, 499, 491, 127, 113, 61, 31, 13, 7, 5, 3):
        if a <= limit and math.gcd(a, n) == 1:
            return a
    return None


def _scramble_idx(idx, n: int):
    """Apply the index scramble (int32 flat indices -> int32)."""
    a = _scramble_mult(n)
    if a is None:
        return idx
    return (
        (idx.astype(jnp.uint32) * jnp.uint32(a)) % jnp.uint32(n)
    ).astype(jnp.int32)


def _footprint(u, v, w, h):
    """Shared bilinear sample-footprint math: (x0, y0f_int, fx, fy).

    Single source of truth for BOTH packed samplers (4-gather and
    corner-packed) so their bit-identity is structural: any footprint
    change lands in both paths by construction."""
    x = u * w - 0.5
    y = v * h - 0.5
    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = jnp.mod(x0f.astype(jnp.int32), w)
    return x0, y0f.astype(jnp.int32), fx, fy


def _lerp2d(t00, t10, t01, t11, fx, fy):
    """The oracle's bilinear expression tree (identical in both samplers)."""
    top = t00 * (1.0 - fx) + t10 * fx
    bot = t01 * (1.0 - fx) + t11 * fx
    return top * (1.0 - fy) + bot * fy


def sample_equirect_packed(packed_texture: jnp.ndarray, dx, dy, dz,
                           filter: str = "bilinear"):
    """Planar equirect sample from a packed-u32 texture.

    Same sampler semantics as sample_equirect (Repeat-U/Clamp-V, half-texel
    centers, k/255 Rgba8Unorm values — reference lib.rs:414-421), but
    operating on (...,)-shaped direction component planes.

    The formulation minimizes the gather index count and flattens to 1-D
    takes:

      filter="bilinear" — exact bilinear: 3 flat gathers when given a
                          corner-packed (3, H+1, W) texture
                          (corner_pack_texture — the renderer's bilinear
                          tier), 4 when given a plain packed (H, W) one;
      filter="nearest"  — wgpu FilterMode::Nearest semantics, 1 flat gather
                          — the real-time texture tier.
    """
    layout = _corner_layout(packed_texture)
    if layout == "rows":
        h = packed_texture.shape[0] - 1
        w = packed_texture.shape[1]
    elif layout == "planes":
        h = packed_texture.shape[1] - 1
        w = packed_texture.shape[2]
    else:
        h, w = packed_texture.shape
    inv = jax.lax.rsqrt(dx * dx + dy * dy + dz * dz)
    u = 0.5 + jnp.arctan2(dz, dx) / jnp.float32(6.28318530718)
    v = 0.5 - jnp.arcsin(jnp.clip(dy * inv, -1.0, 1.0)) / jnp.float32(3.14159265359)
    if layout is not None:
        if filter != "bilinear":
            raise ValueError("corner-packed textures are bilinear-only")
        if layout == "rows":
            return _sample_corner_rows(packed_texture, u, v)
        return _sample_corner_packed(packed_texture, u, v)
    flat = packed_texture.reshape(-1)
    if filter == "nearest":
        xn = jnp.mod(jnp.floor(u * w).astype(jnp.int32), w)
        yn = jnp.clip(jnp.floor(v * h).astype(jnp.int32), 0, h - 1)
        return _unpack_rgb(jnp.take(flat, yn * w + xn))
    x0, y0f, fx, fy = _footprint(u, v, w, h)
    x1 = jnp.mod(x0 + 1, w)
    y0 = jnp.clip(y0f, 0, h - 1)
    y1 = jnp.clip(y0f + 1, 0, h - 1)
    y0w = y0 * w
    y1w = y1 * w
    c00 = _unpack_rgb(jnp.take(flat, y0w + x0))
    c10 = _unpack_rgb(jnp.take(flat, y0w + x1))
    c01 = _unpack_rgb(jnp.take(flat, y1w + x0))
    c11 = _unpack_rgb(jnp.take(flat, y1w + x1))
    return tuple(
        _lerp2d(c00[k], c10[k], c01[k], c11[k], fx, fy) for k in range(3)
    )


def corner_pack_texture(packed: jnp.ndarray) -> jnp.ndarray:
    """Packed-u32 (H, W) equirect texture -> corner-packed (3, H+1, W) u32.

    Exact-bilinear gather-count optimization: plane c, texel (row, u) packs
    the FOUR bilinear corner samples of channel c for any sample point whose
    footprint top-left is (y0f = row - 1, x0 = u):

        byte0 = T_c[y0, x0]    byte1 = T_c[y0, x1]
        byte2 = T_c[y1, x0]    byte3 = T_c[y1, x1]

    with x1 = (x0 + 1) mod W (Repeat-U) and y0/y1 the oracle's
    clip(y0f, 0, H-1) / clip(y0f + 1, 0, H-1) (Clamp-V) — the extra row 0
    holds the y0f = -1 top-edge case (both corner rows = row 0), so the
    sampler needs no V clamp at all. One gather per CHANNEL (3 total,
    alpha is constant) replaces one gather per CORNER (4): the minimum
    possible for exact bilinear, since a pixel's footprint spans 12
    independent bytes and a u32 gather returns 4.

    Built gather-free (rolls + concats); 3x the texture's HBM footprint.
    """
    h, w = packed.shape
    planes = []
    for shift in (0, 8, 16):
        c = (packed >> shift) & jnp.uint32(0xFF)
        right = jnp.roll(c, -1, axis=1)  # x1 = (x0 + 1) mod W: Repeat-U
        down = jnp.concatenate([c[1:], c[h - 1 : h]], axis=0)  # Clamp-V
        down_right = jnp.roll(down, -1, axis=1)
        core = c | (right << 8) | (down << 16) | (down_right << 24)
        top = c[0:1] | (right[0:1] << 8) | (c[0:1] << 16) | (right[0:1] << 24)
        planes.append(jnp.concatenate([top, core], axis=0))
    return jnp.stack(planes)


def corner_pack_texture_rows(
    packed: jnp.ndarray, scramble: bool = True
) -> jnp.ndarray:
    """Packed-u32 (H, W) equirect texture -> interleaved corner rows
    (H+1, W, 3) u32: row-major footprint f = (row, u) holds the THREE
    channel corner-words of corner_pack_texture side by side.

    Why a third layout: a `jnp.take(table, idx, axis=0)` row gather moves
    a 3-word slice per index, so packing a footprint's three channel
    corner-words contiguously makes EXACT bilinear cost ONE gather index
    per pixel — same index count as the nearest tier — instead of the
    planar layout's three.

    With `scramble` (the default) the rows are stored PERMUTED by
    f' = (f * A) mod N and the samplers apply the same map to their
    indices (see _scramble_mult).
    `scramble=False` keeps the identity layout for probes/tests that
    index the table directly — the samplers below always assume the
    scrambled layout, so never feed them a scramble=False table.

    Same 3x HBM footprint as the planar layout; bit-identical sampling
    (the corner words are the same, only their addresses change).
    """
    h, w = packed.shape
    planes = []
    for shift in (0, 8, 16):
        c = (packed >> shift) & jnp.uint32(0xFF)
        right = jnp.roll(c, -1, axis=1)  # x1 = (x0 + 1) mod W: Repeat-U
        down = jnp.concatenate([c[1:], c[h - 1 : h]], axis=0)  # Clamp-V
        down_right = jnp.roll(down, -1, axis=1)
        core = c | (right << 8) | (down << 16) | (down_right << 24)
        top = c[0:1] | (right[0:1] << 8) | (c[0:1] << 16) | (right[0:1] << 24)
        planes.append(jnp.concatenate([top, core], axis=0))
    rows = jnp.stack(planes, axis=-1)
    n = (h + 1) * w
    a = _scramble_mult(n) if scramble else None
    if a is None:
        return rows
    flat = rows.reshape(-1, 3)
    perm = (jnp.arange(n, dtype=jnp.uint32) * jnp.uint32(a)) % jnp.uint32(n)
    return (
        jnp.zeros_like(flat)
        .at[perm.astype(jnp.int32)]
        .set(flat)
        .reshape(h + 1, w, 3)
    )


def _sample_corner_rows(cr: jnp.ndarray, u, v):
    """Exact bilinear from interleaved corner rows (H+1, W, 3): ONE gather.

    Bit-identical to _sample_corner_packed / the 4-gather path — identical
    corner words and lerp expression trees; only the HBM access changes
    (one slice-3 row take instead of three flat takes)."""
    h = cr.shape[0] - 1
    w = cr.shape[1]
    out_shape = u.shape
    x0, y0f, fx, fy = _footprint(u, v, w, h)
    row = jnp.clip(y0f + 1, 0, h)
    idx = _scramble_idx((row * w + x0).reshape(-1), (h + 1) * w)
    # one per-index slice-3 row gather; channel extraction by minor-dim
    # slicing
    words = jnp.take(cr.reshape(-1, 3), idx, axis=0).reshape(out_shape + (3,))
    s = jnp.float32(1.0 / 255.0)
    out = []
    for c in range(3):
        word = words[..., c]
        t00 = (word & jnp.uint32(0xFF)).astype(jnp.float32) * s
        t10 = ((word >> 8) & jnp.uint32(0xFF)).astype(jnp.float32) * s
        t01 = ((word >> 16) & jnp.uint32(0xFF)).astype(jnp.float32) * s
        t11 = (word >> 24).astype(jnp.float32) * s
        out.append(_lerp2d(t00, t10, t01, t11, fx, fy))
    return tuple(out)


def _sample_corner_packed(cp: jnp.ndarray, u, v):
    """Exact bilinear from a corner-packed (3, H+1, W) texture: 3 gathers.

    Bit-identical to the 4-gather path (and to sample_equirect): the corner
    values and the lerp expression trees are exactly the same; only the
    number of HBM lookups changes."""
    h = cp.shape[1] - 1
    w = cp.shape[2]
    x0, y0f, fx, fy = _footprint(u, v, w, h)
    # v in [0, 1] => y0f in [-1, h-1] => row in [0, h]; clip guards callers
    # that feed unnormalized v
    row = jnp.clip(y0f + 1, 0, h)
    idx = row * w + x0
    # ONE take over all three channel planes (channel-offset flat indices)
    # instead of three take ops
    plane_sz = (h + 1) * w
    flat_idx = jnp.stack([idx + c * plane_sz for c in range(3)])
    words = jnp.take(cp.reshape(-1), flat_idx)
    s = jnp.float32(1.0 / 255.0)
    out = []
    for c in range(3):
        word = words[c]
        t00 = (word & jnp.uint32(0xFF)).astype(jnp.float32) * s
        t10 = ((word >> 8) & jnp.uint32(0xFF)).astype(jnp.float32) * s
        t01 = ((word >> 16) & jnp.uint32(0xFF)).astype(jnp.float32) * s
        t11 = (word >> 24).astype(jnp.float32) * s
        out.append(_lerp2d(t00, t10, t01, t11, fx, fy))
    return tuple(out)


def sample_equirect_packed_subsampled(
    packed_texture, vx, vy, vz, status, sub: int, filter: str = "bilinear"
):
    """Texture background sampled on a 1/`sub`-resolution direction grid.

    The gather-count attack for the texture tiers: sampling the equirect
    map at every `sub`-th FULL-RESOLUTION direction
    and bilinearly upsampling the resulting color planes cuts the index
    count sub^2 x. Validity of the approximation: at the benchmark
    geometry the lensed sky is magnified ~2.8x relative to a 4K texture at
    1080p, so a sub=2 color grid still samples the texture above its own
    Nyquist rate wherever the deflection field is smooth (quality gauged by
    scripts/texture_quality.py SSIM vs the full-res exact-bilinear render,
    not parity).

    Corner-aligned: low sample (i, j) uses the exact direction of full
    pixel (i*sub, j*sub), so phase-0 pixels reproduce their full-res color
    bit-exactly (resample.upsample_bilinear).

    Captured/disk low samples carry frozen/garbage directions; they are
    excluded from the interpolation by a weight plane (num/den upsample),
    so the shadow edge gets no color halo — the full-res capture mask
    (applied downstream in shade_planes_packed) still decides black vs sky
    per pixel exactly. Pixels whose entire bilinear support is invalid
    shade black (they are nearly always captured themselves).
    """
    from .resample import subsample_mm, upsample_bilinear
    from .trace import STATUS_CAPTURED, STATUS_DISK

    out_shape = vx.shape
    # decimation via one-hot selection matmuls (resample.subsample_mm)
    vxs, vys, vzs = (subsample_mm(p, sub) for p in (vx, vy, vz))
    r, g, b = sample_equirect_packed(packed_texture, vxs, vys, vzs, filter=filter)
    valid_f = (
        (status != STATUS_CAPTURED) & (status != STATUS_DISK)
    ).astype(jnp.float32)
    w = subsample_mm(valid_f, sub)
    den = upsample_bilinear(w, sub, out_shape)
    inv = (1.0 / jnp.maximum(den, jnp.float32(1e-6))) * (den > 0.0).astype(
        jnp.float32
    )
    return tuple(upsample_bilinear(c * w, sub, out_shape) * inv for c in (r, g, b))


def luma_pack_texture(packed: jnp.ndarray):
    """Packed-u32 (H, W) equirect texture -> the "luma" tier tables:
    (corner-packed luma (H+1, W) u32, chroma (H, W) u32).

    The quality insight behind the tier: in a star-map texture all the
    SSIM-relevant structure lives in luminance — chroma is smooth. So:

      * luma L = round(mean(R, G, B)) is corner-packed exactly like
        corner_pack_texture (all four bilinear corner texels of L in one
        word, Repeat-U/Clamp-V baked in) — EXACT bilinear luminance costs
        ONE gather per pixel;
      * chroma (R - L, G - L, B - L), three 9-bit biased ints in one u32,
        is sampled nearest on a subsampled screen grid and upsampled
        (sample_equirect_packed_luma) — smooth content, so the subsample
        is visually free.

    Net: bilinear-luminance-exact sampling at ~1.25 gathers/pixel vs 3 for
    full corner-packed bilinear and 1 for nearest. Built gather-free.
    """
    r, g, b = _unpack_rgb(packed)
    li = jnp.round((r + g + b) * jnp.float32(255.0 / 3.0)).astype(jnp.int32)
    lq = li.astype(jnp.uint32)

    h, w = packed.shape
    c = lq & jnp.uint32(0xFF)
    right = jnp.roll(c, -1, axis=1)  # x1 = (x0 + 1) mod W: Repeat-U
    down = jnp.concatenate([c[1:], c[h - 1 : h]], axis=0)  # Clamp-V
    down_right = jnp.roll(down, -1, axis=1)
    core = c | (right << 8) | (down << 16) | (down_right << 24)
    top = c[0:1] | (right[0:1] << 8) | (c[0:1] << 16) | (right[0:1] << 24)
    luma_cp = jnp.concatenate([top, core], axis=0)

    def chan(x):
        q = jnp.round(x * 255.0).astype(jnp.int32)
        return (q - li + 256).astype(jnp.uint32)  # 9-bit biased

    chroma = chan(r) | (chan(g) << 9) | (chan(b) << 18)
    return luma_cp, chroma


def _equirect_uv(dx, dy, dz):
    """Direction planes -> equirect (u, v) in [0, 1] (wgsl:93-98 mapping)."""
    inv = jax.lax.rsqrt(dx * dx + dy * dy + dz * dz)
    u = 0.5 + jnp.arctan2(dz, dx) / jnp.float32(6.28318530718)
    v = 0.5 - jnp.arcsin(jnp.clip(dy * inv, -1.0, 1.0)) / jnp.float32(3.14159265359)
    return u, v


def sample_equirect_packed_luma(tex_pair, vx, vy, vz, status, chroma_sub: int = 2):
    """The "luma" texture tier sampler (see luma_pack_texture).

    Exact bilinear LUMINANCE per pixel (one corner-packed gather) plus
    nearest-sampled chroma on a corner-aligned 1/chroma_sub screen grid,
    upsampled with captured/disk samples excluded. Returns (r, g, b)
    planes.
    """
    from .resample import upsample_bilinear
    from .trace import STATUS_CAPTURED, STATUS_DISK

    luma_cp, chroma = tex_pair
    h = luma_cp.shape[0] - 1
    w = luma_cp.shape[1]
    out_shape = vx.shape

    # exact bilinear luma footprint, full resolution: one index per pixel
    u, v = _equirect_uv(vx, vy, vz)
    x0, y0f, fx, fy = _footprint(u, v, w, h)
    row = jnp.clip(y0f + 1, 0, h)
    idx_l = (row * w + x0).reshape(-1)

    # nearest chroma on the subsampled grid (smooth content); decimation
    # via one-hot selection matmuls
    from .resample import subsample_mm

    sub = max(int(chroma_sub), 1)
    us, vs = (subsample_mm(p, sub) if sub > 1 else p for p in (u, v))
    sub_shape = us.shape
    xn = jnp.mod(jnp.floor(us * w).astype(jnp.int32), w)
    yn = jnp.clip(jnp.floor(vs * h).astype(jnp.int32), 0, h - 1)
    idx_c = (yn * w + xn).reshape(-1)

    # ONE merged take over [luma table | chroma table]
    luma_flat = luma_cp.reshape(-1)
    off = luma_flat.shape[0]
    combined = jnp.concatenate([luma_flat, chroma.reshape(-1)])
    words = jnp.take(combined, jnp.concatenate([idx_l, idx_c + off]))
    word = words[: idx_l.size].reshape(out_shape)
    cword = words[idx_l.size :].reshape(sub_shape)

    s = jnp.float32(1.0 / 255.0)
    t00 = (word & jnp.uint32(0xFF)).astype(jnp.float32) * s
    t10 = ((word >> 8) & jnp.uint32(0xFF)).astype(jnp.float32) * s
    t01 = ((word >> 16) & jnp.uint32(0xFF)).astype(jnp.float32) * s
    t11 = (word >> 24).astype(jnp.float32) * s
    luma = _lerp2d(t00, t10, t01, t11, fx, fy)

    def cchan(sh):
        q = ((cword >> sh) & jnp.uint32(0x1FF)).astype(jnp.int32) - 256
        return q.astype(jnp.float32) * s

    valid_f = (
        (status != STATUS_CAPTURED) & (status != STATUS_DISK)
    ).astype(jnp.float32)
    wt = subsample_mm(valid_f, sub) if sub > 1 else valid_f
    if sub == 1:
        return tuple(luma + cchan(sh) for sh in (0, 9, 18))
    den = upsample_bilinear(wt, sub, out_shape)
    inv = (1.0 / jnp.maximum(den, jnp.float32(1e-6))) * (den > 0.0).astype(
        jnp.float32
    )
    return tuple(
        luma + upsample_bilinear(cchan(sh) * wt, sub, out_shape) * inv
        for sh in (0, 9, 18)
    )


def _interleave(a, b, axis):
    """Elementwise interleave of two same-shape planes along `axis`."""
    st = jnp.stack([a, b], axis=axis + 1)
    sh = list(a.shape)
    sh[axis] *= 2
    return st.reshape(sh)


def _pad_to(plane, shape):
    return jnp.pad(
        plane, ((0, shape[0] - plane.shape[0]), (0, shape[1] - plane.shape[1]))
    )


def sample_equirect_packed_checkerboard(
    packed_texture, vx, vy, vz, status, filter: str = "bilinear"
):
    """Texture background gathered for HALF the pixels (checker pattern).

    The quality-optimal half-index-count scheme: pixels with (i + j) even
    sample the texture with their exact full-res direction; each hole
    (i + j odd) reconstructs from its four DISTANCE-1 axis neighbors — all
    of which are sampled. Against the 1/sub-grid scheme
    (sample_equirect_packed_subsampled, 2 px interpolation span) the 1 px
    span roughly quarters the peak attenuation of point stars, at 2x the
    gather count (half of full instead of a quarter).

    Captured/disk samples are excluded by weight; sampled pixels keep their
    exact color bit-for-bit (the downstream capture mask blacks out
    captured pixels regardless).
    """
    from .resample import shift, subsample_mm
    from .trace import STATUS_CAPTURED, STATUS_DISK

    h, w = vx.shape
    he, we = (h + 1) // 2, (w + 1) // 2  # even-row / even-col counts
    ho, wo = h // 2, w // 2

    # checker-set directions via one-hot selection decimation; both sets'
    # texture lookups merge into ONE flat take
    dirs_e = tuple(subsample_mm(p, 2, 0) for p in (vx, vy, vz))
    dirs_o = tuple(subsample_mm(p, 2, 1) for p in (vx, vy, vz))

    layout = _corner_layout(packed_texture)
    if layout == "rows":
        th_, tw_ = packed_texture.shape[0] - 1, packed_texture.shape[1]
    elif layout == "planes":
        th_, tw_ = packed_texture.shape[1] - 1, packed_texture.shape[2]
    else:
        th_, tw_ = packed_texture.shape

    def gather_pair(de, do):
        ue, ve = _equirect_uv(*de)
        uo, vo = _equirect_uv(*do)
        if filter == "nearest" and layout is None:
            def nearest_idx(u, v):
                xn = jnp.mod(jnp.floor(u * tw_).astype(jnp.int32), tw_)
                yn = jnp.clip(jnp.floor(v * th_).astype(jnp.int32), 0, th_ - 1)
                return yn * tw_ + xn

            flat_idx = jnp.concatenate(
                [nearest_idx(ue, ve).reshape(-1), nearest_idx(uo, vo).reshape(-1)]
            )
            words = jnp.take(packed_texture.reshape(-1), flat_idx)
            we_ = _unpack_rgb(words[: he * we].reshape(he, we))
            wo_ = _unpack_rgb(words[he * we :].reshape(ho, wo))
            return we_, wo_
        # bilinear tiers: corner-packed per set — merge both sets' indices
        if layout is not None:
            def corner_idx(u, v):
                x0, y0f, fx, fy = _footprint(u, v, tw_, th_)
                row = jnp.clip(y0f + 1, 0, th_)
                return row * tw_ + x0, fx, fy

            ie, fxe, fye = corner_idx(ue, ve)
            io, fxo, fyo = corner_idx(uo, vo)
            set_idx = jnp.concatenate([ie.reshape(-1), io.reshape(-1)])
            if layout == "rows":
                # one slice-3 row gather for both checker sets (indices
                # scrambled to match the permuted table — see _scramble_mult)
                set_idx = _scramble_idx(set_idx, (th_ + 1) * tw_)
                words3 = jnp.transpose(
                    jnp.take(packed_texture.reshape(-1, 3), set_idx, axis=0),
                    (1, 0),
                )
            else:
                plane_sz = (th_ + 1) * tw_
                flat_idx = jnp.stack([set_idx + c * plane_sz for c in range(3)])
                words3 = jnp.take(packed_texture.reshape(-1), flat_idx)
            s = jnp.float32(1.0 / 255.0)
            out_e, out_o = [], []
            for c in range(3):
                word = words3[c]

                def lerp(wd, fx, fy):
                    t00 = (wd & jnp.uint32(0xFF)).astype(jnp.float32) * s
                    t10 = ((wd >> 8) & jnp.uint32(0xFF)).astype(jnp.float32) * s
                    t01 = ((wd >> 16) & jnp.uint32(0xFF)).astype(jnp.float32) * s
                    t11 = (wd >> 24).astype(jnp.float32) * s
                    return _lerp2d(t00, t10, t01, t11, fx, fy)

                out_e.append(lerp(word[: he * we].reshape(he, we), fxe, fye))
                out_o.append(lerp(word[he * we :].reshape(ho, wo), fxo, fyo))
            return tuple(out_e), tuple(out_o)
        # plain packed texture, non-nearest: fall back to two sampler calls
        return (
            sample_equirect_packed(packed_texture, *de, filter=filter),
            sample_equirect_packed(packed_texture, *do, filter=filter),
        )

    rgb_e, rgb_o = gather_pair(dirs_e, dirs_o)
    valid_f = (
        (status != STATUS_CAPTURED) & (status != STATUS_DISK)
    ).astype(jnp.float32)
    w_e = subsample_mm(valid_f, 2, 0)
    w_o = subsample_mm(valid_f, 2, 1)

    def weave(ce, co):
        """(he, we) even-set + (ho, wo) odd-set planes -> (h, w) with zeros
        at the holes."""
        co = _pad_to(co, (he, we))
        z = jnp.zeros((he, we), jnp.float32)
        rows_e = _interleave(ce, z, 1)  # even rows: samples at even cols
        rows_o = _interleave(z, co, 1)  # odd rows: samples at odd cols
        return _interleave(rows_e, rows_o, 0)[:h, :w]

    ws = weave(w_e, w_o)
    den = (
        shift(ws, -1, 0) + shift(ws, 1, 0) + shift(ws, -1, 1) + shift(ws, 1, 1)
    )
    inv = (1.0 / jnp.maximum(den, jnp.float32(1e-6))) * (den > 0.0).astype(
        jnp.float32
    )
    # static checkerboard: 1 at sampled positions
    ii = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    hole = ((ii + jj) & 1).astype(jnp.float32)
    out = []
    for k in range(3):
        s = weave(rgb_e[k] * w_e, rgb_o[k] * w_o)
        n4 = shift(s, -1, 0) + shift(s, 1, 0) + shift(s, -1, 1) + shift(s, 1, 1)
        # sampled positions keep their exact color (even invalid ones — the
        # downstream capture mask owns those pixels); holes take the
        # valid-neighbor mean
        full = weave(rgb_e[k], rgb_o[k])
        out.append(full * (1.0 - hole) + hole * n4 * inv)
    return tuple(out)


def pack_rgba8_planes(r, g, b, alpha: float = 1.0) -> jnp.ndarray:
    """fp32 color planes in [0,1] -> packed uint32 RGBA plane.

    The packed plane is the frame format (one (H, W) u32 plane);
    `unpack_frame` views it as the conventional (H, W, 4) uint8.
    """
    q = lambda c: jnp.round(jnp.clip(c, 0.0, 1.0) * 255.0).astype(jnp.uint32)
    a = jnp.uint32(int(round(alpha * 255.0))) << 24
    return q(r) | (q(g) << 8) | (q(b) << 16) | a


def unpack_frame(packed: jnp.ndarray) -> jnp.ndarray:
    """Packed uint32 (..., H, W) frame -> uint8 (..., H, W, 4) RGBA view."""
    return jax.lax.bitcast_convert_type(packed, jnp.uint8)


def quantize_rgba8(rgb: jnp.ndarray, alpha: float = 1.0) -> jnp.ndarray:
    """fp32 (..., 3) in [0,1] -> uint8 (..., 4) RGBA.

    Matches rgba8unorm textureStore conversion (round-to-nearest of
    clamp(v, 0, 1) * 255; reference writes alpha 1.0, wgsl:214).
    """
    rgb = jnp.clip(rgb, 0.0, 1.0)
    q = jnp.round(rgb * 255.0).astype(jnp.uint8)
    a = jnp.full(q.shape[:-1] + (1,), int(round(alpha * 255.0)), jnp.uint8)
    return jnp.concatenate([q, a], axis=-1)
