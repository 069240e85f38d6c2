"""Texture sampling semantics (reference lib.rs:414-421 sampler config)."""

import jax.numpy as jnp
import numpy as np

from bhr_tpu.ops.sampling import (
    pack_rgba8_planes,
    pack_texture_rgba8,
    quantize_rgba8,
    sample_bilinear,
    sample_equirect,
    sample_equirect_packed,
    unpack_frame,
)


def _tex(h=8, w=16, seed=3):
    rng = np.random.RandomState(seed)
    t = rng.randint(0, 256, (h, w, 4)).astype(np.float32) / 255.0
    return jnp.asarray(t)


def test_bilinear_texel_center_exact():
    tex = _tex()
    h, w = 8, 16
    # sampling exactly at texel centers returns the texel value
    u = (jnp.arange(w) + 0.5) / w
    v = jnp.full((w,), (3 + 0.5) / h)
    out = np.asarray(sample_bilinear(tex, u, v))
    np.testing.assert_allclose(out, np.asarray(tex)[3, :, :], atol=1e-6)


def test_bilinear_interpolates_midpoint():
    tex = _tex()
    h, w = 8, 16
    u = jnp.asarray([(2 + 1.0) / w])  # halfway between texels 2 and 3
    v = jnp.asarray([(4 + 0.5) / h])
    out = np.asarray(sample_bilinear(tex, u, v))[0]
    want = (np.asarray(tex)[4, 2] + np.asarray(tex)[4, 3]) / 2
    np.testing.assert_allclose(out, want, atol=1e-6)


def test_repeat_u_wraps_at_seam():
    tex = _tex()
    h, w = 8, 16
    # u slightly left of 0 must blend texels w-1 and 0 (AddressMode::Repeat)
    u = jnp.asarray([0.0])  # x = -0.5 -> x0 = -1 -> wraps to w-1, fx=0.5
    v = jnp.asarray([(4 + 0.5) / h])
    out = np.asarray(sample_bilinear(tex, u, v))[0]
    want = (np.asarray(tex)[4, w - 1] + np.asarray(tex)[4, 0]) / 2
    np.testing.assert_allclose(out, want, atol=1e-6)


def test_clamp_v_at_poles():
    tex = _tex()
    # v = 0 -> y = -0.5 -> clamps to row 0 (AddressMode::ClampToEdge)
    u = jnp.asarray([(5 + 0.5) / 16])
    out0 = np.asarray(sample_bilinear(tex, u, jnp.asarray([0.0])))[0]
    np.testing.assert_allclose(out0, np.asarray(tex)[0, 5], atol=1e-6)
    out1 = np.asarray(sample_bilinear(tex, u, jnp.asarray([1.0])))[0]
    np.testing.assert_allclose(out1, np.asarray(tex)[7, 5], atol=1e-6)


def test_packed_matches_float_path():
    """The packed-u32 sampler is the production path; on k/255 textures it
    must agree with the float reference sampler exactly."""
    tex = _tex(16, 32)
    packed = pack_texture_rgba8(tex)
    rng = np.random.RandomState(0)
    d = rng.randn(100, 3).astype(np.float32)
    dx, dy, dz = (jnp.asarray(d[:, i]) for i in range(3))
    r, g, b = sample_equirect_packed(packed, dx, dy, dz)
    ref = np.asarray(sample_equirect(tex, jnp.asarray(d)))[:, :3]
    got = np.stack([np.asarray(r), np.asarray(g), np.asarray(b)], -1)
    np.testing.assert_allclose(got, ref, atol=2e-6)


def test_corner_packed_bit_matches_four_gather():
    """The 3-gather corner-packed bilinear (the renderer's bilinear tier)
    must be BIT-identical to the 4-gather path: same corner values, same
    lerp expression trees — only the HBM lookup count differs. Directions
    cover the U seam and both V poles (the clamp rows the extra row-0
    encodes)."""
    import jax

    from bhr_tpu.ops.sampling import corner_pack_texture

    tex = _tex(16, 32, seed=7)
    packed = pack_texture_rgba8(tex)
    cp = jax.jit(corner_pack_texture)(packed)
    assert cp.shape == (3, 17, 32)
    rng = np.random.RandomState(5)
    d = rng.randn(4000, 3).astype(np.float32)
    # pole-heavy directions: dy dominant -> v near 0/1 (y0f = -1 edge case)
    d[:400, 1] = np.abs(d[:400, 1]) * 50.0 + 50.0
    d[400:800, 1] = -(np.abs(d[400:800, 1]) * 50.0 + 50.0)
    dx, dy, dz = (jnp.asarray(d[:, i]) for i in range(3))
    a = np.stack(sample_equirect_packed(packed, dx, dy, dz), -1)
    b = np.stack(sample_equirect_packed(cp, dx, dy, dz), -1)
    np.testing.assert_array_equal(a, b)


def test_corner_rows_bit_matches_four_gather():
    """The interleaved corner-rows bilinear (one slice-3 row gather — the
    renderer's bilinear tier since round 3) must be BIT-identical to both
    the 4-gather path and the planar 3-gather corner layout. Pole-heavy
    directions exercise the clamp rows."""
    import jax

    from bhr_tpu.ops.sampling import (
        corner_pack_texture,
        corner_pack_texture_rows,
    )

    tex = _tex(16, 32, seed=7)
    packed = pack_texture_rgba8(tex)
    cr = jax.jit(corner_pack_texture_rows)(packed)
    assert cr.shape == (17, 32, 3)
    # the (unscrambled) interleaved rows hold the SAME corner words as the
    # planar layout; the default scrambled build is that table row-permuted
    cr_plain = jax.jit(
        lambda p: corner_pack_texture_rows(p, scramble=False)
    )(packed)
    cp = jax.jit(corner_pack_texture)(packed)
    np.testing.assert_array_equal(
        np.asarray(cr_plain), np.transpose(np.asarray(cp), (1, 2, 0))
    )
    np.testing.assert_array_equal(
        np.sort(np.asarray(cr).reshape(-1, 3), axis=0),
        np.sort(np.asarray(cr_plain).reshape(-1, 3), axis=0),
    )
    rng = np.random.RandomState(5)
    d = rng.randn(4000, 3).astype(np.float32)
    d[:400, 1] = np.abs(d[:400, 1]) * 50.0 + 50.0
    d[400:800, 1] = -(np.abs(d[400:800, 1]) * 50.0 + 50.0)
    dx, dy, dz = (jnp.asarray(d[:, i]) for i in range(3))
    a = np.stack(sample_equirect_packed(packed, dx, dy, dz), -1)
    b = np.stack(sample_equirect_packed(cr, dx, dy, dz), -1)
    np.testing.assert_array_equal(a, b)


def test_rows_scramble_is_bijective_and_bit_exact():
    """The coherence-defeating index scramble (f' = f*A mod N, table rows
    stored permuted — see sampling._scramble_mult) must be a true
    bijection and bit-invisible to the sampler, including for texture
    shapes where N shares a factor with the preferred multiplier or N is
    too large for it (u32-overflow guard)."""
    import jax

    from bhr_tpu.ops.sampling import (
        _scramble_mult,
        corner_pack_texture_rows,
    )

    rng = np.random.RandomState(11)
    d = rng.randn(2000, 3).astype(np.float32)
    dx, dy, dz = (jnp.asarray(d[:, i]) for i in range(3))
    # (h, w) cases: generic; (h+1)*w divisible by 509 (gcd fallback);
    # non-pow2 width (odd-shaped texture)
    for h, w in ((16, 32), (508, 16), (20, 30)):
        n = (h + 1) * w
        a = _scramble_mult(n)
        assert a is not None and a * (n - 1) < 2**32
        import math

        assert math.gcd(a, n) == 1
        if n % 509 == 0:
            assert a != 509
        perm = (np.arange(n, dtype=np.uint64) * a) % n
        assert len(np.unique(perm)) == n  # bijective
        tex = _tex(h, w, seed=h + w)
        packed = pack_texture_rgba8(tex)
        cr = jax.jit(corner_pack_texture_rows)(packed)
        ref = np.stack(sample_equirect_packed(packed, dx, dy, dz), -1)
        got = np.stack(sample_equirect_packed(cr, dx, dy, dz), -1)
        np.testing.assert_array_equal(ref, got)


def test_rows_scramble_env_kill_switch(monkeypatch):
    """BHR_TEX_SCRAMBLE=0 must disable the permutation consistently in
    builder AND sampler (the A/B knob for on-device measurement).

    Built eagerly: the env var is read at trace time, so a jitted build
    here could replay another test's cached (scrambled) executable."""
    from bhr_tpu.ops.sampling import corner_pack_texture_rows

    tex = _tex(16, 32, seed=9)
    packed = pack_texture_rgba8(tex)
    monkeypatch.setenv("BHR_TEX_SCRAMBLE", "0")
    cr_off = corner_pack_texture_rows(packed)
    np.testing.assert_array_equal(
        np.asarray(cr_off),
        np.asarray(corner_pack_texture_rows(packed, scramble=False)),
    )
    rng = np.random.RandomState(13)
    d = rng.randn(500, 3).astype(np.float32)
    dx, dy, dz = (jnp.asarray(d[:, i]) for i in range(3))
    ref = np.stack(sample_equirect_packed(packed, dx, dy, dz), -1)
    got = np.stack(sample_equirect_packed(cr_off, dx, dy, dz), -1)
    np.testing.assert_array_equal(ref, got)


def test_corner_rows_checkerboard_matches_planar():
    """The checkerboard sampler produces identical frames from the rows
    layout and the planar layout (same corner words, same reconstruction)."""
    import jax

    from bhr_tpu.ops.sampling import (
        corner_pack_texture,
        corner_pack_texture_rows,
        sample_equirect_packed_checkerboard,
    )

    tex = _tex(16, 32, seed=11)
    packed = pack_texture_rgba8(tex)
    rng = np.random.RandomState(3)
    d = rng.randn(24, 40, 3).astype(np.float32)
    planes = tuple(jnp.asarray(d[..., i]) for i in range(3))
    status = jnp.asarray(
        (rng.rand(24, 40) < 0.2).astype(np.int32)
    )  # some captured
    out = []
    for pack in (corner_pack_texture, corner_pack_texture_rows):
        t = jax.jit(pack)(packed)
        out.append(
            np.stack(
                sample_equirect_packed_checkerboard(t, *planes, status), -1
            )
        )
    np.testing.assert_array_equal(out[0], out[1])


def test_quantize_rgba8():
    rgb = jnp.asarray([[0.0, 0.5, 1.0], [-0.1, 1.1, 0.25]])
    q = np.asarray(quantize_rgba8(rgb))
    assert q.dtype == np.uint8
    np.testing.assert_array_equal(q[0], [0, 128, 255, 255])
    np.testing.assert_array_equal(q[1], [0, 255, 64, 255])


def test_pack_unpack_frame_matches_quantize():
    rng = np.random.RandomState(1)
    c = rng.rand(8, 8, 3).astype(np.float32)
    ref = np.asarray(quantize_rgba8(jnp.asarray(c)))
    packed = pack_rgba8_planes(
        jnp.asarray(c[..., 0]), jnp.asarray(c[..., 1]), jnp.asarray(c[..., 2])
    )
    assert packed.dtype == jnp.uint32
    via_device = np.asarray(unpack_frame(packed))
    np.testing.assert_array_equal(via_device, ref)
    via_host = np.asarray(packed).view(np.uint8).reshape(8, 8, 4)
    np.testing.assert_array_equal(via_host, ref)


def test_pack_texture_lossless_roundtrip():
    tex = _tex()  # k/255 values by construction
    packed = np.asarray(pack_texture_rgba8(tex))
    r = (packed & 0xFF).astype(np.float32) / 255.0
    np.testing.assert_allclose(r, np.asarray(tex)[..., 0], atol=1e-7)


def test_nearest_filter_semantics():
    """filter='nearest' picks the texel whose cell contains (u, v) —
    wgpu FilterMode::Nearest with Repeat-U / Clamp-V addressing."""
    import jax.numpy as jnp

    from bhr_tpu.ops.sampling import pack_texture_rgba8, sample_equirect_packed

    rng = np.random.RandomState(11)
    tex = (rng.rand(8, 16, 4)).astype(np.float32)
    tex = np.round(tex * 255.0) / 255.0
    packed = jnp.asarray(pack_texture_rgba8(tex))
    # directions on the equator hit v = 0.5 (row 4); u from atan2
    d = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [-1.0, 0.0, 1e-6]], np.float32)
    r, g, b = sample_equirect_packed(
        packed, jnp.asarray(d[:, 0]), jnp.asarray(d[:, 1]), jnp.asarray(d[:, 2]),
        filter="nearest",
    )
    # u = 0.5 + atan2(dz, dx)/2pi -> 0.5, 0.75, ~1.0; texel x = floor(u*16)
    for k, x_expect in enumerate((8, 12, 15)):
        want = tex[4, x_expect, :3]
        got = np.array([r[k], g[k], b[k]])
        np.testing.assert_allclose(got, want, atol=1e-6), k


def test_luma_tier_grayscale_bit_matches_bilinear():
    """For a grayscale texture the luma tier IS exact bilinear: L equals
    every channel and chroma is zero, so the single-gather corner-packed
    luma lerp reproduces the 3-gather bilinear sampler bit-for-bit."""
    import jax
    import jax.numpy as jnp

    from bhr_tpu.ops.sampling import (
        corner_pack_texture,
        luma_pack_texture,
        pack_texture_rgba8,
        sample_equirect_packed,
        sample_equirect_packed_luma,
    )

    rng = np.random.RandomState(12)
    gray = np.round(rng.rand(16, 32, 1).astype(np.float32) * 255.0) / 255.0
    tex = np.concatenate([gray, gray, gray, np.ones_like(gray)], axis=-1)
    packed = jnp.asarray(pack_texture_rgba8(tex))
    cp = corner_pack_texture(packed)
    lp = jax.jit(luma_pack_texture)(packed)

    d = rng.randn(16, 24, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dx, dy, dz = (jnp.asarray(d[..., i]) for i in range(3))
    exact = np.stack(sample_equirect_packed(cp, dx, dy, dz), -1)
    status = jnp.zeros(d.shape[:2], jnp.int32)
    luma = np.stack(
        sample_equirect_packed_luma(lp, dx, dy, dz, status, chroma_sub=1), -1
    )
    np.testing.assert_array_equal(exact, luma)


def test_luma_tier_color_close_to_bilinear():
    """Color textures: luma exact, chroma nearest-sampled -> bounded error."""
    import jax.numpy as jnp

    from bhr_tpu.ops.sampling import (
        corner_pack_texture,
        luma_pack_texture,
        pack_texture_rgba8,
        sample_equirect_packed,
        sample_equirect_packed_luma,
    )

    rng = np.random.RandomState(5)
    # smooth color gradient + sparse bright "stars"
    yy, xx = np.meshgrid(np.linspace(0, 1, 32), np.linspace(0, 1, 64), indexing="ij")
    tex = np.stack([0.2 + 0.1 * yy, 0.2 + 0.1 * xx, 0.25 + 0 * xx, 1 + 0 * xx], -1)
    tex = np.round(tex.astype(np.float32) * 255.0) / 255.0
    packed = jnp.asarray(pack_texture_rgba8(tex))
    cp = corner_pack_texture(packed)
    lp = luma_pack_texture(packed)
    d = rng.randn(16, 24, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dx, dy, dz = (jnp.asarray(d[..., i]) for i in range(3))
    exact = np.stack(sample_equirect_packed(cp, dx, dy, dz), -1)
    status = jnp.zeros(d.shape[:2], jnp.int32)
    luma = np.stack(
        sample_equirect_packed_luma(lp, dx, dy, dz, status, chroma_sub=1), -1
    )
    # chroma is nearest (<= 1-texel positional error on a smooth gradient)
    # + 9-bit quantization; luma exact
    assert np.abs(exact - luma).max() < 0.03


def test_renderer_texture_filter_modes(small_skybox):
    from bhr_tpu import BlackHoleRenderer

    frames = {}
    for mode in ("bilinear", "nearest", "luma"):
        r = BlackHoleRenderer(24, 16, skybox=small_skybox, texture_filter=mode)
        frames[mode] = np.asarray(r.render_frame())
    assert frames["bilinear"].shape == (16, 24, 4)
    # tiers approximate each other: captured region identical (black), and
    # background within the positional/chroma-quantization bound
    diff_luma = np.abs(
        frames["bilinear"].astype(int) - frames["luma"].astype(int)
    )[..., :3]
    assert diff_luma.mean() < 8.0
    import pytest

    with pytest.raises(ValueError, match="texture_filter"):
        BlackHoleRenderer(8, 8, skybox=small_skybox, texture_filter="cubic")
    with pytest.raises(ValueError, match="removed"):
        BlackHoleRenderer(8, 8, skybox=small_skybox, texture_filter="fast")


def test_texture_subsample_corner_pixels_exact(small_skybox):
    """Corner-aligned subsample: every (sub*i, sub*j) pixel reproduces the
    full-res textured render bit-exactly (upsample phase 0 is a copy and
    the low grid takes the full-res pixel's own direction)."""
    from bhr_tpu import BlackHoleRenderer

    full = np.asarray(BlackHoleRenderer(32, 24, skybox=small_skybox).render_frame())
    for sub in (2, 3):
        r = BlackHoleRenderer(32, 24, skybox=small_skybox, texture_subsample=sub)
        f = np.asarray(r.render_frame())
        np.testing.assert_array_equal(f[::sub, ::sub], full[::sub, ::sub])


def test_texture_subsample_smooth_texture_close():
    """Flat spacetime + smooth gradient texture: the sub=2 color grid must
    track the full render to within interpolation error (a few u8 levels).
    """
    from bhr_tpu import BlackHoleRenderer

    h, w = 64, 128
    yy, xx = np.meshgrid(
        np.linspace(0.1, 0.9, h), np.linspace(0.1, 0.9, w), indexing="ij"
    )
    tex = np.stack([yy, xx, 0.5 * np.ones_like(yy)], axis=-1).astype(np.float32)
    full = np.asarray(
        BlackHoleRenderer(48, 32, model="flat", skybox=tex).render_frame()
    )
    sub = np.asarray(
        BlackHoleRenderer(
            48, 32, model="flat", skybox=tex, texture_subsample=2
        ).render_frame()
    )
    diff = np.abs(full.astype(int) - sub.astype(int))[..., :3]
    assert diff.max() <= 3, diff.max()


def test_texture_subsample_no_capture_halo(small_skybox):
    """Captured low samples are excluded from the color interpolation: the
    mean background brightness of escaped pixels must match the full
    render closely (no black bleed around the shadow)."""
    from bhr_tpu import BlackHoleRenderer
    from bhr_tpu.ops.trace import STATUS_CAPTURED

    full_r = BlackHoleRenderer(32, 24, skybox=small_skybox)
    full = np.asarray(full_r.render_frame()).astype(np.float64)
    sub = np.asarray(
        BlackHoleRenderer(
            32, 24, skybox=small_skybox, texture_subsample=2
        ).render_frame()
    ).astype(np.float64)
    # escaped-pixel mask from the black shadow of the full render
    shadow = full[..., :3].sum(-1) == 0
    esc = ~shadow
    assert abs(full[esc, :3].mean() - sub[esc, :3].mean()) < 4.0


def test_texture_subsample_validates():
    from bhr_tpu import BlackHoleRenderer

    import pytest

    with pytest.raises(ValueError, match="texture_subsample"):
        BlackHoleRenderer(8, 8, texture_subsample=0)


def test_multires_texture_subsample_runs(small_skybox):
    from bhr_tpu import Camera, SceneParams
    from bhr_tpu.ops.multires import render_multires
    from bhr_tpu.ops.sampling import corner_pack_texture

    scene = SceneParams(screen_width=36, screen_height=24, max_steps=40)
    cp = corner_pack_texture(jnp.asarray(pack_texture_rgba8(small_skybox)))
    frame = render_multires(
        Camera.default(), scene, cp, divisor=2, texture_subsample=2,
    )
    assert frame.shape == (24, 36, 4)
    assert frame[..., 3].min() == 255


def test_texture_checkerboard_sampled_pixels_exact(small_skybox):
    """Checkerboard sampling: every (i + j)-even pixel reproduces the full
    render bit-exactly; holes are finite reconstructions."""
    from bhr_tpu import BlackHoleRenderer

    full = np.asarray(BlackHoleRenderer(32, 24, skybox=small_skybox).render_frame())
    f = np.asarray(
        BlackHoleRenderer(
            32, 24, skybox=small_skybox, texture_subsample="checker"
        ).render_frame()
    )
    ii, jj = np.meshgrid(np.arange(24), np.arange(32), indexing="ij")
    sampled = ((ii + jj) % 2) == 0
    np.testing.assert_array_equal(f[sampled], full[sampled])
    # holes close to the full render (1 px reconstruction span)
    d = np.abs(full.astype(int) - f.astype(int))[..., :3]
    assert d[~sampled].mean() < 6.0


def test_texture_checkerboard_odd_dims(small_skybox):
    """Odd width/height exercise the padding in the weave."""
    from bhr_tpu import BlackHoleRenderer

    r = BlackHoleRenderer(33, 23, skybox=small_skybox, texture_subsample="checker")
    f = np.asarray(r.render_frame())
    assert f.shape == (23, 33, 4)
    assert f[..., 3].min() == 255
