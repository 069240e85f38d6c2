"""Multi-chip sharding on the virtual 8-device CPU mesh: sharded renders
must equal single-device renders (SURVEY.md §2.2 equivalents)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bhr_tpu import BlackHoleRenderer, Camera, SceneParams
from bhr_tpu.ops.sampling import pack_texture_rgba8
from bhr_tpu.ops.trace import TraceConfig
from bhr_tpu.parallel.mesh import (
    make_mesh,
    render_animation_sharded,
    render_frame_sharded,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)

SCENE = dict(screen_width=64, screen_height=32, max_steps=30)


def test_make_mesh_shapes():
    mesh = make_mesh(8)
    assert mesh.shape == {"dp": 2, "sp": 4}
    assert make_mesh(1).shape == {"dp": 1, "sp": 1}
    assert make_mesh(8, shape=(1, 8)).shape == {"dp": 1, "sp": 8}


def test_sharded_frame_equals_single_device():
    scene = SceneParams(**SCENE)
    cam = Camera.default()
    mesh = make_mesh(8, shape=(1, 8))
    sharded = np.asarray(render_frame_sharded(cam, scene, None, mesh))
    single = np.asarray(BlackHoleRenderer(64, 32).render_frame(cam, scene))
    np.testing.assert_array_equal(sharded, single)


def test_sharded_frame_with_texture_skybox(small_skybox):
    scene = SceneParams(**SCENE)
    cam = Camera.default()
    mesh = make_mesh(8, shape=(1, 8))
    packed = jnp.asarray(pack_texture_rgba8(small_skybox))
    sharded = np.asarray(render_frame_sharded(cam, scene, packed, mesh))
    single = np.asarray(
        BlackHoleRenderer(64, 32, skybox=small_skybox).render_frame(cam, scene)
    )
    np.testing.assert_array_equal(sharded, single)


def test_sharded_frame_with_corner_packed_skybox(small_skybox):
    """The corner-packed (3, H+1, W) bilinear texture (the renderer's
    default tier) replicates over the mesh like the plain (H, W) one and
    produces the identical frame."""
    from bhr_tpu.ops.sampling import corner_pack_texture

    scene = SceneParams(**SCENE)
    cam = Camera.default()
    mesh = make_mesh(8, shape=(1, 8))
    cp = corner_pack_texture(jnp.asarray(pack_texture_rgba8(small_skybox)))
    sharded = np.asarray(render_frame_sharded(cam, scene, cp, mesh))
    single = np.asarray(
        BlackHoleRenderer(64, 32, skybox=small_skybox).render_frame(cam, scene)
    )
    np.testing.assert_array_equal(sharded, single)
    # the interleaved corner-rows layout (the renderer's default bilinear
    # tier since round 3) replicates the same way
    from bhr_tpu.ops.sampling import corner_pack_texture_rows

    cr = corner_pack_texture_rows(jnp.asarray(pack_texture_rgba8(small_skybox)))
    sharded_rows = np.asarray(render_frame_sharded(cam, scene, cr, mesh))
    np.testing.assert_array_equal(sharded_rows, single)


def test_sharded_animation_dp_x_sp():
    scene = SceneParams(**SCENE)
    mesh = make_mesh(8)  # (2, 4)
    times = jnp.arange(4, dtype=jnp.float32) / 60.0
    frames, lums = render_animation_sharded(times, scene, None, mesh)
    assert frames.shape == (4, 32, 64, 4)
    assert lums.shape == (4,)
    # frame content matches the single-device animator
    from bhr_tpu.animation import OrbitAnimator

    r = BlackHoleRenderer(64, 32)
    ref = np.asarray(OrbitAnimator(r).render_frames(4, fps=60.0, scene=scene))
    np.testing.assert_array_equal(np.asarray(frames), ref)
    # luminance telemetry: psum-mean of the G channel over the full frame
    g_mean = ref[..., 1].astype(np.float32).mean(axis=(1, 2))
    np.testing.assert_allclose(np.asarray(lums), g_mean, rtol=1e-5)


def test_non_divisible_height_pads_bands():
    """Heights that don't divide over sp render via padded bands and still
    equal the single-device frame (e.g. 1080 on a 16-way sp mesh)."""
    for h in (33, 30):  # 33 % 8 = 1, 30 % 8 = 6
        scene = SceneParams(screen_width=64, screen_height=h, max_steps=20)
        cam = Camera.default()
        mesh = make_mesh(8, shape=(1, 8))
        sharded = np.asarray(render_frame_sharded(cam, scene, None, mesh))
        single = np.asarray(BlackHoleRenderer(64, h).render_frame(cam, scene))
        assert sharded.shape == (h, 64, 4)
        np.testing.assert_array_equal(sharded, single)


def test_sharded_programs_are_cached():
    """Repeat calls with the same mesh/config must reuse the jitted program
    (zero rebuilding — the retrace-per-call regression)."""
    from bhr_tpu.parallel.mesh import _animation_program, _frame_program

    scene = SceneParams(**SCENE)
    cam = Camera.default()
    mesh = make_mesh(8, shape=(1, 8))
    _frame_program.cache_clear()
    render_frame_sharded(cam, scene, None, mesh)
    before = _frame_program.cache_info()
    render_frame_sharded(cam, scene, None, mesh)
    after = _frame_program.cache_info()
    assert after.hits == before.hits + 1 and after.misses == before.misses

    times = jnp.arange(2, dtype=jnp.float32) / 60.0
    _animation_program.cache_clear()
    render_animation_sharded(times, scene, None, make_mesh(8))
    before = _animation_program.cache_info()
    render_animation_sharded(times, scene, None, make_mesh(8))
    after = _animation_program.cache_info()
    assert after.hits == before.hits + 1 and after.misses == before.misses


def test_sharded_seed_matches_single_device():
    scene = SceneParams(**SCENE)
    cam = Camera.default()
    mesh = make_mesh(8, shape=(1, 8))
    sharded = np.asarray(render_frame_sharded(cam, scene, None, mesh, seed=7))
    single = np.asarray(
        BlackHoleRenderer(64, 32, skybox_seed=7).render_frame(cam, scene)
    )
    np.testing.assert_array_equal(sharded, single)


def test_padded_height_luminance_exact():
    """Telemetry mean must exclude band-padding rows (non-dividing heights)."""
    scene = SceneParams(screen_width=64, screen_height=30, max_steps=20)
    mesh = make_mesh(8)  # (2, 4): band_h = 8, so 2 padded rows per frame
    times = jnp.arange(2, dtype=jnp.float32) / 60.0
    frames, lums = render_animation_sharded(times, scene, None, mesh)
    g_mean = np.asarray(frames)[..., 1].astype(np.float32).mean(axis=(1, 2))
    np.testing.assert_allclose(np.asarray(lums), g_mean, rtol=1e-5)


def test_sharded_luma_tier_close_to_single(small_skybox):
    """The luma texture tier renders per band (chroma subsample grid
    anchors at each band's first row), so sharded frames match the
    single-device render up to sub-chroma differences — luma is exact
    either way."""
    from bhr_tpu.ops.sampling import luma_pack_texture, pack_texture_rgba8

    scene = SceneParams(screen_width=64, screen_height=32, max_steps=30)
    cam = Camera.default()
    mesh = make_mesh(8, shape=(1, 8))
    lp = luma_pack_texture(jnp.asarray(pack_texture_rgba8(small_skybox)))
    sharded = np.asarray(
        render_frame_sharded(cam, scene, lp, mesh, texture_filter="luma")
    ).astype(int)
    single = np.asarray(
        BlackHoleRenderer(64, 32, skybox=small_skybox, texture_filter="luma")
        .render_frame(cam, scene)
    ).astype(int)
    d = np.abs(sharded - single)[..., :3]
    assert d.max() <= 12, d.max()  # chroma-phase only
    assert (d > 0).mean() < 0.35


def test_sharded_neural_equals_single_device():
    """Phase-5 surrogate over the mesh: band-sharded MLP deflection +
    shading must match the single-device neural render bit-exactly (the
    matmul batch is identical per row; only the batch slicing differs)."""
    import pathlib

    weights = (
        pathlib.Path(__file__).resolve().parent.parent
        / "bhr_tpu" / "assets" / "neural_schwarzschild.npz"
    )
    if not weights.exists():
        pytest.skip("production weights not trained yet")
    from bhr_tpu.models.neural import load_params

    # uncommitted weights: the renderer device_puts its copy to device 0,
    # which an 8-device shard_map would reject as an incompatible commit
    params, _ = load_params(str(weights))
    scene = SceneParams(screen_width=64, screen_height=48, max_steps=500)
    cam = Camera.default()
    r = BlackHoleRenderer(64, 48, integrator="neural", neural_params=params)
    single = np.asarray(r.render_frame(cam, scene))
    mesh = make_mesh(8, shape=(1, 8))
    sharded = np.asarray(
        render_frame_sharded(
            cam, scene, None, mesh,
            config=r.config, neural_params=params,
        )
    )
    np.testing.assert_array_equal(sharded, single)
    # animation path (dp x sp) with luminance telemetry
    mesh2 = make_mesh(8)  # (2, 4)
    times = jnp.arange(2, dtype=jnp.float32) / 30.0
    frames, lums = render_animation_sharded(
        times, scene, None, mesh2,
        config=r.config, neural_params=params,
    )
    assert np.asarray(frames).shape == (2, 48, 64, 4)
    assert np.all(np.isfinite(np.asarray(lums)))


def test_sharded_multires_equals_single_device():
    """Multires over the mesh (VERDICT r3 item 7): band-sharded low pass
    (+ 2-row halo with border clamping) + edge fix-up must be
    pixel-identical to the single-device render_multires."""
    from bhr_tpu.ops.multires import render_multires

    cam = Camera.default()
    mesh = make_mesh(8, shape=(1, 8))
    for h, divisor in ((48, 3), (48, 2), (33, 3)):  # 33: padded bands
        scene = SceneParams(screen_width=64, screen_height=h, max_steps=30)
        single = np.asarray(
            render_multires(cam, scene, divisor=divisor)
        )
        sharded = np.asarray(
            render_frame_sharded(
                cam, scene, None, mesh, multires=divisor
            )
        )
        np.testing.assert_array_equal(sharded, single, err_msg=f"h={h} d={divisor}")


def test_sharded_multires_disk_and_texture(small_skybox):
    """Disk emission (interpolated hit planes) and the exact bilinear
    texture tier compose with sharded multires, still pixel-identical."""
    from bhr_tpu.models.disk import DiskParams
    from bhr_tpu.ops.multires import render_multires
    from bhr_tpu.ops.sampling import corner_pack_texture_rows

    cam = Camera.default()
    mesh = make_mesh(8, shape=(1, 8))
    scene = SceneParams(screen_width=64, screen_height=32, max_steps=30)
    cfg = TraceConfig(disk=True)
    dp = DiskParams.for_scene(scene.schwarzschild_radius)
    single = np.asarray(
        render_multires(cam, scene, None, dp, config=cfg, divisor=2)
    )
    sharded = np.asarray(
        render_frame_sharded(
            cam, scene, None, mesh, config=cfg, disk_params=dp, multires=2,
        )
    )
    np.testing.assert_array_equal(sharded, single)

    tex = corner_pack_texture_rows(jnp.asarray(pack_texture_rgba8(small_skybox)))
    single = np.asarray(
        render_multires(cam, scene, tex, divisor=2, texture_filter="bilinear")
    )
    sharded = np.asarray(
        render_frame_sharded(
            cam, scene, tex, mesh, multires=2, texture_filter="bilinear",
        )
    )
    np.testing.assert_array_equal(sharded, single)


def test_sharded_multires_animation():
    """dp x sp multires animation: frames match the single-device multires
    frames and the luminance telemetry stays exact over padded bands."""
    from bhr_tpu.core.camera import orbit_camera
    from bhr_tpu.ops.multires import render_multires

    scene = SceneParams(screen_width=64, screen_height=30, max_steps=20)
    mesh = make_mesh(8)  # (2, 4)
    times = jnp.arange(2, dtype=jnp.float32) / 60.0
    frames, lums = render_animation_sharded(
        times, scene, None, mesh, multires=2
    )
    frames = np.asarray(frames)
    for i, t in enumerate(np.asarray(times)):
        single = np.asarray(
            render_multires(orbit_camera(float(t)), scene, divisor=2)
        )
        np.testing.assert_array_equal(frames[i], single)
    g_mean = frames[..., 1].astype(np.float32).mean(axis=(1, 2))
    np.testing.assert_allclose(np.asarray(lums), g_mean, rtol=1e-5)


def test_sharded_multires_rejects_neural_and_tonemap():
    scene = SceneParams(**SCENE)
    cam = Camera.default()
    mesh = make_mesh(8, shape=(1, 8))
    with pytest.raises(ValueError, match="multires"):
        render_frame_sharded(cam, scene, None, mesh, multires=2, tonemap="reinhard")
