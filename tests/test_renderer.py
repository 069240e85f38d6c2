"""Renderer API surface (reference lib.rs:317-703 + notebook call shapes,
SURVEY.md §3.5 stale-API reconciliation)."""

import os

import numpy as np
import pytest

from bhr_tpu import (
    BlackHoleRenderer,
    Camera,
    GpuContext,
    SceneParams,
    TimestampQuery,
    TpuContext,
    block_on,
)


@pytest.fixture(scope="module")
def renderer():
    return BlackHoleRenderer(48, 32)


def test_reference_constructor_shapes():
    # 3-arg new(w, h, shader_path) — current reference API (lib.rs:339)
    r = BlackHoleRenderer.new(32, 24, "src/ray_tracer_euler.wgsl")
    assert r.config.integrator == "euler"
    # 2-arg notebook-era API (README.md:109, SURVEY.md §3.5) — defaulted
    ctx = block_on(GpuContext.new())
    r2 = BlackHoleRenderer.new_with_context(ctx, 32, 24)
    assert (r2.width, r2.height) == (32, 24)
    assert r2.context is ctx


def test_shader_path_maps_to_integrator_axis():
    assert BlackHoleRenderer.new(8, 8, "shaders/ray_tracer_rk4.wgsl").config.integrator == "rk4"
    r = BlackHoleRenderer.new(8, 8, "kerr_rk4")
    assert (r.config.integrator, r.config.model) == ("rk4", "kerr")


def test_default_camera_and_scene(renderer):
    # defaults mirror lib.rs:354-370
    np.testing.assert_allclose(np.asarray(renderer.camera.position), [0, 5, 15])
    assert float(renderer.scene.schwarzschild_radius) == 2.0
    assert renderer.scene.max_steps == 500
    np.testing.assert_allclose(float(renderer.scene.fov), np.pi / 3, rtol=1e-6)


def test_render_frame_shape_dtype(renderer):
    scene = SceneParams(screen_width=48, screen_height=32, max_steps=50)
    frame = renderer.render_frame(scene=scene)
    assert frame.shape == (32, 48, 4)
    assert str(frame.dtype) == "uint8"
    # alpha channel is 255 everywhere (wgsl:214 writes 1.0)
    assert np.asarray(frame)[..., 3].min() == 255


def test_timestamp_query(renderer):
    q = TimestampQuery()
    scene = SceneParams(screen_width=48, screen_height=32, max_steps=50)
    renderer.render_frame(scene=scene, timestamp_query=q)
    assert q.gpu_time_ms is not None and q.gpu_time_ms > 0


def test_get_image_data(renderer):
    scene = SceneParams(screen_width=48, screen_height=32, max_steps=50)
    renderer.render_frame(scene=scene)
    data = renderer.get_image_data()
    assert data.shape == (32, 48, 4) and data.dtype == np.uint8


def test_save_image_png_jpeg(tmp_path, renderer):
    scene = SceneParams(screen_width=48, screen_height=32, max_steps=50)
    renderer.render_frame(scene=scene)
    from PIL import Image

    for ext in ("png", "jpg"):
        p = str(tmp_path / f"out.{ext}")
        renderer.save_image(p)
        img = Image.open(p)
        assert img.size == (48, 32)
    # png round-trips exactly
    rt = np.asarray(Image.open(str(tmp_path / "out.png")).convert("RGBA"))
    np.testing.assert_array_equal(rt, renderer.get_image_data())


def test_output_texture_view_renders_lazily():
    r = BlackHoleRenderer(16, 8)
    r.scene = r.scene.replace(max_steps=20)
    view = r.output_texture_view
    assert view.shape == (8, 16, 4)


def test_debug_mode_produces_heatmap():
    r = BlackHoleRenderer(32, 16)
    scene = SceneParams(screen_width=32, screen_height=16, max_steps=40, debug_mode=1)
    frame = np.asarray(r.render_frame(scene=scene))
    # the heatmap never produces pure black or gray — it is saturated
    rgb = frame[..., :3].astype(int)
    assert (rgb.max(axis=-1) > 200).all()


def test_block_on_passthrough_and_awaitable():
    assert block_on(42) == 42

    async def coro():
        return "ok"

    assert block_on(coro()) == "ok"


def test_context_alias_and_device():
    assert GpuContext is TpuContext
    ctx = TpuContext.new()
    assert ctx.platform in ("cpu", "gpu")
    r = BlackHoleRenderer(8, 8, context=ctx)
    assert r.device is ctx.device
    assert r.queue is ctx.device  # parity accessor (lib.rs:605-607)


def test_scene_size_mismatch_corrected():
    r = BlackHoleRenderer(16, 8)
    wrong = SceneParams(screen_width=999, screen_height=7, max_steps=10)
    frame = r.render_frame(scene=wrong)
    assert frame.shape == (8, 16, 4)


def test_disk_fast_path_rejects_camera_outside_escape_sphere():
    """A camera outside the escape sphere is no degenerate placement for the
    GPU kernel (its rays carry their status; no position sentinel): every
    ray escapes at its first step, exactly as in the XLA oracle."""
    from bhr_tpu import Camera

    far = Camera.new([0.0, 160.0, 0.1], [0.0, 0.0, 0.0], [0.0, 0.0, -1.0])
    kernel = BlackHoleRenderer(16, 8, disk=True, use_pallas=True)
    oracle = BlackHoleRenderer(16, 8, disk=True, use_pallas=False)
    np.testing.assert_array_equal(
        np.asarray(kernel.render_frame(far)), np.asarray(oracle.render_frame(far))
    )
    # a normal camera still renders
    frame = kernel.render_frame()
    assert frame.shape == (8, 16, 4)


def test_deflection_cache_traces_once_and_matches(small_skybox):
    """Static-camera deflection caching (roadmap Phase 4-4): repeated
    renders at one camera re-run only the shading epilogue; frames are
    bit-identical to the uncached staged render; moving the camera
    retraces."""
    import bhr_tpu.renderer as R
    from bhr_tpu.core.camera import orbit_camera

    calls = {"n": 0}
    orig = R.trace_rays

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    R.trace_rays = counting
    try:
        scene = SceneParams(screen_width=32, screen_height=24, max_steps=30)
        cam = Camera.default()
        r = BlackHoleRenderer(32, 24, skybox=small_skybox, cache_deflection=True)
        f1 = np.asarray(r.render_frame(cam, scene))
        f2 = np.asarray(r.render_frame(cam, scene))
        assert calls["n"] == 1
        np.testing.assert_array_equal(f1, f2)
        r.render_frame(orbit_camera(1.0), scene)
        assert calls["n"] == 2
    finally:
        R.trace_rays = orig
    plain = BlackHoleRenderer(32, 24, skybox=small_skybox)
    np.testing.assert_array_equal(
        f1, np.asarray(plain.render_frame(cam, scene))
    )


class _FakeDevice:
    def __init__(self, platform):
        self.platform = platform


@pytest.mark.parametrize(
    "platform, use_pallas",
    [("gpu", True), ("cpu", False), ("rocm", None)],
)
def test_renderer_kernel_choice_follows_the_platform(platform, use_pallas):
    """The renderer's default path comes from kernel_mode alone: the
    compiled kernel on a GPU, the XLA oracle on the CPU, an error on a
    platform without a kernel route. An explicit use_pallas=False (the
    app's --oracle) stays the user's choice everywhere."""
    from bhr_tpu.renderer import TpuContext

    ctx = TpuContext(_FakeDevice(platform))
    if use_pallas is None:
        with pytest.raises(RuntimeError, match="no kernel route"):
            BlackHoleRenderer(16, 8, context=ctx)
        return
    assert BlackHoleRenderer(16, 8, context=ctx).use_pallas is use_pallas
    assert BlackHoleRenderer(16, 8, context=ctx, use_pallas=False).use_pallas is False
