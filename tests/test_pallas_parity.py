"""Pallas-Triton kernel vs XLA oracle parity (the golden-image strategy from
SURVEY.md §4 — the oracle transcribes wgsl:51-215 exactly, and the kernel
must reproduce it). The kernel runs in the Pallas interpreter here; on a
GPU it is compiled (`kernel_mode`), which the lowering tests below pin."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bhr_tpu.core.camera import Camera, generate_rays
from bhr_tpu.core.scene import SceneParams
from bhr_tpu.ops import pallas_trace as pt
from bhr_tpu.ops.pallas_trace import kernel_mode, pallas_trace_image
from bhr_tpu.ops.trace import TraceConfig, trace_rays

W, H, STEPS = 48, 32, 120
# a scene that captures AND escapes rays within its step budget
FAR_CAM = Camera.new([0.0, 2.0, 30.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])


def _scene(**kw):
    return SceneParams(screen_width=W, screen_height=H, max_steps=STEPS, **kw)


def _oracle(camera, scene, config):
    origins, dirs = generate_rays(
        camera, scene.screen_width, scene.screen_height, scene.fov
    )
    return trace_rays(
        origins,
        dirs,
        scene.black_hole_position,
        scene.schwarzschild_radius,
        scene.spin,
        scene.max_steps,
        config,
    )


def _assert_match(res_p, res_o):
    """Strict equality — for kernel-vs-kernel invariance checks."""
    np.testing.assert_array_equal(np.asarray(res_p.status), np.asarray(res_o.status))
    np.testing.assert_array_equal(np.asarray(res_p.steps), np.asarray(res_o.steps))
    np.testing.assert_array_equal(
        np.asarray(res_p.final_vel), np.asarray(res_o.final_vel)
    )
    np.testing.assert_array_equal(
        np.asarray(res_p.final_pos), np.asarray(res_o.final_pos)
    )


def _assert_match_chaotic(res_p, res_o, frac=0.995, vel_atol=1e-4):
    """Kernel vs oracle: two separately compiled programs differ by
    ~1 ulp in ray-gen (FMA contraction choices), and the geodesic flow near
    the photon sphere is chaotic — a 1e-7 direction difference can amplify
    to O(1) over a hundred steps for boundary pixels. Require agreement on
    >= `frac` of pixels and velocity closeness wherever the trajectories
    stayed matched (SURVEY.md §7 "hard parts": fp divergence near the
    photon sphere)."""
    sp, so = np.asarray(res_p.status), np.asarray(res_o.status)
    stp, sto = np.asarray(res_p.steps), np.asarray(res_o.steps)
    same = (sp == so) & (stp == sto)
    assert same.mean() >= frac, f"status/steps agree on only {same.mean():.4f}"
    m = same & (so != 2)  # captured rays' final vel is never consumed
    vd = np.abs(np.asarray(res_p.final_vel) - np.asarray(res_o.final_vel)).max(-1)
    ok = vd[m] <= vel_atol
    assert ok.mean() >= frac, f"vel close on only {ok.mean():.4f} (max {vd[m].max()})"


@pytest.mark.parametrize(
    "config",
    [
        TraceConfig(),
        TraceConfig(integrator="rk4"),
        TraceConfig(adaptive=True),
        TraceConfig(model="kerr"),
        TraceConfig(model="flat"),
        TraceConfig(disk=True),
        TraceConfig(integrator="rk4", adaptive=True, disk=True, model="kerr"),
    ],
    ids=["euler", "rk4", "adaptive", "kerr", "flat", "disk", "kerr-rk4-disk"],
)
def test_kernel_matches_oracle(config):
    cam = Camera.default()
    scene = _scene(spin=jnp.float32(0.9 if config.model == "kerr" else 0.0))
    res_p = pallas_trace_image(cam, scene, config)
    res_o = _oracle(cam, scene, config)
    _assert_match_chaotic(res_p, res_o)


@pytest.mark.parametrize("integrator", ["euler", "rk4", "leapfrog"])
@pytest.mark.parametrize("model", ["schwarzschild", "kerr", "kerr_lt", "flat"])
def test_kernel_matches_oracle_capture_escape(model, integrator):
    """Every model x integrator on a scene whose rays both escape the
    r=100 sphere and fall through the capture radius."""
    spin = 0.9 if model.startswith("kerr") else 0.0
    scene = SceneParams(screen_width=64, screen_height=48, max_steps=600,
                        spin=jnp.float32(spin))
    cfg = TraceConfig(model=model, integrator=integrator, dt=0.3)
    res_p = pallas_trace_image(FAR_CAM, scene, cfg)
    res_o = _oracle(FAR_CAM, scene, cfg)
    status = np.asarray(res_o.status)
    assert (status == 1).any()
    if model != "flat":
        assert (status == 2).any()
    _assert_match_chaotic(res_p, res_o, vel_atol=5e-4)


def test_kernel_matches_oracle_raygen_exact():
    """max_steps=0: the loop never runs, so the comparison isolates in-kernel
    ray generation against generate_rays — agreement to fp ulps."""
    cam = Camera.default()
    scene = _scene().replace(max_steps=0)
    res_p = pallas_trace_image(cam, scene, TraceConfig())
    res_o = _oracle(cam, scene, TraceConfig())
    np.testing.assert_allclose(
        np.asarray(res_p.final_vel), np.asarray(res_o.final_vel), atol=3e-7
    )
    np.testing.assert_array_equal(np.asarray(res_p.status), np.asarray(res_o.status))


def test_kernel_matches_oracle_weak_field_tight():
    """Weak lensing (small r_s), short integration: no chaotic boundary, so
    kernel and oracle agree tightly everywhere."""
    cam = Camera.default()
    scene = _scene(schwarzschild_radius=jnp.float32(0.25)).replace(max_steps=60)
    res_p = pallas_trace_image(cam, scene, TraceConfig())
    res_o = _oracle(cam, scene, TraceConfig())
    np.testing.assert_array_equal(np.asarray(res_p.status), np.asarray(res_o.status))
    np.testing.assert_array_equal(np.asarray(res_p.steps), np.asarray(res_o.steps))
    np.testing.assert_allclose(
        np.asarray(res_p.final_vel), np.asarray(res_o.final_vel), atol=1e-5
    )


def test_odd_image_sizes_pad_and_slice_correctly():
    """Pixel counts that are not a block multiple exercise the padded tail
    block (its padding rays start finished and are sliced off)."""
    cam = Camera.default()
    for (w, h) in ((37, 23), (130, 9), (127, 16)):
        scene = SceneParams(screen_width=w, screen_height=h, max_steps=50)
        res_p = pallas_trace_image(cam, scene, TraceConfig())
        res_o = _oracle(cam, scene, TraceConfig())
        assert res_p.status.shape == (h, w)
        _assert_match_chaotic(res_p, res_o, frac=0.99)


@pytest.mark.parametrize("block", [32, 64, 512])
def test_early_exit_frequency_invariance(monkeypatch, block):
    """Each block leaves its loop when its own rays are done; masked
    updates make the results identical at any early-exit granularity."""
    scene = SceneParams(screen_width=48, screen_height=32, max_steps=600)
    cfg = TraceConfig(dt=0.3)
    ref = pallas_trace_image(FAR_CAM, scene, cfg)
    monkeypatch.setattr(pt, "DEFAULT_BLOCK", block)
    got = pallas_trace_image(FAR_CAM, scene, cfg)
    _assert_match(got, ref)


def test_tile_shape_invariance(monkeypatch):
    """Rays per block and warps per block change the schedule only."""
    cam = Camera.default()
    scene = _scene()
    cfg = TraceConfig(disk=True)
    ref = pallas_trace_image(cam, scene, cfg)
    monkeypatch.setattr(pt, "DEFAULT_BLOCK", 256)
    monkeypatch.setattr(pt, "DEFAULT_NUM_WARPS", 8)
    got = pallas_trace_image(cam, scene, cfg)
    _assert_match(got, ref)


def test_row_band_offsets_match_full_image():
    """Band rendering (multi-device sp sharding) == rows of the full image."""
    cam = Camera.default()
    scene = _scene()
    cfg = TraceConfig()
    full = pallas_trace_image(cam, scene, cfg)
    band = pallas_trace_image(cam, scene, cfg, row0=16, local_shape=(8, W))
    np.testing.assert_array_equal(
        np.asarray(full.status)[16:24], np.asarray(band.status)
    )
    np.testing.assert_array_equal(
        np.asarray(full.final_vel)[16:24], np.asarray(band.final_vel)
    )


@pytest.mark.parametrize("stride", [2, 3])
def test_stride_traces_full_image_subgrid(stride):
    """stride > 1 (multires low pass): local pixel (i, j) is full-image
    pixel (i*stride, j*stride) — same rays, same results."""
    scene = SceneParams(screen_width=48, screen_height=30, max_steps=300)
    cfg = TraceConfig(dt=0.3)
    full = pallas_trace_image(FAR_CAM, scene, cfg)
    lh, lw = -(-30 // stride), -(-48 // stride)
    low = pallas_trace_image(FAR_CAM, scene, cfg, local_shape=(lh, lw),
                             stride=stride)
    np.testing.assert_array_equal(
        np.asarray(low.status), np.asarray(full.status)[::stride, ::stride]
    )
    np.testing.assert_allclose(
        np.asarray(low.final_vel),
        np.asarray(full.final_vel)[::stride, ::stride], atol=1e-6,
    )


def test_mask_traces_only_masked_rays():
    """mask (multires fix-up): kept rays equal the full render, dropped
    rays are never integrated (0 steps)."""
    scene = SceneParams(screen_width=48, screen_height=32, max_steps=600)
    cfg = TraceConfig(dt=0.3, disk=True)
    full = pallas_trace_image(FAR_CAM, scene, cfg)
    mask = np.zeros((32, 48), np.float32)
    mask[8:20, 10:30] = 1.0
    got = pallas_trace_image(FAR_CAM, scene, cfg, mask=jnp.asarray(mask))
    keep = mask > 0
    for a, b in ((got.status, full.status), (got.steps, full.steps)):
        np.testing.assert_array_equal(np.asarray(a)[keep], np.asarray(b)[keep])
    np.testing.assert_allclose(
        np.asarray(got.final_vel)[keep], np.asarray(full.final_vel)[keep],
        atol=1e-6,
    )
    assert (np.asarray(got.steps)[~keep] == 0).all()


def test_all_masked_blocks_never_enter_the_loop():
    scene = SceneParams(screen_width=48, screen_height=32, max_steps=600)
    res = pallas_trace_image(FAR_CAM, scene, TraceConfig(),
                             mask=jnp.zeros((32, 48), jnp.float32))
    assert (np.asarray(res.steps) == 0).all()
    assert (np.asarray(res.status) == 1).all()


@pytest.mark.parametrize(
    "config",
    [TraceConfig(dt=0.3), TraceConfig(dt=0.3, disk=True, adaptive=True),
     TraceConfig(dt=0.3, model="kerr")],
    ids=["euler", "disk-adaptive", "kerr"],
)
def test_heatmap_steps_match_oracle(config):
    """Per-ray step counts (the debug heatmap) follow the oracle's
    semantics: steps = the iterations a ray spent running."""
    scene = SceneParams(screen_width=48, screen_height=32, max_steps=600,
                        spin=jnp.float32(0.9 if config.model == "kerr" else 0.0))
    res_p = pallas_trace_image(FAR_CAM, scene, config)
    res_o = _oracle(FAR_CAM, scene, config)
    sp, so = np.asarray(res_p.steps), np.asarray(res_o.steps)
    assert (sp == so).mean() >= 0.995
    assert len(np.unique(so)) > 10  # the scene spreads the step counts


def test_linear_raygen_matches_tiled(monkeypatch):
    """Flat-pixel-id ray-gen (y = id // W, x = id % W) must decode the same
    (y, x) as generate_rays' 2-D grid for widths that are not a power of
    two and for frames wider than a block."""
    cam = Camera.default()
    for (w, h) in ((48, 32), (130, 9), (200, 60)):
        scene = SceneParams(screen_width=w, screen_height=h, max_steps=0)
        monkeypatch.setattr(pt, "DEFAULT_BLOCK", 64)
        a = pallas_trace_image(cam, scene, TraceConfig())
        b = _oracle(cam, scene, TraceConfig())
        np.testing.assert_allclose(
            np.asarray(a.final_vel), np.asarray(b.final_vel), atol=3e-7
        )


def test_linear_raygen_monolithic_shape():
    """Every output plane comes back at the image shape and dtype."""
    cam = Camera.default()
    scene = SceneParams(screen_width=75, screen_height=33, max_steps=40)
    res = pallas_trace_image(cam, scene, TraceConfig(disk=True))
    assert res.final_pos.shape == res.final_vel.shape == (33, 75, 3)
    assert res.status.shape == res.steps.shape == (33, 75)
    assert res.status.dtype == res.steps.dtype == jnp.int32
    assert np.isfinite(np.asarray(res.final_vel)).all()


def test_kerr_disk_direction_evaluated_at_hit_point():
    """The Kerr kernel evaluates the disk-hit shading direction with the
    metric at the hit point, like the oracle's final_direction."""
    cam = Camera.new([15.0, 5.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    scene = SceneParams(screen_width=96, screen_height=54, max_steps=300,
                        spin=jnp.float32(0.9))
    cfg = TraceConfig(model="kerr", disk=True)
    res_p = pallas_trace_image(cam, scene, cfg)
    res_o = _oracle(cam, scene, cfg)
    so, sp = np.asarray(res_o.status), np.asarray(res_p.status)
    m = (so == sp) & (so == 3)
    assert m.sum() > 500  # the scene hits the disk broadly
    vd = np.abs(np.asarray(res_o.final_vel)[m] - np.asarray(res_p.final_vel)[m])
    assert np.median(vd) < 1e-5
    assert (vd.max(-1) < 1e-4).mean() >= 0.995, f"disk-hit directions diverge: {vd.max()}"


@pytest.mark.parametrize(
    "platform, mode",
    [("gpu", "compiled"), ("cpu", "interpret"), ("rocm", None), ("METAL", None)],
)
def test_kernel_mode_platforms(platform, mode):
    """The one platform decision: compiled on a GPU, interpreted on the
    CPU, and an error anywhere else (no silent fallback)."""
    if mode is None:
        with pytest.raises(RuntimeError, match="no kernel route"):
            kernel_mode(platform)
    else:
        assert kernel_mode(platform) == mode


def _lowered(platform, variant="plain", config=TraceConfig(disk=True)):
    """StableHLO text of pallas_trace_image lowered for `platform` here on
    the CPU host (no GPU needed to lower for CUDA)."""
    scene = _scene()
    kw = {}
    if variant == "masked":
        kw["mask"] = jnp.ones((H, W), jnp.float32)
    elif variant == "strided-band":
        kw.update(stride=3, row0=6, local_shape=(4, 16))
    fn = lambda c: pallas_trace_image(c, scene, config, **kw)
    lowered = jax.jit(fn).trace(Camera.default()).lower(lowering_platforms=(platform,))
    return lowered.as_text()


@pytest.mark.parametrize("variant", ["plain", "masked", "strided-band"])
def test_gpu_path_compiles_and_never_interprets(variant):
    """Lowered for the GPU, the geodesic kernel is one compiled Triton call
    and nothing of the interpreter (whose kernel loop would lower to a
    stablehlo.while): interpret=True is unreachable on the GPU path."""
    text = _lowered("cuda", variant)
    assert "xla.gpu.triton" in text
    assert 'name = "geodesic_trace"' in text
    assert "stablehlo.while" not in text


@pytest.mark.parametrize("variant", ["plain", "masked"])
def test_cpu_path_interprets(variant):
    """Lowered for the CPU, the same call is the interpreter's loop and no
    Triton call: the platform the call runs on decides, not the process's
    default backend."""
    text = _lowered("cpu", variant)
    assert "xla.gpu.triton" not in text
    assert "stablehlo.while" in text


def test_unsupported_platform_fails_to_lower():
    with pytest.raises(Exception, match="rocm"):
        _lowered("rocm")


@pytest.mark.parametrize("model", ["schwarzschild", "kerr_lt"])
def test_fast_math_selects_the_rsqrt_renormalization(model):
    """fast_math changes the kernel: only its tier renormalizes with rsqrt
    (the exact tier uses sqrt and divides)."""
    exact = _lowered("cpu", config=TraceConfig(model=model))
    fast = _lowered("cpu", config=TraceConfig(model=model, fast_math=True))
    assert "stablehlo.rsqrt" not in exact
    assert "stablehlo.rsqrt" in fast


@pytest.mark.parametrize(
    "config",
    [TraceConfig(fast_math=True),
     TraceConfig(integrator="rk4", adaptive=True, disk=True, fast_math=True)],
    ids=["euler", "rk4-adaptive-disk"],
)
def test_fast_math_kernel_matches_oracle(config):
    """The approximate tier keeps the kernel-vs-oracle contract (the oracle
    is exact whatever the config's tier)."""
    cam = Camera.default()
    res_p = pallas_trace_image(cam, _scene(), config)
    res_o = _oracle(cam, _scene(), config)
    _assert_match_chaotic(res_p, res_o)
