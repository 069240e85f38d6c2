"""Multi-resolution rendering (reference ROADMAP Phase 4-1 analog)."""

import jax.numpy as jnp
import numpy as np
import pytest

from bhr_tpu.core.camera import Camera
from bhr_tpu.core.scene import SceneParams
from bhr_tpu.ops.multires import (
    deflection_edges,
    render_multires,
    upsample_bilinear,
)
from bhr_tpu.ops.pallas_trace import pallas_trace_image
from bhr_tpu.ops.trace import TraceConfig
from bhr_tpu.renderer import render_image


def _scene(w=96, h=64, steps=200):
    return SceneParams(screen_width=w, screen_height=h, max_steps=steps)


def test_upsample_bilinear_reproduces_linear_field():
    """Bilinear upsampling of samples of a linear function is exact (up to
    edge clamp, which only touches the outer border phases)."""
    lh, lw, d = 8, 12, 3
    y, x = np.mgrid[0:lh, 0:lw].astype(np.float32)
    plane = 2.0 * x - 3.0 * y + 1.0
    up = np.asarray(upsample_bilinear(jnp.asarray(plane), d, (lh * d, lw * d)))
    yy, xx = np.mgrid[0 : lh * d, 0 : lw * d].astype(np.float32)
    # CORNER-aligned: low pixel j holds full pixel j*d (the strided low
    # pass), so full pixel j samples the low grid at j/d
    want = 2.0 * (xx / d) - 3.0 * (yy / d) + 1.0
    interior = np.s_[: lh * d - d, : lw * d - d]  # clamp touches the far edge
    np.testing.assert_allclose(up[interior], want[interior], atol=1e-4)
    # phase 0 copies the low sample bit-exactly
    np.testing.assert_array_equal(up[::d, ::d], plane)


def test_masked_trace_freezes_skipped_rays_and_matches_kept():
    """mask=0 rays start finished (ESCAPED, 0 steps); mask=1 rays are
    bit-identical to the unmasked render."""
    cam = Camera.default()
    scene = _scene(64, 32, 120)
    cfg = TraceConfig()
    full = pallas_trace_image(cam, scene, cfg)
    mask = np.zeros((32, 64), np.float32)
    mask[8:24, :] = 1.0
    got = pallas_trace_image(cam, scene, cfg, mask=jnp.asarray(mask))
    kept = mask > 0
    np.testing.assert_array_equal(
        np.asarray(got.status)[kept], np.asarray(full.status)[kept]
    )
    np.testing.assert_array_equal(
        np.asarray(got.final_vel)[kept], np.asarray(full.final_vel)[kept]
    )
    # skipped rays never entered the loop: status ESCAPED, 0 steps
    assert (np.asarray(got.status)[~kept] == 1).all()
    assert (np.asarray(got.steps)[~kept] == 0).all()


def test_edge_mask_covers_shadow_boundary():
    """Every pixel where the coarse status field changes between neighbors
    must be flagged (plus dilation)."""
    cam = Camera.default()
    scene = _scene(48, 32, 200)
    low = pallas_trace_image(cam, scene, TraceConfig())
    st = np.asarray(low.status)
    assert (st == 2).any(), "scene must contain a shadow"
    vel = np.asarray(low.final_vel)
    edge = np.asarray(
        deflection_edges(
            (jnp.asarray(vel[..., 0]), jnp.asarray(vel[..., 1]),
             jnp.asarray(vel[..., 2])),
            jnp.asarray(st), 0.05,
        )
    )
    boundary = np.zeros_like(st, bool)
    boundary[:-1] |= st[:-1] != st[1:]
    boundary[1:] |= st[1:] != st[:-1]
    boundary[:, :-1] |= st[:, :-1] != st[:, 1:]
    boundary[:, 1:] |= st[:, 1:] != st[:, :-1]
    assert (edge[boundary] > 0).all()
    # and the mask is sparse — the point of the scheme
    assert edge.mean() < 0.5


@pytest.mark.parametrize("divisor", [2, 3])
def test_multires_matches_full_render_within_budget(divisor):
    """Full pipeline vs the exact full-res render: the reference's Phase 4-1
    budget is 'visually indistinguishable' (SSIM > 0.95); here we pin mean
    error and the fraction of significantly-off pixels."""
    cam = Camera.default()
    scene = _scene(96, 66, 200)
    full = np.asarray(
        render_image(
            cam, scene, None, None, None, config=TraceConfig(),
            use_pallas=True, tonemap="passthrough",
        )
    ).astype(np.int32)
    multi = np.asarray(
        render_multires(
            cam, scene, None, config=TraceConfig(), divisor=divisor,
        )
    ).astype(np.int32)
    diff = np.abs(full[..., :3] - multi[..., :3])
    assert diff.mean() < 3.0, f"mean u8 error {diff.mean()}"
    # at this toy resolution individual stars are sub-pixel, so a small
    # fraction of star pixels lands off by many levels (the reference's
    # own Phase 4-1 budget is perceptual: SSIM > 0.95)
    assert (diff.max(axis=-1) > 16).mean() < 0.04, "too many off pixels"


def test_multires_disk_matches_full_render_within_budget():
    """Disk configs (round 3): the hit-position field is upsampled alongside
    the deflection field; status boundaries (disk rim, shadow edge) are
    re-traced at full resolution by the edge fix-up. Error budget mirrors
    the disk-free test."""
    from bhr_tpu.models.disk import DiskParams, blackbody_lut

    cam = Camera.new([0.0, 3.0, 20.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    scene = _scene(96, 66, 300)
    cfg = TraceConfig(disk=True)
    dp = DiskParams.for_scene(scene.schwarzschild_radius)
    lut = blackbody_lut()
    full = np.asarray(
        render_image(
            cam, scene, None, dp, lut, config=cfg,
            use_pallas=True, tonemap="passthrough",
        )
    ).astype(np.int32)
    multi = np.asarray(
        render_multires(
            cam, scene, None, dp, lut, config=cfg, divisor=2,
        )
    ).astype(np.int32)
    diff = np.abs(full[..., :3] - multi[..., :3])
    assert diff.mean() < 3.0, f"mean u8 error {diff.mean()}"
    assert (diff.max(axis=-1) > 16).mean() < 0.04, "too many off pixels"


def test_multires_disk_requires_params():
    cam = Camera.default()
    scene = _scene()
    with pytest.raises(ValueError, match="disk_params"):
        render_multires(cam, scene, None, config=TraceConfig(disk=True))


def test_renderer_multires_method():
    from bhr_tpu import BlackHoleRenderer

    r = BlackHoleRenderer(48, 32)
    frame = np.asarray(r.render_frame_multires(divisor=2))
    assert frame.shape == (32, 48, 4)
    assert (frame[..., 3] == 255).all()


def test_strided_low_pass_matches_full_grid_points():
    """The strided low pass must trace EXACTLY the full image's every-d-th
    pixels: same UVs, same trajectories (flat space: no chaos, so the
    agreement is tight everywhere)."""
    cam = Camera.default()
    scene = _scene(96, 64, 60)
    cfg = TraceConfig(model="flat")
    full = pallas_trace_image(cam, scene, cfg)
    d = 4
    low = pallas_trace_image(
        cam, scene, cfg, local_shape=(64 // d, 96 // d), stride=d
    )
    np.testing.assert_allclose(
        np.asarray(low.final_vel),
        np.asarray(full.final_vel)[::d, ::d],
        atol=1e-6,
    )
    np.testing.assert_array_equal(
        np.asarray(low.status), np.asarray(full.status)[::d, ::d]
    )
