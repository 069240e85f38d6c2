"""Runtime physics plugins (model="custom") — the reference's --shader
hot-swap analog (reference: src/lib.rs:425-429, src/main.rs:30).

A plugin is a plane-form acceleration traced into BOTH paths; these tests
pin (1) oracle/kernel agreement for a custom metric, (2) exact equivalence
of a plugin re-stating a built-in model, (3) the loader, and (4) the CLI
and renderer plumbing."""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from bhr_tpu.core.camera import Camera, generate_rays
from bhr_tpu.core.scene import SceneParams
from bhr_tpu.ops.pallas_trace import pallas_trace_image
from bhr_tpu.ops.trace import TraceConfig, trace_rays

REPO = pathlib.Path(__file__).resolve().parent.parent
PW_PLUGIN = REPO / "examples" / "plugins" / "paczynski_wiita.py"

W, H, STEPS = 48, 32, 120


def _scene(**kw):
    return SceneParams(screen_width=W, screen_height=H, max_steps=STEPS, **kw)


def _oracle(camera, scene, config):
    origins, dirs = generate_rays(
        camera, scene.screen_width, scene.screen_height, scene.fov
    )
    return trace_rays(
        origins, dirs, scene.black_hole_position, scene.schwarzschild_radius,
        scene.spin, scene.max_steps, config,
    )


def _schwarzschild_planes(rel, vel, r, r2, rs, spin):
    """The built-in Schwarzschild accel re-stated as a plugin, in the
    oracle's literal operation order (models/schwarzschild.py, wgsl:69-79)."""
    del spin
    r_vec = (rel[0] / r, rel[1] / r, rel[2] / r)
    rs_over_r = rs / r
    one_m = 1.0 - rs_over_r
    factor = rs / (2.0 * r * r * one_m)
    v_rad = vel[0] * r_vec[0] + vel[1] * r_vec[1] + vel[2] * r_vec[2]
    one_p = 1.0 + rs_over_r
    return (
        -factor * (vel[0] * one_m - r_vec[0] * v_rad * one_p),
        -factor * (vel[1] * one_m - r_vec[1] * v_rad * one_p),
        -factor * (vel[2] * one_m - r_vec[2] * v_rad * one_p),
    )


def _zero_planes(rel, vel, r, r2, rs, spin):
    z = jnp.zeros_like(rel[0])
    return (z, z, z)


def test_config_requires_accel():
    with pytest.raises(ValueError, match="custom_accel"):
        TraceConfig(model="custom")


def test_plugin_zero_accel_matches_flat_oracle():
    """A zero-force plugin must reproduce the flat-space model exactly
    (same integrator loop, same termination bookkeeping)."""
    cam = Camera.default()
    scene = _scene()
    cfg_p = TraceConfig(model="custom", custom_accel=_zero_planes,
                        custom_capture_factor=1.05)
    cfg_f = TraceConfig(model="flat")
    rp = _oracle(cam, scene, cfg_p)
    rf = _oracle(cam, scene, cfg_f)
    # flat.capture_radius is also 1.05 * rs -> everything matches exactly
    np.testing.assert_array_equal(np.asarray(rp.status), np.asarray(rf.status))
    np.testing.assert_array_equal(np.asarray(rp.steps), np.asarray(rf.steps))
    np.testing.assert_array_equal(np.asarray(rp.final_vel), np.asarray(rf.final_vel))
    np.testing.assert_array_equal(np.asarray(rp.final_pos), np.asarray(rf.final_pos))


@pytest.mark.parametrize("integrator", ["euler", "rk4", "leapfrog"])
def test_plugin_schwarzschild_matches_builtin_oracle(integrator):
    """The Schwarzschild formula as a plugin reproduces the built-in model
    through the oracle. The two configs compile separately (different jit
    cache keys), so XLA's FMA contraction choices differ by ~1 ulp
    (CLAUDE.md hard-won constraint 5) — statuses/steps must still match
    everywhere at this resolution, velocities to FMA-noise tolerance."""
    cam = Camera.default()
    scene = _scene()
    cfg_p = TraceConfig(integrator=integrator, model="custom",
                        custom_accel=_schwarzschild_planes,
                        custom_capture_factor=1.05)
    cfg_s = TraceConfig(integrator=integrator)
    rp = _oracle(cam, scene, cfg_p)
    rsr = _oracle(cam, scene, cfg_s)
    np.testing.assert_array_equal(np.asarray(rp.status), np.asarray(rsr.status))
    np.testing.assert_array_equal(np.asarray(rp.steps), np.asarray(rsr.steps))
    vd = np.abs(
        np.asarray(rp.final_vel) - np.asarray(rsr.final_vel)
    ).max(-1)
    m = np.asarray(rsr.status) != 2  # captured vels are never consumed
    assert vd[m].max() <= 1e-4, f"max vel diff {vd[m].max()}"


@pytest.mark.parametrize("integrator", ["euler", "rk4", "leapfrog"])
def test_plugin_kernel_matches_oracle(integrator):
    """The VERDICT item-8 contract: a custom toy metric agrees between the
    XLA oracle and the Pallas kernel (chaos-aware threshold — separately
    compiled programs differ by ulps that amplify at capture boundaries)."""
    from bhr_tpu.utils.plugin import load_plugin

    accel, cap = load_plugin(str(PW_PLUGIN))
    assert cap == pytest.approx(1.10)
    cam = Camera.default()
    scene = _scene()
    cfg = TraceConfig(integrator=integrator, model="custom",
                      custom_accel=accel, custom_capture_factor=cap)
    ro = _oracle(cam, scene, cfg)
    rk = pallas_trace_image(cam, scene, cfg)
    sp, so = np.asarray(rk.status), np.asarray(ro.status)
    same = sp == so
    assert same.mean() >= 0.99, f"status agrees on only {same.mean():.4f}"
    m = same & (so != 2)
    vd = np.abs(np.asarray(rk.final_vel) - np.asarray(ro.final_vel)).max(-1)
    assert (vd[m] <= 1e-4).mean() >= 0.99


def test_plugin_runs_in_multires_mode():
    """Plug-in physics is traced into the one geodesic kernel, so the
    multires low pass and edge fix-up serve it like a built-in model."""
    from bhr_tpu import BlackHoleRenderer

    r = BlackHoleRenderer(48, 32, custom_physics=str(PW_PLUGIN))
    frame = np.asarray(r.render_frame_multires(divisor=2))
    assert frame.shape == (32, 48, 4)
    assert (frame[..., 3] == 255).all()


def test_loader_accepts_callable_module_and_path(tmp_path):
    from bhr_tpu.utils.plugin import load_plugin

    # callable
    fn, cap = load_plugin(_zero_planes)
    assert fn is _zero_planes and cap == pytest.approx(1.05)
    # file path (cached by resolved path -> same function object)
    f1, c1 = load_plugin(str(PW_PLUGIN))
    f2, _ = load_plugin(str(PW_PLUGIN))
    assert f1 is f2 and c1 == pytest.approx(1.10)
    # module-like
    class Mod:
        acceleration = staticmethod(_zero_planes)
        CAPTURE_FACTOR = 1.2

    fn, cap = load_plugin(Mod())
    assert cap == pytest.approx(1.2)
    # bad file
    bad = tmp_path / "bad.py"
    bad.write_text("x = 1\n")
    with pytest.raises(ValueError, match="acceleration"):
        load_plugin(str(bad))
    with pytest.raises(FileNotFoundError):
        load_plugin(str(tmp_path / "missing.py"))


def test_renderer_custom_physics_renders():
    from bhr_tpu import BlackHoleRenderer

    r = BlackHoleRenderer(
        64, 48, use_pallas=False, custom_physics=str(PW_PLUGIN)
    )
    assert r.config.model == "custom"
    assert r.config.custom_capture_factor == pytest.approx(1.10)
    scene = SceneParams(screen_width=64, screen_height=48, max_steps=60)
    img = np.asarray(r.render_frame(Camera.default(), scene))
    assert img.shape == (48, 64, 4)
    assert img[..., 3].min() == 255
    # a central-force metric still casts a shadow: some captured pixels
    assert (img[..., :3].sum(-1) == 0).any()

    with pytest.raises(ValueError, match="conflicts"):
        BlackHoleRenderer(32, 32, model="kerr", custom_physics=_zero_planes)
    with pytest.raises(ValueError, match="custom_physics"):
        BlackHoleRenderer(32, 32, model="custom")
    # the one kernel serves plug-ins in multires mode too
    assert BlackHoleRenderer(32, 32, multires=2, custom_physics=_zero_planes).multires == 2


def test_cli_plugin_renders_frames(tmp_path):
    """The CLI hot-swap: --plugin file renders end-to-end (VERDICT item 8
    done-criterion: 'a custom toy metric renders from the CLI')."""
    from bhr_tpu.app import main

    out = tmp_path / "frames"
    rc = main([
        "--plugin", str(PW_PLUGIN), "--frames", "2", "--width", "64",
        "--height", "48", "--max-steps", "40", "--out", str(out),
        "--chunk", "2",
    ])
    assert rc in (0, None)
    pngs = sorted(out.glob("*.png"))
    assert len(pngs) == 2
