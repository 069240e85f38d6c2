"""Neural geodesic surrogate (reference roadmap Phase 5) tests.

Covers: parameter persistence, the reduced-coordinate feature map, plane
reconstruction, a tiny end-to-end training run (the surrogate must learn
the oracle dynamics), renderer integration with the committed production
weights, and the config validation surface.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bhr_tpu.core.camera import Camera, generate_rays
from bhr_tpu.core.scene import SceneParams
from bhr_tpu.models import neural
from bhr_tpu.ops.neural_trace import neural_trace_image
from bhr_tpu.ops.trace import (
    STATUS_CAPTURED,
    TraceConfig,
    trace_rays,
)
from bhr_tpu.renderer import BlackHoleRenderer

WEIGHTS = (
    pathlib.Path(__file__).resolve().parent.parent
    / "bhr_tpu"
    / "assets"
    / "neural_schwarzschild.npz"
)


def test_features_shape_and_bounds():
    key = jax.random.PRNGKey(0)
    r0 = jax.random.uniform(key, (512,), jnp.float32, 3.0, 60.0)
    rs = jnp.full((512,), 2.0, jnp.float32)
    psi = jax.random.uniform(key, (512,), jnp.float32, 0.0, np.pi)
    f = neural.ray_features(r0, rs, jnp.cos(psi), jnp.sin(psi))
    assert f.shape == (512, neural.N_FEATURES)
    assert bool(jnp.all(jnp.isfinite(f)))
    assert float(jnp.max(jnp.abs(f))) < 8.0


def test_predict_directions_unit_and_radial_guard():
    params = neural.init_params(jax.random.PRNGKey(1), (16, 16))
    # include an exactly-radial ray (undefined plane) — must not NaN
    origins = jnp.array([[15.0, 0.0, 0.0], [10.0, 4.0, 2.0]], jnp.float32)
    dirs = jnp.array([[1.0, 0.0, 0.0], [-0.8, 0.1, 0.3]], jnp.float32)
    v, cap = neural.predict_directions(
        params, origins, dirs, jnp.zeros(3), jnp.float32(2.0)
    )
    assert bool(jnp.all(jnp.isfinite(v)))
    np.testing.assert_allclose(
        np.asarray(jnp.sum(v * v, axis=-1)), 1.0, atol=1e-5
    )
    assert cap.shape == (2,)


def test_params_roundtrip(tmp_path):
    params = neural.init_params(jax.random.PRNGKey(2), (8, 8))
    path = tmp_path / "w.npz"
    neural.save_params(str(path), params, meta=dict(max_steps=123))
    loaded, meta = neural.load_params(str(path))
    assert len(loaded) == len(params)
    for (w0, b0), (w1, b1) in zip(params, loaded):
        np.testing.assert_array_equal(np.asarray(w0), np.asarray(w1))
        np.testing.assert_array_equal(np.asarray(b0), np.asarray(b1))
    assert int(meta["max_steps"]) == 123


def test_tiny_training_learns_oracle():
    """A small net on a small dataset must learn the (truncated) dynamics:
    loss drops, capture classification works, easy-regime deflections are
    accurate to a degree."""
    key = jax.random.PRNGKey(3)
    k_data, k_eval, k_fit = jax.random.split(key, 3)
    dataset = neural.make_dataset(k_data, 40_000, max_steps=100, chunk=40_000)
    eval_set = neural.make_dataset(k_eval, 8_192, max_steps=100, chunk=8_192)
    result = neural.train(
        k_fit,
        dataset,
        hidden=(48, 48),
        steps=600,
        batch_size=4096,
        lr=2e-3,
        log_every=200,
    )
    assert result.final_loss < result.loss_history[0] * 0.5
    metrics = neural.evaluate(result.params, eval_set)
    assert metrics["capture_acc"] > 0.93
    assert metrics["median_deg"] < 2.0


@pytest.mark.skipif(not WEIGHTS.exists(), reason="production weights not trained yet")
class TestProductionWeights:
    """The committed production surrogate vs the oracle at the library
    default workload (max_steps=500, rs=2, camera r0 ~ 15.8)."""

    @classmethod
    def setup_class(cls):
        cls.params, cls.meta = neural.load_params(str(WEIGHTS))
        cls.scene = SceneParams(
            screen_width=96, screen_height=64, max_steps=500
        )
        cls.camera = Camera.default()
        origins, dirs = generate_rays(cls.camera, 96, 64, cls.scene.fov)
        cls.oracle = trace_rays(
            origins,
            dirs,
            cls.scene.black_hole_position,
            cls.scene.schwarzschild_radius,
            cls.scene.spin,
            500,
            TraceConfig(),
        )
        cls.pred = neural_trace_image(cls.params, cls.camera, cls.scene)

    def test_capture_mask_matches(self):
        got = np.asarray(self.pred.status == STATUS_CAPTURED)
        want = np.asarray(self.oracle.status == STATUS_CAPTURED)
        inter = np.logical_and(got, want).sum()
        union = np.logical_or(got, want).sum()
        assert union > 0  # the default scene does contain a shadow
        assert inter / union > 0.95

    def test_deflection_angular_error(self):
        both_live = np.asarray(
            (self.pred.status != STATUS_CAPTURED)
            & (self.oracle.status != STATUS_CAPTURED)
        )
        dot = np.clip(
            np.asarray(
                jnp.sum(self.pred.final_vel * self.oracle.final_vel, axis=-1)
            ),
            -1.0,
            1.0,
        )
        err = np.degrees(np.arccos(dot))[both_live]
        assert np.median(err) < 0.25
        assert np.percentile(err, 90) < 2.0

    def test_renderer_end_to_end(self):
        r = BlackHoleRenderer(96, 64, integrator="neural")
        frame = np.asarray(r.render_frame())
        assert frame.shape == (64, 96, 4)
        assert frame.dtype == np.uint8
        # shadow pixels are black, alpha everywhere 255
        assert (frame[..., 3] == 255).all()
        cap = np.asarray(self.pred.status == STATUS_CAPTURED)
        assert (frame[..., :3][cap] == 0).all()

    def test_scan_animation_path(self):
        from bhr_tpu.animation import OrbitAnimator

        r = BlackHoleRenderer(64, 48, integrator="neural")
        frames = np.asarray(OrbitAnimator(r).render_frames(2, fps=30.0))
        assert frames.shape == (2, 48, 64, 4)

    def test_deflection_cache_path(self):
        r = BlackHoleRenderer(64, 48, integrator="neural", cache_deflection=True)
        f1 = np.asarray(r.render_frame())
        f2 = np.asarray(r.render_frame())
        np.testing.assert_array_equal(f1, f2)


def test_neural_config_validation():
    # kerr is supported (models/neural_kerr.py); the approximate kerr_lt
    # and flat models have no surrogate
    with pytest.raises(ValueError, match="schwarzschild"):
        BlackHoleRenderer(32, 32, integrator="neural", model="kerr_lt")
    with pytest.raises(ValueError, match="schwarzschild"):
        BlackHoleRenderer(32, 32, integrator="neural", model="flat")
    with pytest.raises(ValueError, match="disk"):
        BlackHoleRenderer(32, 32, integrator="neural", disk=True)
    with pytest.raises(ValueError, match="multires"):
        BlackHoleRenderer(32, 32, integrator="neural", multires=2)


def test_neural_missing_weights_message():
    if WEIGHTS.exists():
        pytest.skip("weights present; default path resolves")
    with pytest.raises(FileNotFoundError, match="train_neural"):
        BlackHoleRenderer(32, 32, integrator="neural")


def test_all_committed_assets_load_and_predict():
    """Every shipped .npz asset must load under the current FEATURE_VERSION
    (or KERR_FEATURE_VERSION) and produce finite unit directions."""
    from bhr_tpu.models import neural_kerr

    assets = sorted(WEIGHTS.parent.glob("*.npz"))
    if not assets:
        pytest.skip("no committed weights")
    origins = jnp.array([[15.0, 5.0, 0.0]], jnp.float32)
    dirs = jnp.array([[-0.9, -0.3, 0.1]], jnp.float32)
    for path in assets:
        if path.name.startswith("neural_kerr"):
            params, meta = neural_kerr.load_params(str(path))
            v, cap = neural_kerr.predict_directions_kerr(
                params, origins, dirs, jnp.zeros(3), jnp.float32(2.0),
                jnp.float32(0.7),
            )
        else:
            params, meta = neural.load_params(str(path))
            v, cap = neural.predict_directions(
                params, origins, dirs, jnp.zeros(3), jnp.float32(2.0)
            )
        assert bool(jnp.all(jnp.isfinite(v))), path.name
        np.testing.assert_allclose(
            np.asarray(jnp.sum(v * v, axis=-1)), 1.0, atol=1e-5,
            err_msg=path.name,
        )


def test_domain_warning_on_extrapolation(caplog):
    """Distilled weights carry their trained (r0, rs) domain in meta; a
    render outside it must warn (not fail)."""
    import logging as _logging

    orbit = WEIGHTS.parent / "neural_schwarzschild_orbit.npz"
    if not orbit.exists():
        pytest.skip("distilled weights not trained yet")
    r = BlackHoleRenderer(32, 24, integrator="neural", neural_params=str(orbit))
    far_cam = Camera.new([50.0, 5.0, 0.0], [0, 0, 0], [0, 1, 0])
    scene = SceneParams(screen_width=32, screen_height=24, max_steps=100)
    with caplog.at_level(_logging.WARNING, logger="bhr_tpu"):
        r.render_frame(far_cam, scene)
    assert any("extrapolating" in rec.message for rec in caplog.records)
    caplog.clear()
    with caplog.at_level(_logging.WARNING, logger="bhr_tpu"):
        r.render_frame(Camera.default(), scene)  # inside the domain
    assert not any("extrapolating" in rec.message for rec in caplog.records)


@pytest.mark.parametrize(
    "train_precision, tier",
    [
        (None, "bf16"),
        ("default", "bf16"),
        ("bfloat16", "bf16"),
        ("float32", "highest"),
        ("highest", "highest"),
        ("high", "highest"),
        ("tensorfloat32", "highest"),
    ],
)
def test_inference_tier_follows_training_precision(train_precision, tier):
    """Weights are native to the product rounding they trained at: bf16
    training -> bf16 operands, fp32 training -> fp32 at HIGHEST."""
    assert neural.inference_tier(train_precision) == tier


@pytest.mark.parametrize("tier", sorted(neural.NEURAL_TIERS))
def test_neural_tiers_never_leave_fp32_products_to_the_backend(tier):
    """Neither tier runs an fp32 x fp32 product at DEFAULT precision, which
    a GPU may lower to TF32: bf16 operands, or fp32 at HIGHEST."""
    params = neural.init_params(jax.random.PRNGKey(5), (16,))
    scene = SceneParams(screen_width=8, screen_height=4, max_steps=10)
    jaxpr = jax.make_jaxpr(
        lambda p: neural_trace_image(
            p, Camera.default(), scene, **neural.tier_matmul_args(tier)
        )
    )(params)
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    dots += [
        e
        for eqn in jaxpr.jaxpr.eqns
        for sub in jax.core.jaxprs_in_params(eqn.params)
        for e in sub.eqns
        if e.primitive.name == "dot_general"
    ]
    assert dots, "the surrogate must run matmuls"
    for e in dots:
        dtypes = {v.aval.dtype for v in e.invars}
        if tier == "bf16":
            assert dtypes == {jnp.dtype(jnp.bfloat16)}
        else:
            assert dtypes == {jnp.dtype(jnp.float32)}
            assert e.params["precision"] == (
                jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST
            )


@pytest.mark.skipif(not WEIGHTS.exists(), reason="production weights not trained yet")
def test_renderer_distill_on_demand(tmp_path):
    """distill() fine-tunes the surrogate for the renderer's scene
    in-place: width (and thus kernel eligibility + compiled programs) is
    preserved, the extrapolation-guard domain narrows to the scene's
    manifold, metrics come back, and `save` round-trips through
    neural_params=."""
    r = BlackHoleRenderer(64, 48, integrator="neural")
    w_before = [w.shape for w, _ in r.neural_params]
    scene = r.scene.replace(max_steps=80)
    out = tmp_path / "distilled.npz"
    metrics = r.distill(
        scene=scene, rays=20_000, steps=300, save=out,
        eval_rays=4_096, lr=5e-4,
    )
    assert set(metrics) >= {"median_deg", "p99_deg", "capture_acc"}
    assert metrics["capture_acc"] > 0.9
    assert [w.shape for w, _ in r.neural_params] == w_before
    r_lo, r_hi = r._neural_domain[0]
    r0 = float(np.linalg.norm(np.asarray(r.camera.position)))
    assert r_lo <= r0 <= r_hi and r_hi < 60.0  # narrowed, covers the scene
    frame = r.render_frame(scene=scene)
    assert frame.shape[:2] == (48, 64)
    # the saved npz reloads as a normal weights asset
    r2 = BlackHoleRenderer(64, 48, integrator="neural", neural_params=str(out))
    assert r2._neural_domain is not None


def test_distill_requires_neural_integrator():
    r = BlackHoleRenderer(32, 32)
    with pytest.raises(ValueError, match="integrator='neural'"):
        r.distill(rays=1000, steps=10)


def test_neural_precision_auto_resolution(tmp_path):
    """Asset meta train_precision drives the renderer's inference tier
    (round 5: fp32-trained weights served at bf16 products lose SSIM;
    models/neural.mlp_apply precision note)."""
    params = neural.init_params(jax.random.PRNGKey(3), (8, 8))
    p_bf16 = tmp_path / "native.npz"
    p_fp32 = tmp_path / "fp32.npz"
    neural.save_params(str(p_bf16), params, meta=dict(max_steps=10))
    neural.save_params(
        str(p_fp32), params,
        meta=dict(max_steps=10, train_precision="float32"),
    )
    r_native = BlackHoleRenderer(
        32, 24, integrator="neural", neural_params=str(p_bf16)
    )
    assert r_native.neural_precision == "bf16"
    r_fp32 = BlackHoleRenderer(
        32, 24, integrator="neural", neural_params=str(p_fp32)
    )
    assert r_fp32.neural_precision == "highest"
    # explicit override beats auto
    r_over = BlackHoleRenderer(
        32, 24, integrator="neural", neural_params=str(p_fp32),
        neural_precision="bf16",
    )
    assert r_over.neural_precision == "bf16"
    with pytest.raises(ValueError, match="neural_precision"):
        BlackHoleRenderer(
            32, 24, integrator="neural", neural_params=str(p_fp32),
            neural_precision="fp64",
        )
    # raw parameter pytrees carry no meta: the committed assets' tier
    r_raw = BlackHoleRenderer(32, 24, integrator="neural", neural_params=params)
    assert r_raw.neural_precision == "bf16"
    # both tiers render; bf16 operands round the products, so the frames
    # agree on nearly every pixel but need not be identical
    f_hi = np.asarray(r_fp32.render_frame())
    f_bf = np.asarray(r_over.render_frame())
    assert f_hi.shape == f_bf.shape == (24, 32, 4)
    assert (f_hi == f_bf).all(-1).mean() > 0.9


def test_mlp_apply_precision_strings():
    params = neural.init_params(jax.random.PRNGKey(4), (8,))
    feats = jnp.ones((5, neural.N_FEATURES), jnp.float32)
    base = neural.mlp_apply(params, feats)
    for tier in ("default", "high", "highest"):
        out = neural.mlp_apply(params, feats, precision=tier)
        # CPU matmuls are true fp32 at every tier
        np.testing.assert_allclose(
            np.asarray(out), np.asarray(base), rtol=1e-6, atol=1e-6
        )
