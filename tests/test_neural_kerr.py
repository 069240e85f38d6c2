"""Kerr neural geodesic surrogate tests (models/neural_kerr.py).

Covers: the reduced-coordinate feature map (Kerr block), envelope
behavior at the Schwarzschild limit, parameter persistence (including
the cross-asset loading guards), full-3D reconstruction, a tiny
end-to-end training run against the exact Kerr-Schild oracle, and —
with the committed production asset — renderer integration through
integrator="neural" + model="kerr".
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bhr_tpu.core.camera import Camera, generate_rays
from bhr_tpu.core.scene import SceneParams
from bhr_tpu.models import neural, neural_kerr as nk
from bhr_tpu.ops.neural_trace import neural_trace_image
from bhr_tpu.ops.trace import STATUS_CAPTURED, TraceConfig, trace_rays
from bhr_tpu.renderer import BlackHoleRenderer

KERR_WEIGHTS = (
    pathlib.Path(__file__).resolve().parent.parent
    / "bhr_tpu"
    / "assets"
    / "neural_kerr.npz"
)


def test_features_shape_and_bounds():
    key = jax.random.PRNGKey(0)
    r0 = jax.random.uniform(key, (512,), jnp.float32, 3.0, 60.0)
    rs = jnp.full((512,), 2.0, jnp.float32)
    spin = jnp.full((512,), 0.9, jnp.float32)
    psi = jax.random.uniform(key, (512,), jnp.float32, 0.0, np.pi)
    ny = jax.random.uniform(key, (512,), jnp.float32, -1.0, 1.0)
    f = nk.ray_features_kerr(
        r0, rs, spin, jnp.cos(psi), jnp.sin(psi), 0.1 * ny, -0.2 * ny, ny
    )
    assert f.shape == (512, nk.N_FEATURES_KERR)
    assert bool(jnp.all(jnp.isfinite(f)))
    assert float(jnp.max(jnp.abs(f))) < 8.0


def test_bc_factor_equatorial_limits():
    """The sqrt-factored fit tracks the exact equatorial GR critical
    impact parameter b_c(p)/M = -p + 6 cos(arccos(-p)/3) with the
    feature-v2 prograde sense p = -xi (the Kerr-Schild axis mapping is
    orientation-reversing; ny < 0 rays are prograde — docstring +
    scripts/kerr_bc_probe.py). Endpoints: 2M prograde (xi=-1),
    3 sqrt(3) M Schwarzschild, 7M retrograde (xi=+1); b_c/rs = b_c/2M."""
    np.testing.assert_allclose(float(nk.bc_factor_kerr(-1.0)), 1.0, atol=1e-5)
    np.testing.assert_allclose(
        float(nk.bc_factor_kerr(0.0)), 3.0 * np.sqrt(3.0) / 2.0, atol=5e-4
    )
    np.testing.assert_allclose(float(nk.bc_factor_kerr(1.0)), 3.5, atol=4e-3)
    # fit error across the capped spin domain |p| <= 0.955: < 2.5e-3 M
    xi = jnp.linspace(-0.955, 0.955, 383)
    p = -np.asarray(xi, np.float64)
    exact = (-p + 6.0 * np.cos(np.arccos(-p) / 3.0)) * 0.5
    err_m = np.abs(np.asarray(nk.bc_factor_kerr(xi), np.float64) - exact) * 2
    assert float(err_m.max()) < 2.5e-3


def test_redshift_factor_values():
    np.testing.assert_allclose(
        float(nk.redshift_factor(10.0, 2.0)), np.sqrt(0.8), rtol=1e-6
    )
    # clamped away from 0 below the sampler floor
    assert float(nk.redshift_factor(2.0, 2.0)) == pytest.approx(0.2)


def test_envelopes_schwarzschild_limit():
    """At spin = 0 the delta envelope must match the Schwarzschild form
    evaluated in the feature-v2 criticality coordinate (critical angle at
    the redshift-corrected conserved impact parameter b = L/E), and the
    chi envelope must (almost) vanish — the parameterization is exact in
    the planar limit."""
    r0 = jnp.array([8.0, 15.0, 40.0], jnp.float32)
    rs = jnp.float32(2.0)
    s = jnp.array([0.3, 0.6, 0.9], jnp.float32)
    c = jnp.array([-0.5, 0.2, -0.8], jnp.float32)
    ny = jnp.array([0.1, -0.7, 0.4], jnp.float32)
    e_d, e_c = nk.kerr_envelopes(r0, rs, 0.0, s, c, ny)
    bck = nk.bc_factor_kerr(jnp.zeros_like(ny))
    tk = r0 * s / (bck * rs * nk.redshift_factor(r0, rs)) - 1.0
    spike = jnp.log1p(1.0 / (jnp.abs(tk) + 2e-2)) * jax.nn.sigmoid(-8.0 * c)
    want = (rs / r0) * s * (0.25 + spike)
    np.testing.assert_allclose(np.asarray(e_d), np.asarray(want), rtol=1e-6)
    assert float(jnp.max(e_c / e_d)) <= 1.1e-3


def test_params_roundtrip_and_cross_guards(tmp_path):
    params = nk.init_params(jax.random.PRNGKey(2), (8, 8))
    path = tmp_path / "k.npz"
    nk.save_params(str(path), params, meta=dict(spin_range=(0.0, 0.95)))
    loaded, meta = nk.load_params(str(path))
    assert len(loaded) == len(params)
    for (w0, b0), (w1, b1) in zip(params, loaded):
        np.testing.assert_array_equal(np.asarray(w0), np.asarray(w1))
    np.testing.assert_allclose(meta["spin_range"], [0.0, 0.95])
    # a Kerr asset must not load through the Schwarzschild loader (and
    # vice versa) — the feature maps are incompatible
    with pytest.raises(ValueError, match="not a Schwarzschild"):
        neural.load_params(str(path))
    spath = tmp_path / "s.npz"
    neural.save_params(str(spath), neural.init_params(jax.random.PRNGKey(3), (8,)))
    with pytest.raises(ValueError, match="not a Kerr"):
        nk.load_params(str(spath))


def test_predict_directions_unit_radial_guard_and_schwarzschild_limit():
    params = nk.init_params(jax.random.PRNGKey(1), (16, 16))
    origins = jnp.array(
        [[15.0, 0.0, 0.0], [10.0, 4.0, 2.0], [0.0, 12.0, 0.0]], jnp.float32
    )
    dirs = jnp.array(
        [[1.0, 0.0, 0.0], [-0.8, 0.1, 0.3], [0.2, -0.9, 0.1]], jnp.float32
    )
    v, cap = nk.predict_directions_kerr(
        params, origins, dirs, jnp.zeros(3), jnp.float32(2.0), jnp.float32(0.9)
    )
    assert bool(jnp.all(jnp.isfinite(v)))
    np.testing.assert_allclose(
        np.asarray(jnp.sum(v * v, axis=-1)), 1.0, atol=1e-5
    )
    assert cap.shape == (3,)
    # spin = 0: the chi envelope ~ 0, so the prediction stays in the ray
    # plane (n . v ~ 0) — the Schwarzschild planar limit by construction
    v0, _ = nk.predict_directions_kerr(
        params, origins, dirs, jnp.zeros(3), jnp.float32(2.0), jnp.float32(0.0)
    )
    red = nk.reduce_ray(origins, dirs, jnp.zeros(3, jnp.float32))
    off_plane = jnp.abs(jnp.sum(v0 * red["n_hat"], axis=-1))
    assert float(jnp.max(off_plane)) < 5e-3


def test_tiny_training_learns_kerr_oracle():
    """A small net on a small dataset must learn the truncated Kerr
    dynamics: loss drops, capture classification works."""
    key = jax.random.PRNGKey(3)
    k_data, k_eval, k_fit = jax.random.split(key, 3)
    dataset = nk.make_dataset_kerr(
        k_data, 40_000, max_steps=100, chunk=40_000
    )
    eval_set = nk.make_dataset_kerr(
        k_eval, 8_192, max_steps=100, chunk=8_192
    )
    result = nk.train(
        k_fit, dataset, hidden=(48, 48), steps=600, batch_size=4096,
        lr=2e-3, log_every=200,
    )
    assert result.final_loss < result.loss_history[0] * 0.5
    metrics = nk.evaluate(result.params, eval_set)
    assert metrics["capture_acc"] > 0.9
    assert metrics["median_deg"] < 5.0


def test_neural_trace_image_dispatches_on_feature_width():
    """neural_trace_image must route 22-feature params through the Kerr
    predictor (spin from the scene) and 16-feature params through the
    Schwarzschild one."""
    params = nk.init_params(jax.random.PRNGKey(4), (16,))
    scene = SceneParams(
        screen_width=16, screen_height=8, max_steps=100,
        spin=jnp.float32(0.8),
    )
    res = neural_trace_image(params, Camera.default(), scene)
    assert res.final_vel.shape == (8, 16, 3)
    assert bool(jnp.all(jnp.isfinite(res.final_vel)))


@pytest.mark.skipif(
    not KERR_WEIGHTS.exists(), reason="Kerr weights not trained yet"
)
class TestProductionKerrWeights:
    """The committed Kerr surrogate vs the exact Kerr-Schild oracle at the
    library default workload (rs=2, a*=0.9, camera r0 ~ 15.8)."""

    @classmethod
    def setup_class(cls):
        cls.params, cls.meta = nk.load_params(str(KERR_WEIGHTS))
        cls.scene = SceneParams(
            screen_width=96, screen_height=64, max_steps=500,
            spin=jnp.float32(0.9),
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
            TraceConfig(model="kerr"),
        )
        cls.pred = neural_trace_image(cls.params, cls.camera, cls.scene)

    def test_capture_mask_matches(self):
        got = np.asarray(self.pred.status == STATUS_CAPTURED)
        want = np.asarray(self.oracle.status == STATUS_CAPTURED)
        inter = np.logical_and(got, want).sum()
        union = np.logical_or(got, want).sum()
        assert union > 0
        assert inter / union > 0.93

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
        # feature-v2 general net: median 0.54 deg on this scene (fv1: 0.49
        # — v2 trades a hair of default-scene median for an oracle-correct
        # capture boundary across all spins/planes and a distillable loss
        # floor; the per-scene distilled asset is the production path for
        # a fixed scene and is gauged separately at the 0.99-SSIM bar).
        assert np.median(err) < 0.6
        assert np.percentile(err, 90) < 5.0

    def test_renderer_end_to_end(self):
        r = BlackHoleRenderer(96, 64, integrator="neural", model="kerr")
        frame = np.asarray(r.render_frame(scene=self.scene))
        assert frame.shape == (64, 96, 4)
        assert (frame[..., 3] == 255).all()
        cap = np.asarray(self.pred.status == STATUS_CAPTURED)
        assert (frame[..., :3][cap] == 0).all()

    def test_spin_extrapolation_warns(self, caplog):
        import logging as _logging

        r = BlackHoleRenderer(32, 24, integrator="neural", model="kerr")
        hot = self.scene.replace(
            screen_width=32, screen_height=24, spin=jnp.float32(0.99)
        )
        with caplog.at_level(_logging.WARNING, logger="bhr_tpu"):
            r.render_frame(scene=hot)
        assert any("spin range" in rec.message for rec in caplog.records)


@pytest.mark.skipif(
    not KERR_WEIGHTS.exists(), reason="Kerr weights not trained yet"
)
def test_renderer_distill_kerr(tmp_path):
    """distill() on a model='kerr' renderer runs the Kerr distillation
    (models/neural_kerr.distill_for_scene_kerr): width preserved, the
    (r0, rs) domain AND the spin range narrow to the scene, the saved
    asset round-trips as a Kerr weights file, and the renderer still
    renders afterwards."""
    r = BlackHoleRenderer(48, 32, integrator="neural", model="kerr")
    w_before = [w.shape for w, _ in r.neural_params]
    scene = r.scene.replace(max_steps=60, spin=jnp.float32(0.7))
    out = tmp_path / "distilled_kerr.npz"
    metrics = r.distill(
        scene=scene, rays=8_192, steps=120, save=out,
        eval_rays=2_048, lr=5e-4,
    )
    assert set(metrics) >= {"median_deg", "p99_deg", "capture_acc"}
    assert metrics["capture_acc"] > 0.9
    assert [w.shape for w, _ in r.neural_params] == w_before
    r_lo, r_hi = r._neural_domain[0]
    r0 = float(np.linalg.norm(np.asarray(r.camera.position)))
    assert r_lo <= r0 <= r_hi and r_hi < 60.0
    assert r._neural_spin_range == pytest.approx((0.7, 0.7))
    frame = r.render_frame(scene=scene)
    assert frame.shape[:2] == (32, 48)
    # the saved npz reloads through the Kerr loader (kerr_feature_version)
    r2 = BlackHoleRenderer(
        48, 32, integrator="neural", model="kerr", neural_params=str(out)
    )
    assert r2._neural_domain is not None
    assert r2._neural_spin_range == pytest.approx((0.7, 0.7))


def test_sample_rays_kerr_cth_band():
    """cth_range restricts origins to the requested latitude band (the
    per-scene distillation's camera-latitude pin)."""
    o, _ = nk.sample_rays_kerr(
        jax.random.PRNGKey(3), 4096, 1.0, cth_range=(0.2, 0.45)
    )
    cth = np.asarray(o[:, 1] / jnp.sqrt(jnp.sum(o * o, axis=-1)))
    assert cth.min() >= 0.2 - 1e-5 and cth.max() <= 0.45 + 1e-5


def test_kerr_fp32_asset_serves_highest_tier(tmp_path):
    """An fp32-trained Kerr asset resolves to the fp32-at-HIGHEST tier, and
    that tier renders the same frame whether chosen by meta or by hand."""
    from bhr_tpu import BlackHoleRenderer

    params = nk.init_params(jax.random.PRNGKey(7), (32, 32))
    path = tmp_path / "kerr_fp32.npz"
    nk.save_params(
        str(path), params,
        meta=dict(max_steps=100, train_precision="float32"),
    )
    mk = dict(integrator="neural", model="kerr", neural_params=str(path))
    r_auto = BlackHoleRenderer(64, 48, **mk)
    assert r_auto.neural_precision == "highest"  # auto from meta
    r_hi = BlackHoleRenderer(64, 48, neural_precision="highest", **mk)
    scene = r_hi.scene.replace(spin=jnp.float32(0.9))
    np.testing.assert_array_equal(
        np.asarray(r_auto.render_frame(scene=scene)),
        np.asarray(r_hi.render_frame(scene=scene)),
    )
