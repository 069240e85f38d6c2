"""Neural geodesic surrogate — reference roadmap Phase 5.

The reference plans (but never implements) an MLP that replaces geodesic
integration with a single network evaluation per ray, citing GravLensX's
15-26x speedups (reference: docs/ROADMAP.md:1217-1337 — a GeodesicMLP
mapping initial conditions to the final direction, success criteria
"inference < 1/10 integration time, visually indistinguishable,
SSIM > 0.99"). This module is that surrogate: geodesic integration is
elementwise work per ray, while the surrogate renders a frame as a
handful of large batched matmuls.

Design — symmetry reduction instead of raw 5-D inputs. The roadmap's
sketch feeds (r, theta, phi, p_r, p_theta). Schwarzschild geodesics are
planar: the trajectory stays in the plane spanned by the radial direction
u_hat = (origin - bh)/r0 and the in-plane tangent w_hat (the component of
the ray direction orthogonal to u_hat). The whole problem therefore
reduces to THREE scalars — (r0, rs, psi) with psi the angle between the
ray direction and u_hat — and the network predicts a single in-plane
deflection angle delta plus a capture logit:

    d     = cos(psi) u_hat + sin(psi) w_hat          (by construction)
    v_out = cos(psi + delta) u_hat + sin(psi + delta) w_hat

Training targets come from the framework's own oracle (ops/trace.py, the
line-faithful WGSL transcription) at the library-default workload
(max_steps = 500, dt = 0.1), so the surrogate learns the *reference
dynamics* — including its Euler truncation — not textbook GR. The
periodic (cos, sin) loss absorbs winding near the photon sphere.

Envelope parameterization (feature_version 3, the round-4 generality
fix). The head does NOT emit delta directly: it emits an O(1)
coefficient g with

    delta = E(r0, rs, psi) * g
    E     = (rs/r0) sin(psi) * (1/4 + L)
    L     = log1p(1 / (|t| + 2e-2)) * sigmoid(-8 cos(psi))
    t     = r0 sin(psi) / (b_c) - 1        (distance from critical b)

Why: the committed nets train and serve at bf16 input rounding (see
mlp_apply), which puts an ~4e-3 * O(activation-scale) ABSOLUTE noise
floor on any head output, whatever the width. The reference
dynamics' weak-field deflection is tiny — its tangential-damping force
a ~ -(rs/2r^2) v_t gives dphi/ds ~ -K(r) sin(2 theta), whose leading
straight-path integral CANCELS, leaving delta ~ -(rs/4 r0) sin(psi)
— so the absolute floor swamps it.
The analytic envelope E carries the magnitude: (rs/r0) sin(psi) is the
weak-field scale and the log1p factor covers the logarithmic divergence
toward the critical impact parameter. The net's bf16 output noise then
lands RELATIVE to the local deflection scale instead of absolute.

The sigmoid(-8 cos psi) gate on the log spike: b ~ b_c only diverges for
INBOUND rays (cos psi < 0, heading toward the hole); an outbound ray at
the same impact parameter deflects a tiny amount, so an ungated spike
multiplies head noise exactly where delta is small and E^2-amplified
gradients divert training capacity.

Everything here is pure JAX (no flax dependency): params are a tuple of
(W, b) pairs, trainable with optax and usable directly inside jit/scan.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

FEATURE_VERSION = 3
N_FEATURES = 16
DEFAULT_HIDDEN = (96, 96, 96)
# GR critical impact parameter b_c = (3*sqrt(3)/2) rs — only used to
# normalize a feature (the net learns the true boundary of the Euler
# dynamics itself, which sits near but not exactly at this value).
_BC_FACTOR = 2.598076211


# ---------------------------------------------------------------------------
# parameters


def init_params(key, hidden: tuple[int, ...] = DEFAULT_HIDDEN):
    """He/Xavier-style init for an MLP [N_FEATURES, *hidden, 2]."""
    sizes = (N_FEATURES, *hidden, 2)
    params = []
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        key, sub = jax.random.split(key)
        scale = jnp.sqrt(jnp.float32(1.0 / fan_in))
        w = jax.random.normal(sub, (fan_in, fan_out), jnp.float32) * scale
        b = jnp.zeros((fan_out,), jnp.float32)
        params.append((w, b))
    return tuple(params)


def save_params(path: str, params, *, meta: dict | None = None) -> None:
    """Persist params (+ metadata) as an npz the test host can reload."""
    arrays = {}
    for i, (w, b) in enumerate(params):
        arrays[f"w{i}"] = np.asarray(w, np.float32)
        arrays[f"b{i}"] = np.asarray(b, np.float32)
    arrays["n_layers"] = np.int32(len(params))
    arrays["feature_version"] = np.int32(FEATURE_VERSION)
    for k, v in (meta or {}).items():
        arrays[f"meta_{k}"] = np.asarray(v)
    np.savez(path, **arrays)


def load_params(path: str):
    """Load params saved by save_params; returns (params, meta)."""
    with np.load(path) as z:
        if "feature_version" not in z.files:
            raise ValueError(
                f"weights at {path} are not a Schwarzschild-surrogate "
                "asset (no feature_version field; Kerr assets load via "
                "models/neural_kerr.load_params)"
            )
        if int(z["feature_version"]) != FEATURE_VERSION:
            raise ValueError(
                f"weights at {path} use feature_version "
                f"{int(z['feature_version'])}, code expects {FEATURE_VERSION}"
            )
        n = int(z["n_layers"])
        params = tuple(
            (jnp.asarray(z[f"w{i}"]), jnp.asarray(z[f"b{i}"])) for i in range(n)
        )
        meta = {
            k[len("meta_"):]: z[k] for k in z.files if k.startswith("meta_")
        }
    return params, meta


# ---------------------------------------------------------------------------
# features + forward pass


def ray_features(r0, rs, cos_psi, sin_psi):
    """(..., N_FEATURES) network inputs from the reduced ray coordinates.

    All bounded O(1) over the supported domain (r0 in [1.3 rs, 100],
    rs in [0.5, 4]) so a tanh MLP trains without input normalization.

    v2 additions (the v1 6-feature map plateaued at ~0.02 deg median):
    the deflection diverges logarithmically as the impact parameter b
    approaches the critical b_c, so the net gets the singular coordinate
    directly — log|b/b_c - 1| plus its (soft) sign — and four Fourier
    octaves of psi for the remaining high-frequency structure (the NeRF
    positional-encoding fix for spectral bias).
    """
    r0 = jnp.asarray(r0, jnp.float32)
    rs = jnp.broadcast_to(jnp.asarray(rs, jnp.float32), r0.shape)
    cos_psi = jnp.asarray(cos_psi, jnp.float32)
    sin_psi = jnp.asarray(sin_psi, jnp.float32)
    mu = rs / r0
    # inverse normalized impact parameter: ~1 at the GR critical impact
    # parameter, -> 0 for far-miss rays, large (clipped) inside it
    q = jnp.clip(_BC_FACTOR * rs / (r0 * sin_psi + 1e-6), 0.0, 4.0)
    # signed log-distance from the critical impact parameter
    t = r0 * sin_psi / (_BC_FACTOR * rs) - 1.0
    f_log = 0.2 * jnp.log(jnp.abs(t) + 1e-3)
    f_sign = jnp.tanh(8.0 * t)
    # Fourier octaves of psi via double-angle recurrences — (cos, sin) of
    # psi arrive as pure dot products, so sin(2^k psi) needs NO trig at
    # all: the recurrences are six multiplies where sin/cos lowerings
    # are long polynomial sequences.
    # Mathematically identical to sin/cos(k * arctan2(s, c)), so weights
    # trained under either formulation remain valid (differences are
    # ~1e-7, far under the bf16 matmul input rounding).
    s2 = 2.0 * sin_psi * cos_psi
    c2 = cos_psi * cos_psi - sin_psi * sin_psi
    s4 = 2.0 * s2 * c2
    c4 = c2 * c2 - s2 * s2
    s8 = 2.0 * s4 * c4
    c8 = c4 * c4 - s4 * s4
    s16 = 2.0 * s8 * c8
    c16 = c8 * c8 - s8 * s8
    return jnp.stack(
        [
            mu,
            cos_psi,
            sin_psi,
            q,
            0.25 * rs,
            0.25 * jnp.log(r0),
            f_log,
            f_sign,
            s2,
            c2,
            s4,
            c4,
            s8,
            c8,
            s16,
            c16,
        ],
        axis=-1,
    )


def delta_envelope(r0, rs, sin_psi, cos_psi):
    """Analytic deflection-magnitude envelope E (module docstring).

    fp32 throughout — the envelope is what makes the surrogate's bf16
    head noise relative instead of absolute, so it must not itself be
    rounded. Bounded: max over the live domain is (rs/r0) sin_crit *
    (0.25 + log1p(50)) ~ 10.8 * rs^2/r0^2; weak field ~ (rs/r0) sin_psi.
    The sigmoid gate restricts the critical-b log spike to inbound rays
    (cos psi < 0) — the divergence is physical only for rays that
    approach the photon sphere (module docstring, A/B-measured).
    """
    r0 = jnp.asarray(r0, jnp.float32)
    rs = jnp.asarray(rs, jnp.float32)
    sin_psi = jnp.asarray(sin_psi, jnp.float32)
    cos_psi = jnp.asarray(cos_psi, jnp.float32)
    t = r0 * sin_psi / (_BC_FACTOR * rs) - 1.0
    spike = jnp.log1p(1.0 / (jnp.abs(t) + 2e-2)) * jax.nn.sigmoid(
        -8.0 * cos_psi
    )
    return (rs / r0) * sin_psi * (0.25 + spike)


PRECISION_TIERS = {
    "default": None,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
}

# Inference tiers of the renderer: (matmul operand dtype, precision).
# Weights are native to the matmul rounding they were trained at, so the
# tier follows the asset's `train_precision` meta (inference_tier):
# bf16-trained weights run bf16 operands with fp32 accumulation, and
# fp32-trained weights run fp32 at HIGHEST. Neither tier leaves the choice
# to the backend's DEFAULT fp32 product, which on a GPU may run in TF32.
NEURAL_TIERS = {
    "bf16": (jnp.bfloat16, None),
    "highest": (jnp.float32, jax.lax.Precision.HIGHEST),
}
_FP32_TRAINING = ("float32", "highest", "high", "tensorfloat32")


def inference_tier(train_precision) -> str:
    """Inference tier for weights trained at `train_precision` (asset meta;
    None or "default" = the bf16 training forward of the committed assets)."""
    return "highest" if str(train_precision) in _FP32_TRAINING else "bf16"


def tier_matmul_args(tier: str) -> dict:
    """mlp_apply keyword arguments (dtype, precision) of a NEURAL_TIERS tier."""
    dtype, precision = NEURAL_TIERS[tier]
    return {"dtype": dtype, "precision": precision}


def mlp_apply(params, feats, *, dtype=jnp.float32, precision=None):
    """Forward pass -> (..., 2): [delta, capture_logit].

    `dtype` selects the matmul element type; accumulation is always fp32
    via preferred_element_type and the nonlinearity runs in fp32.
    `precision` accepts a lax.Precision or the strings in PRECISION_TIERS;
    it must MATCH the precision the weights were trained at (asset meta
    `train_precision`; the renderer resolves it through inference_tier):
    bf16-trained weights are native to bf16 product rounding, and
    fp32-trained weights (the Kerr per-scene distill at
    `--train-precision float32`) fit below the bf16 half-ulp floor and need
    fp32 products to serve it — a mismatched tier is worse than either
    matched pair.
    """
    if isinstance(precision, str):
        precision = PRECISION_TIERS[precision]
    x = feats.astype(dtype)
    for i, (w, b) in enumerate(params):
        x = (
            jax.lax.dot_general(
                x,
                w.astype(dtype),
                (((x.ndim - 1,), (0,)), ((), ())),
                precision=precision,
                preferred_element_type=jnp.float32,
            )
            + b
        )
        if i < len(params) - 1:
            x = jnp.tanh(x).astype(dtype)
    return x.astype(jnp.float32)


def predict_plane(params, r0, rs, cos_psi, sin_psi, *, dtype=jnp.float32,
                  precision=None):
    """Reduced-coordinate prediction -> (delta, capture_prob).

    delta = envelope * head-coefficient (module docstring): the fp32
    envelope carries the deflection magnitude, the net the O(1) shape.
    """
    out = mlp_apply(params, ray_features(r0, rs, cos_psi, sin_psi),
                    dtype=dtype, precision=precision)
    delta = delta_envelope(r0, rs, sin_psi, cos_psi) * out[..., 0]
    return delta, jax.nn.sigmoid(out[..., 1])


def predict_directions(
    params, origins, directions, bh_pos, rs, *, dtype=jnp.float32,
    precision=None,
):
    """Full 3-D prediction: (final_vel unit (...,3), captured bool (...,)).

    Reconstructs the plane basis per ray, evaluates the network on the
    reduced coordinates, and rotates the incoming direction by the
    predicted deflection inside the plane.
    """
    d = jnp.asarray(directions, jnp.float32)
    d = d / jnp.sqrt(jnp.sum(d * d, axis=-1, keepdims=True))
    rel = jnp.asarray(origins, jnp.float32) - jnp.asarray(bh_pos, jnp.float32)
    r0 = jnp.sqrt(jnp.sum(rel * rel, axis=-1))
    u_hat = rel / r0[..., None]
    c = jnp.sum(d * u_hat, axis=-1)
    w_vec = d - c[..., None] * u_hat
    s_raw = jnp.sqrt(jnp.sum(w_vec * w_vec, axis=-1))
    # radial rays (s ~ 0) have an undefined plane; they also have zero
    # deflection, so the guarded w_hat contribution is multiplied by ~sin(psi)
    w_hat = w_vec / jnp.maximum(s_raw, 1e-12)[..., None]
    s = jnp.clip(s_raw, 0.0, 1.0)
    delta, p_cap = predict_plane(params, r0, rs, c, s, dtype=dtype,
                                 precision=precision)
    # angle-addition instead of arctan2 + two trig evals:
    # cos(psi + delta) = c cos(delta) - s sin(delta), etc. — only the
    # predicted delta needs a real sin/cos pair
    cd = jnp.cos(delta)
    sd = jnp.sin(delta)
    cos_phi = c * cd - s * sd
    sin_phi = s * cd + c * sd
    v = cos_phi[..., None] * u_hat + sin_phi[..., None] * w_hat
    v = v / jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True))
    return v, p_cap > 0.5


# ---------------------------------------------------------------------------
# training data (targets from the oracle tracer)


def sample_rays(
    key,
    n: int,
    rs,
    *,
    r_range=(3.0, 60.0),
    boundary_frac=0.5,
):
    """Sample reduced-coordinate training rays in the canonical plane.

    `rs` is a given (n,) array (the caller structures it — the oracle
    tracer wants scalar rs per trace call, so make_dataset groups rays by
    rs and vmaps over groups). Returns (origins (n,3), dirs (n,3),
    r0 (n,), psi (n,)) with u_hat = +x, w_hat = +y (fully general by
    planar symmetry). Half the angles (boundary_frac) concentrate near
    the capture-critical angle where the deflection function is steep;
    the rest are uniform on [0, pi].
    """
    k_r, k_psi, k_mix, k_off = jax.random.split(key, 4)
    rs = jnp.asarray(rs, jnp.float32)
    lo = jnp.maximum(jnp.float32(r_range[0]), 1.3 * rs)
    hi = jnp.float32(r_range[1])
    r0 = jnp.exp(
        jax.random.uniform(k_r, (n,), jnp.float32)
        * (jnp.log(hi) - jnp.log(lo))
        + jnp.log(lo)
    )
    psi_uniform = jax.random.uniform(k_psi, (n,), jnp.float32, 0.0, jnp.pi)
    # critical angle of the GR impact parameter seen from r0 (the Euler
    # dynamics' true boundary is nearby). The spread must SCALE with the
    # critical angle: the deflection fold's angular width is O(sin_crit)
    # = O(rs/r0), so a fixed 0.25-rad spread wastes nearly all boundary
    # samples on far-from-critical angles for small-rs/large-r0 scenes
    # (e.g. the (r0=35, rs=0.65) domain corner, where sin_crit ~ 0.05).
    sin_crit = jnp.clip(_BC_FACTOR * rs / r0, 0.0, 1.0)
    psi_crit = jnp.pi - jnp.arcsin(sin_crit)
    spread = jnp.clip(3.0 * sin_crit, 0.02, 0.25)
    psi_boundary = jnp.clip(
        psi_crit
        + jax.random.normal(k_off, (n,), jnp.float32) * spread,
        0.0,
        jnp.pi,
    )
    use_boundary = (
        jax.random.uniform(k_mix, (n,), jnp.float32) < boundary_frac
    )
    psi = jnp.where(use_boundary, psi_boundary, psi_uniform)
    origins = jnp.stack(
        [r0, jnp.zeros_like(r0), jnp.zeros_like(r0)], axis=-1
    )
    dirs = jnp.stack(
        [jnp.cos(psi), jnp.sin(psi), jnp.zeros_like(psi)], axis=-1
    )
    return origins, dirs, r0, psi


def make_dataset(
    key,
    n: int,
    *,
    max_steps: int = 500,
    dt: float = 0.1,
    chunk: int = 1048576,
    r_range=(3.0, 60.0),
    rs_range=(0.5, 4.0),
):
    """Trace n sampled rays with the oracle -> training arrays.

    Returns dict of (n,) fp32 arrays: r0, rs, cos_psi, sin_psi, a, b,
    captured — where (a, b) are the final-direction components in the
    canonical plane basis.
    """
    from ..ops.trace import STATUS_CAPTURED, TraceConfig, trace_rays

    cfg = TraceConfig(dt=dt)
    outs = {k: [] for k in ("r0", "rs", "cos_psi", "sin_psi", "a", "b", "captured")}
    # The oracle broadcasts rs as a scalar; rays are grouped by rs and the
    # trace vmapped over the (scalar-rs) group axis.
    groups = 64
    chunk = (max(chunk // groups, 1)) * groups
    traced = jax.jit(
        jax.vmap(
            lambda o, d, rs: trace_rays(
                o, d, jnp.zeros(3, jnp.float32), rs, jnp.float32(0.0),
                max_steps, cfg,
            )
        )
    )
    # one stacked (7, m) device->host fetch per chunk instead of seven:
    # each device_get pays a fixed latency
    @jax.jit
    def stack_chunk(origins, dirs, r0, psi, rs, rs_g):
        res = traced(
            origins.reshape(groups, -1, 3),
            dirs.reshape(groups, -1, 3),
            rs_g,
        )
        m = r0.shape[0]
        fv = res.final_vel.reshape(m, 3)
        return jnp.stack(
            [
                r0,
                rs,
                jnp.cos(psi),
                jnp.sin(psi),
                fv[:, 0],
                fv[:, 1],
                (res.status.reshape(m) == STATUS_CAPTURED).astype(
                    jnp.float32
                ),
            ]
        )

    names = ("r0", "rs", "cos_psi", "sin_psi", "a", "b", "captured")
    done = 0
    while done < n:
        m = min(chunk, n - done)
        m = (max(m // groups, 1)) * groups
        key, k_rs, sub = jax.random.split(key, 3)
        rs_g = jax.random.uniform(
            k_rs, (groups,), jnp.float32, rs_range[0], rs_range[1]
        )
        rs = jnp.repeat(rs_g, m // groups)
        origins, dirs, r0, psi = sample_rays(sub, m, rs, r_range=r_range)
        block = np.asarray(stack_chunk(origins, dirs, r0, psi, rs, rs_g))
        for i, name in enumerate(names):
            outs[name].append(block[i])
        done += m
    return {k: jnp.asarray(np.concatenate(v)) for k, v in outs.items()}


# ---------------------------------------------------------------------------
# training


@dataclasses.dataclass(frozen=True)
class TrainResult:
    params: tuple
    loss_history: np.ndarray  # (epochs,) mean loss per logging window
    final_loss: float


def loss_fn(params, batch):
    """Periodic direction loss (masked to non-captured rays) + capture BCE."""
    feats = ray_features(
        batch["r0"], batch["rs"], batch["cos_psi"], batch["sin_psi"]
    )
    out = mlp_apply(params, feats)
    delta = delta_envelope(
        batch["r0"], batch["rs"], batch["sin_psi"], batch["cos_psi"]
    ) * out[..., 0]
    logit = out[..., 1]
    phi = jnp.arctan2(batch["sin_psi"], batch["cos_psi"]) + delta
    live = 1.0 - batch["captured"]
    dir_err = (jnp.cos(phi) - batch["a"]) ** 2 + (jnp.sin(phi) - batch["b"]) ** 2
    dir_loss = jnp.sum(dir_err * live) / jnp.maximum(jnp.sum(live), 1.0)
    cap_loss = jnp.mean(
        jnp.maximum(logit, 0.0)
        - logit * batch["captured"]
        + jnp.log1p(jnp.exp(-jnp.abs(logit)))
    )
    return dir_loss + 0.1 * cap_loss


def train(
    key,
    dataset,
    *,
    hidden: tuple[int, ...] = DEFAULT_HIDDEN,
    steps: int = 20000,
    batch_size: int = 16384,
    lr: float = 3e-4,
    log_every: int = 1000,
    warm_start=None,
) -> TrainResult:
    """Adam training, fully fused on-device: the whole run is a lax.scan
    (one dispatch per log window).

    `warm_start`: existing params to fine-tune (workload distillation —
    the GravLensX recipe the roadmap cites trains per-scene networks;
    narrowing the (r0, rs) domain to a scene's manifold buys several-x
    accuracy at identical inference cost). `hidden` is ignored then.
    """
    import optax

    k_init, k_data = jax.random.split(key)
    params = warm_start if warm_start is not None else init_params(k_init, hidden)
    sched = optax.warmup_cosine_decay_schedule(
        0.0, lr, min(1000, max(steps // 10, 1)), steps, end_value=lr * 0.01
    )
    opt = optax.adam(sched)
    opt_state = opt.init(params)
    n = dataset["r0"].shape[0]

    # the dataset rides as a jit ARGUMENT (device buffers), never as a
    # closure constant: captured constants are serialized into the HLO,
    # and a 12M-ray dataset (~340 MB of literals) would bloat the program
    # and the compile cache
    @jax.jit
    def run_window(params, opt_state, keys, data):
        def step(carry, k):
            params, opt_state = carry
            idx = jax.random.randint(k, (batch_size,), 0, n)
            batch = {key_: v[idx] for key_, v in data.items()}
            loss, grads = jax.value_and_grad(loss_fn)(params, batch)
            updates, opt_state = opt.update(grads, opt_state)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), loss

        (params, opt_state), losses = jax.lax.scan(
            step, (params, opt_state), keys
        )
        return params, opt_state, jnp.mean(losses)

    history = []
    done = 0
    while done < steps:
        m = min(log_every, steps - done)
        k_data, sub = jax.random.split(k_data)
        keys = jax.random.split(sub, m)
        params, opt_state, mean_loss = run_window(
            params, opt_state, keys, dataset
        )
        history.append(float(mean_loss))
        done += m
    return TrainResult(
        params=params,
        loss_history=np.asarray(history),
        final_loss=history[-1],
    )


def evaluate(params, dataset):
    """Held-out metrics: median/p99 angular error (deg, non-captured rays)
    and capture-classification accuracy."""
    feats = ray_features(
        dataset["r0"], dataset["rs"], dataset["cos_psi"], dataset["sin_psi"]
    )
    out = mlp_apply(params, feats)
    delta = delta_envelope(
        dataset["r0"], dataset["rs"], dataset["sin_psi"], dataset["cos_psi"]
    ) * out[..., 0]
    logit = out[..., 1]
    phi = jnp.arctan2(dataset["sin_psi"], dataset["cos_psi"]) + delta
    cosang = jnp.clip(
        jnp.cos(phi) * dataset["a"] + jnp.sin(phi) * dataset["b"], -1.0, 1.0
    )
    ang = jnp.degrees(jnp.arccos(cosang))
    live = dataset["captured"] < 0.5
    ang_live = jnp.where(live, ang, jnp.nan)
    cap_pred = logit > 0.0
    acc = jnp.mean((cap_pred == (dataset["captured"] > 0.5)).astype(jnp.float32))
    return {
        "median_deg": float(jnp.nanmedian(ang_live)),
        "p99_deg": float(jnp.nanpercentile(ang_live, 99.0)),
        "capture_acc": float(acc),
    }


def distill_for_scene(
    key,
    r0: float,
    rs: float,
    *,
    base_params=None,
    rays: int = 1_000_000,
    steps: int = 8_000,
    max_steps: int = 500,
    dt: float = 0.1,
    r_margin: float = 1.3,
    batch_size: int = 16384,
    lr: float = 1e-4,
    eval_rays: int = 131_072,
):
    """Per-scene distillation as a first-class on-device operation.

    The GravLensX regime the roadmap cites (reference docs/
    ROADMAP.md:1217-1337) trains per-scene networks; here that is a
    short on-device operation rather than an offline pipeline: narrow the
    sampling domain to the scene's manifold (r0 within a x`r_margin`
    band of the camera radius, rs fixed), warm-start from the general
    net, and fine-tune briefly. Width is preserved by the warm start, so
    the distilled weights swap into an already-compiled renderer with
    zero recompilation.

    Returns (params, metrics, domain) where metrics are held-out
    median/p99 deflection error (deg) + capture accuracy on the
    distilled domain and domain = (r_range, rs_range) for the
    extrapolation guard.
    """
    rs = float(rs)
    r_lo = max(float(r0) / r_margin, 1.3 * rs)
    r_hi = max(float(r0) * r_margin, r_lo * 1.001)
    r_range = (r_lo, r_hi)
    rs_range = (rs, rs)
    if isinstance(key, int):
        key = jax.random.PRNGKey(key)
    k_data, k_eval, k_fit = jax.random.split(key, 3)
    dataset = make_dataset(
        k_data, rays, max_steps=max_steps, dt=dt,
        r_range=r_range, rs_range=rs_range,
    )
    eval_set = make_dataset(
        k_eval, eval_rays, max_steps=max_steps, dt=dt,
        r_range=r_range, rs_range=rs_range,
    )
    result = train(
        k_fit, dataset, steps=steps, batch_size=batch_size, lr=lr,
        warm_start=base_params,
    )
    metrics = evaluate(result.params, eval_set)
    metrics["final_loss"] = result.final_loss
    return result.params, metrics, (r_range, rs_range)
