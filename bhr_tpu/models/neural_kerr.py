"""Neural geodesic surrogate for Kerr spacetime (roadmap Phase 5 x Kerr).

Extends the Schwarzschild surrogate (models/neural.py — see its module
docstring for the envelope parameterization and the bf16 noise analysis)
to the exact Kerr-Schild dynamics (models/kerr_schild.py, spin axis +Y).
The reference roadmaps both pieces separately (docs/ROADMAP.md:514-826
Kerr, :1217-1337 neural surrogate); GravLensX — the roadmap's cited
speedup — is specifically a *Kerr* (and multi-BH) surrogate, so this is
the honest completion of that citation.

Symmetry reduction. Kerr is stationary + axisymmetric (+Y) + reflection
symmetric. A photon's configuration mod the symmetry group is 4 geometric
dof + 2 parameters:

    r0                 camera distance from the hole
    (cos psi, sin psi) ray angle to the radial direction (as before)
    (uy, wy, ny)       the spin axis expressed in the ray-plane basis
                       (u_hat radial, w_hat in-plane tangent,
                       n_hat = u x w the plane normal) — unit, so 2 dof
    rs, a*             Schwarzschild radius and dimensionless spin

Kerr geodesics are NOT planar off the equator (frame dragging), so the
head predicts THREE quantities: the in-plane deflection delta, an
out-of-plane tilt chi, and the capture logit:

    v_out = cos(chi) [cos(psi+delta) u + sin(psi+delta) w] + sin(chi) n

This parameterization is exact in-plane for a* = 0 (chi == 0:
Schwarzschild limit) and *exact as a representation* everywhere — any
unit final direction can be written this way; what is approximate is only
the smoothness of (delta, chi) as functions of the reduced coordinates,
which holds away from the capture boundary exactly as in the
Schwarzschild case.

Envelopes. The photon angular momentum is along +n_hat (L = r x v =
s * n), so xi = a* . ny is the prograde-ness: the equatorial critical
impact parameter interpolates from b_c = 7M (retrograde, xi = -1)
through 3 sqrt(3) M (xi = 0) to 2M (prograde, xi = +1); the quadratic
b_c(xi)/M = 5.196 - 2.5 xi - 0.696 xi^2 passes through all three exact
values and the net's log coefficient absorbs the off-equatorial
remainder. delta uses the same magnitude envelope as Schwarzschild with
this shifted critical point; chi uses it scaled by a* (chi == 0 at
a* = 0 by construction).

Targets come from the framework's own exact Kerr-Schild Hamiltonian
oracle (ops/trace.py model="kerr", the path validated against analytic
photon-ring radii in tests/test_kerr_schild.py) at the library-default
workload (max_steps=500, dt=0.1, euler).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .neural import _BC_FACTOR, mlp_apply

KERR_FEATURE_VERSION = 2
N_FEATURES_KERR = 22
DEFAULT_HIDDEN_KERR = (256, 256, 256)

# +Y is the spin axis everywhere in this framework (models/kerr_schild.py)
_SPIN_AXIS = (0.0, 1.0, 0.0)


# ---------------------------------------------------------------------------
# parameters


def init_params(key, hidden: tuple[int, ...] = DEFAULT_HIDDEN_KERR):
    """MLP [N_FEATURES_KERR, *hidden, 3]: (delta coeff, chi coeff, logit)."""
    sizes = (N_FEATURES_KERR, *hidden, 3)
    params = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        key, sub = jax.random.split(key)
        scale = jnp.sqrt(jnp.float32(1.0 / fan_in))
        w = jax.random.normal(sub, (fan_in, fan_out), jnp.float32) * scale
        b = jnp.zeros((fan_out,), jnp.float32)
        params.append((w, b))
    return tuple(params)


def save_params(path: str, params, *, meta: dict | None = None) -> None:
    arrays = {}
    for i, (w, b) in enumerate(params):
        arrays[f"w{i}"] = np.asarray(w, np.float32)
        arrays[f"b{i}"] = np.asarray(b, np.float32)
    arrays["n_layers"] = np.int32(len(params))
    arrays["kerr_feature_version"] = np.int32(KERR_FEATURE_VERSION)
    for k, v in (meta or {}).items():
        arrays[f"meta_{k}"] = np.asarray(v)
    np.savez(path, **arrays)


def load_params(path: str):
    with np.load(path) as z:
        if "kerr_feature_version" not in z.files:
            raise ValueError(
                f"weights at {path} are not a Kerr-surrogate asset "
                "(no kerr_feature_version field)"
            )
        if int(z["kerr_feature_version"]) != KERR_FEATURE_VERSION:
            raise ValueError(
                f"weights at {path} use kerr_feature_version "
                f"{int(z['kerr_feature_version'])}, code expects "
                f"{KERR_FEATURE_VERSION}"
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
# reduced coordinates, features, envelopes


def bc_factor_kerr(xi):
    """Critical impact parameter over rs as a function of xi = a* . ny.

    The prograde sense: the Kerr-Schild axis mapping std(x,y,z) ->
    (x,z,y) (models/kerr_schild.py docstring) is orientation-REVERSING,
    so positive `spin` rotates LEFT-handed about +Y and rays with
    ny < 0 are prograde — the prograde-ness is p = -xi. (Oracle-measured
    in scripts/kerr_bc_probe.py: the capture boundary RISES with ny.)

    Evaluates the exact equatorial GR formula
        b_c(p) / M = -p + 6 cos(arccos(-p) / 3)
    through a sqrt-factored polynomial (the derivative has a
    sqrt(1 - p) singularity at extremal prograde):
        b_c / M = 2 + sqrt(1 - p) * h(p),   h = deg-6 Chebyshev-derived
    max fit error 2.5e-3 M on |p| <= 0.955 (the spin cap is 0.95) —
    trig-free so the fused-kernel epilogue can mirror it exactly
    (CLAUDE.md: keep inference trig-free). Returned as b_c / rs
    (_BC_FACTOR convention: 3 sqrt(3) / 2 at p = 0).

    History: round 4 used a 3-point quadratic with the prograde sense
    FLIPPED — oracle-measured envelope error up to 4.6 M (~50 spike
    widths), the Kerr surrogate's training-loss floor
    (scripts/kerr_bc_probe.py).
    """
    xi = jnp.asarray(xi, jnp.float32)
    p = -xi
    h = 3.196512167 + p * (
        -0.406504577 + p * (
            -0.102461550 + p * (
                -0.006447487 + p * (
                    0.033141079 + p * (
                        -0.081345290 + p * (-0.090476836)
                    )
                )
            )
        )
    )
    # b_c / M, then * 0.5 for b_c / rs; sqrt(1 - p) = sqrt(1 + xi)
    return (2.0 + jnp.sqrt(jnp.maximum(1.0 + xi, 0.0)) * h) * 0.5


def redshift_factor(r0, rs):
    """sqrt(1 - rs/r0): relates the coordinate impact parameter
    r0 sin(psi) to the conserved b = L/E for a ray launched at finite
    r0 (static-frame factor; exact for Schwarzschild, leading-order in
    Kerr). Folding it into the criticality coordinate moves the
    envelope's divergence onto the oracle's measured capture boundary
    (scripts/kerr_bc_probe.py: max residual 0.36 M at the default scene
    vs 0.54 M without). Clamped away from 0 (the sampler floor is
    r0 >= 1.6 rs where the factor is 0.61)."""
    r0 = jnp.asarray(r0, jnp.float32)
    rs = jnp.asarray(rs, jnp.float32)
    return jnp.sqrt(jnp.maximum(1.0 - rs / r0, 0.04))


def reduce_ray(origins, directions, bh_pos):
    """(..., 3) origins/directions -> reduced coordinates + plane basis.

    Returns dict with r0, c (= cos psi), s (= sin psi), uy, wy, ny and the
    basis vectors u_hat, w_hat, n_hat (each (..., 3)).
    """
    d = jnp.asarray(directions, jnp.float32)
    d = d / jnp.sqrt(jnp.sum(d * d, axis=-1, keepdims=True))
    rel = jnp.asarray(origins, jnp.float32) - jnp.asarray(bh_pos, jnp.float32)
    r0 = jnp.sqrt(jnp.sum(rel * rel, axis=-1))
    u_hat = rel / r0[..., None]
    c = jnp.sum(d * u_hat, axis=-1)
    w_vec = d - c[..., None] * u_hat
    s_raw = jnp.sqrt(jnp.sum(w_vec * w_vec, axis=-1))
    w_hat = w_vec / jnp.maximum(s_raw, 1e-12)[..., None]
    s = jnp.clip(s_raw, 0.0, 1.0)
    n_hat = jnp.cross(u_hat, w_hat)
    return dict(
        r0=r0, c=c, s=s,
        uy=u_hat[..., 1], wy=w_hat[..., 1], ny=n_hat[..., 1],
        u_hat=u_hat, w_hat=w_hat, n_hat=n_hat,
    )


def ray_features_kerr(r0, rs, spin, c, s, uy, wy, ny):
    """(..., N_FEATURES_KERR) inputs — the Schwarzschild v2 map plus the
    spin block (a*, xi = a* ny, a* uy, a* wy) and the xi-shifted
    criticality pair (f_log_k, f_sign_k) at b_c(xi)."""
    r0 = jnp.asarray(r0, jnp.float32)
    rs = jnp.broadcast_to(jnp.asarray(rs, jnp.float32), r0.shape)
    spin = jnp.broadcast_to(jnp.asarray(spin, jnp.float32), r0.shape)
    mu = rs / r0
    q = jnp.clip(_BC_FACTOR * rs / (r0 * s + 1e-6), 0.0, 4.0)
    t = r0 * s / (_BC_FACTOR * rs) - 1.0
    f_log = 0.2 * jnp.log(jnp.abs(t) + 1e-3)
    f_sign = jnp.tanh(8.0 * t)
    xi = spin * ny
    bck = bc_factor_kerr(xi)
    red = redshift_factor(r0, rs)
    tk = r0 * s / (bck * rs * red) - 1.0
    f_log_k = 0.2 * jnp.log(jnp.abs(tk) + 1e-3)
    f_sign_k = jnp.tanh(8.0 * tk)
    s2 = 2.0 * s * c
    c2 = c * c - s * s
    s4 = 2.0 * s2 * c2
    c4 = c2 * c2 - s2 * s2
    s8 = 2.0 * s4 * c4
    c8 = c4 * c4 - s4 * s4
    s16 = 2.0 * s8 * c8
    c16 = c8 * c8 - s8 * s8
    return jnp.stack(
        [
            mu, c, s, q,
            0.25 * rs, 0.25 * jnp.log(r0),
            f_log, f_sign,
            s2, c2, s4, c4, s8, c8, s16, c16,
            spin, xi, spin * uy, spin * wy,
            f_log_k, f_sign_k,
        ],
        axis=-1,
    )


def kerr_envelopes(r0, rs, spin, s, c, ny):
    """(E_delta, E_chi): fp32 magnitude envelopes for the two heads.

    Same construction as models/neural.delta_envelope — including the
    inbound gate sigmoid(-8 cos psi) on the critical-b log spike (the
    divergence is physical only for rays approaching the photon sphere)
    — but with the criticality coordinate measured from the xi-shifted
    b_c(xi); the chi envelope carries an extra |a*| factor (frame
    dragging vanishes with spin)."""
    r0 = jnp.asarray(r0, jnp.float32)
    rs = jnp.asarray(rs, jnp.float32)
    spin = jnp.asarray(spin, jnp.float32)
    s = jnp.asarray(s, jnp.float32)
    c = jnp.asarray(c, jnp.float32)
    xi = spin * jnp.asarray(ny, jnp.float32)
    red = redshift_factor(r0, rs)
    tk = r0 * s / (bc_factor_kerr(xi) * rs * red) - 1.0
    spike = jnp.log1p(1.0 / (jnp.abs(tk) + 2e-2)) * jax.nn.sigmoid(-8.0 * c)
    e = (rs / r0) * s * (0.25 + spike)
    return e, e * (jnp.abs(spin) + 1e-3)


def predict_plane_kerr(params, r0, rs, spin, c, s, uy, wy, ny, *,
                       dtype=jnp.float32, precision=None):
    """Reduced-coordinate prediction -> (delta, chi, capture_prob)."""
    feats = ray_features_kerr(r0, rs, spin, c, s, uy, wy, ny)
    out = mlp_apply(params, feats, dtype=dtype, precision=precision)
    e_d, e_c = kerr_envelopes(r0, rs, spin, s, c, ny)
    return (
        e_d * out[..., 0],
        e_c * out[..., 1],
        jax.nn.sigmoid(out[..., 2]),
    )


def predict_directions_kerr(params, origins, directions, bh_pos, rs, spin,
                            *, dtype=jnp.float32, precision=None):
    """Full 3-D prediction: (final unit direction (..., 3), captured)."""
    red = reduce_ray(origins, directions, bh_pos)
    delta, chi, p_cap = predict_plane_kerr(
        params, red["r0"], rs, spin, red["c"], red["s"],
        red["uy"], red["wy"], red["ny"], dtype=dtype, precision=precision,
    )
    c, s = red["c"], red["s"]
    cd, sd = jnp.cos(delta), jnp.sin(delta)
    cos_phi = c * cd - s * sd
    sin_phi = s * cd + c * sd
    cc, sc = jnp.cos(chi), jnp.sin(chi)
    v = (
        (cc * cos_phi)[..., None] * red["u_hat"]
        + (cc * sin_phi)[..., None] * red["w_hat"]
        + sc[..., None] * red["n_hat"]
    )
    v = v / jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True))
    return v, p_cap > 0.5


# ---------------------------------------------------------------------------
# training data (targets from the exact Kerr-Schild Hamiltonian oracle)


def sample_rays_kerr(key, n: int, rs, *, spin=0.0, r_range=(3.0, 60.0),
                     boundary_frac=0.5, cth_range=(-1.0, 1.0),
                     psi_range=(0.0, float(np.pi))):
    """Sample full-3D rays: origin at polar angle theta0 from the spin
    axis (azimuth fixed by axisymmetry), direction at angle psi from the
    radial with uniform azimuth alpha around it. Returns (origins, dirs).

    Boundary concentration is per-plane: each sample's azimuth alpha
    fixes its ray-plane normal (ny = -sin(alpha) sin(theta0)), and the
    critical angle is taken at that plane's own b_c(xi) (for a* = 0.9
    the boundary spans 2.3-6.8 M across planes — a single
    Schwarzschild-centered band wastes half the boundary budget;
    scripts/kerr_bc_probe.py).

    `cth_range` restricts the origin polar angle (cos theta0 uniform in
    the band) — per-scene distillation narrows it to the camera's
    latitude, where the Kerr reduction is NOT axisymmetric-free (uy
    enters the feature map). `psi_range` restricts the non-boundary
    direction samples (a camera frame only contains initial angles in
    [pi - half_diag_fov, pi]; concentrating there buys ~2.5x effective
    sample density for per-scene distillation)."""
    k_r, k_th, k_psi, k_al, k_mix, k_off = jax.random.split(key, 6)
    rs = jnp.asarray(rs, jnp.float32)
    spin = jnp.asarray(spin, jnp.float32)
    lo = jnp.maximum(jnp.float32(r_range[0]), 1.6 * rs)
    hi = jnp.float32(r_range[1])
    r0 = jnp.exp(
        jax.random.uniform(k_r, (n,), jnp.float32)
        * (jnp.log(hi) - jnp.log(lo)) + jnp.log(lo)
    )
    # uniform on the sphere band: cos(theta0) uniform in cth_range
    cth = jax.random.uniform(
        k_th, (n,), jnp.float32, cth_range[0], cth_range[1]
    )
    sth = jnp.sqrt(jnp.maximum(1.0 - cth * cth, 0.0))
    origins = jnp.stack([r0 * sth, r0 * cth, jnp.zeros_like(r0)], axis=-1)
    u_hat = origins / r0[..., None]
    # orthonormal frame around u_hat (guard poles: sth ~ 0 -> e1 = +x)
    ex = jnp.stack(
        [cth, -sth, jnp.zeros_like(r0)], axis=-1
    )  # d(u)/d(theta): unit, orthogonal to u
    ez = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], jnp.float32), ex.shape)
    alpha = jax.random.uniform(k_al, (n,), jnp.float32, 0.0, 2.0 * jnp.pi)
    psi_uniform = jax.random.uniform(
        k_psi, (n,), jnp.float32, psi_range[0], psi_range[1]
    )
    # plane normal y-component for this alpha: n = u x perp with
    # u x ex = (0,0,-1), u x ez = (cth, -sth, 0) -> ny = -sin(alpha) sth
    ny = -jnp.sin(alpha) * sth
    sin_crit = jnp.clip(
        bc_factor_kerr(spin * ny) * rs * redshift_factor(r0, rs) / r0,
        0.0, 1.0,
    )
    psi_crit = jnp.pi - jnp.arcsin(sin_crit)
    spread = jnp.clip(3.0 * sin_crit, 0.02, 0.25)
    psi_boundary = jnp.clip(
        psi_crit + jax.random.normal(k_off, (n,), jnp.float32) * spread,
        0.0, jnp.pi,
    )
    use_b = jax.random.uniform(k_mix, (n,), jnp.float32) < boundary_frac
    psi = jnp.where(use_b, psi_boundary, psi_uniform)
    perp = (
        jnp.cos(alpha)[..., None] * ex + jnp.sin(alpha)[..., None] * ez
    )
    dirs = jnp.cos(psi)[..., None] * u_hat + jnp.sin(psi)[..., None] * perp
    return origins, dirs


def make_dataset_kerr(key, n: int, *, max_steps: int = 500, dt: float = 0.1,
                      chunk: int = 1048576, r_range=(3.0, 60.0),
                      rs_range=(0.5, 4.0), spin_range=(0.0, 0.95),
                      cth_range=(-1.0, 1.0), boundary_frac=0.5,
                      psi_range=(0.0, float(np.pi)),
                      integrator: str = "euler"):
    """Trace n sampled rays with the exact Kerr-Schild oracle.

    Returns dict of (n,) fp32 arrays: r0, rs, spin, c, s, uy, wy, ny and
    the final-direction components in the ray-plane basis (au, aw, an)
    plus captured. One stacked device->host fetch per chunk
    (models/neural.make_dataset note).
    """
    from ..ops.trace import STATUS_CAPTURED, TraceConfig, trace_rays

    cfg = TraceConfig(dt=dt, model="kerr", integrator=integrator)
    groups = 64
    chunk = (max(chunk // groups, 1)) * groups

    def one_group(origins, dirs, rs, spin):
        res = trace_rays(
            origins, dirs, jnp.zeros(3, jnp.float32), rs, spin,
            max_steps, cfg,
        )
        return res.final_vel, res.status

    @jax.jit
    def stack_chunk(origins, dirs, rs_g, spin_g):
        fv, status = jax.vmap(one_group)(origins, dirs, rs_g, spin_g)
        m = origins.shape[0] * origins.shape[1]
        o = origins.reshape(m, 3)
        d = dirs.reshape(m, 3)
        fv = fv.reshape(m, 3)
        per = origins.shape[1]
        rs = jnp.repeat(rs_g, per)
        spin = jnp.repeat(spin_g, per)
        red = reduce_ray(o, d, jnp.zeros(3, jnp.float32))
        return jnp.stack(
            [
                red["r0"], rs, spin, red["c"], red["s"],
                red["uy"], red["wy"], red["ny"],
                jnp.sum(fv * red["u_hat"], axis=-1),
                jnp.sum(fv * red["w_hat"], axis=-1),
                jnp.sum(fv * red["n_hat"], axis=-1),
                (status.reshape(m) == STATUS_CAPTURED).astype(jnp.float32),
            ]
        )

    names = ("r0", "rs", "spin", "c", "s", "uy", "wy", "ny",
             "au", "aw", "an", "captured")
    outs = {k: [] for k in names}
    done = 0
    while done < n:
        m = min(chunk, n - done)
        m = (max(m // groups, 1)) * groups
        per = m // groups
        key, k_rs, k_sp, sub = jax.random.split(key, 4)
        rs_g = jax.random.uniform(
            k_rs, (groups,), jnp.float32, rs_range[0], rs_range[1]
        )
        spin_g = jax.random.uniform(
            k_sp, (groups,), jnp.float32, spin_range[0], spin_range[1]
        )
        keys = jax.random.split(sub, groups)
        origins, dirs = jax.vmap(
            lambda k, rs, sp: sample_rays_kerr(
                k, per, rs, spin=sp, r_range=r_range, cth_range=cth_range,
                boundary_frac=boundary_frac, psi_range=psi_range,
            )
        )(keys, rs_g, spin_g)
        block = np.asarray(stack_chunk(origins, dirs, rs_g, spin_g))
        for i, name in enumerate(names):
            outs[name].append(block[i])
        done += m
    return {k: jnp.asarray(np.concatenate(v)) for k, v in outs.items()}


# ---------------------------------------------------------------------------
# training


@dataclasses.dataclass(frozen=True)
class TrainResult:
    params: tuple
    loss_history: np.ndarray
    final_loss: float


def loss_fn(params, batch, err_cap_chord2=None):
    """Direction loss on the full (au, aw, an) triple + capture BCE.

    `err_cap_chord2` saturates the per-sample squared chord error:
    rays inside the critical fold's chaotic core have irreducibly wild
    (delta, chi) targets, and without a cap they dominate the gradient
    and buy their O(1) errors with mid-field precision (the round-4
    distillation plateau). Capped samples still contribute gradient up
    to the cap; the cap is OFF (None) for general-net training."""
    feats = ray_features_kerr(
        batch["r0"], batch["rs"], batch["spin"], batch["c"], batch["s"],
        batch["uy"], batch["wy"], batch["ny"],
    )
    out = mlp_apply(params, feats)
    e_d, e_c = kerr_envelopes(
        batch["r0"], batch["rs"], batch["spin"], batch["s"], batch["c"],
        batch["ny"],
    )
    delta = e_d * out[..., 0]
    chi = e_c * out[..., 1]
    logit = out[..., 2]
    psi = jnp.arctan2(batch["s"], batch["c"])
    phi = psi + delta
    cc, sc = jnp.cos(chi), jnp.sin(chi)
    err = (
        (cc * jnp.cos(phi) - batch["au"]) ** 2
        + (cc * jnp.sin(phi) - batch["aw"]) ** 2
        + (sc - batch["an"]) ** 2
    )
    if err_cap_chord2 is not None:
        err = jnp.minimum(err, jnp.float32(err_cap_chord2))
    live = 1.0 - batch["captured"]
    dir_loss = jnp.sum(err * live) / jnp.maximum(jnp.sum(live), 1.0)
    cap_loss = jnp.mean(
        jnp.maximum(logit, 0.0)
        - logit * batch["captured"]
        + jnp.log1p(jnp.exp(-jnp.abs(logit)))
    )
    return dir_loss + 0.1 * cap_loss


def train(key, dataset, *, hidden=DEFAULT_HIDDEN_KERR, steps=40_000,
          batch_size=16384, lr=3e-4, log_every=1000, warm_start=None,
          err_cap_deg=None):
    """Adam training, fused lax.scan per log window (models/neural.train).

    `err_cap_deg` saturates the per-sample direction error at the
    chord of that angle (see loss_fn) — used by per-scene distillation."""
    import functools

    import optax

    cap2 = (
        float((2.0 * np.sin(np.radians(err_cap_deg) / 2.0)) ** 2)
        if err_cap_deg is not None
        else None
    )
    loss = functools.partial(loss_fn, err_cap_chord2=cap2)

    k_init, k_data = jax.random.split(key)
    params = warm_start if warm_start is not None else init_params(
        k_init, hidden
    )
    sched = optax.warmup_cosine_decay_schedule(
        0.0, lr, min(1000, max(steps // 10, 1)), steps, end_value=lr * 0.01
    )
    opt = optax.adam(sched)
    opt_state = opt.init(params)
    n = dataset["r0"].shape[0]

    @jax.jit
    def run_window(params, opt_state, keys, data):
        def step(carry, k):
            params, opt_state = carry
            idx = jax.random.randint(k, (batch_size,), 0, n)
            batch = {key_: v[idx] for key_, v in data.items()}
            loss_v, grads = jax.value_and_grad(loss)(params, batch)
            updates, opt_state = opt.update(grads, opt_state)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), loss_v

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
    """Held-out metrics: median/p99 angular error (deg) + capture acc."""
    feats = ray_features_kerr(
        dataset["r0"], dataset["rs"], dataset["spin"], dataset["c"],
        dataset["s"], dataset["uy"], dataset["wy"], dataset["ny"],
    )
    out = mlp_apply(params, feats)
    e_d, e_c = kerr_envelopes(
        dataset["r0"], dataset["rs"], dataset["spin"], dataset["s"],
        dataset["c"], dataset["ny"],
    )
    delta = e_d * out[..., 0]
    chi = e_c * out[..., 1]
    logit = out[..., 2]
    psi = jnp.arctan2(dataset["s"], dataset["c"])
    phi = psi + delta
    cc, sc = jnp.cos(chi), jnp.sin(chi)
    cosang = jnp.clip(
        cc * jnp.cos(phi) * dataset["au"]
        + cc * jnp.sin(phi) * dataset["aw"]
        + sc * dataset["an"],
        -1.0, 1.0,
    )
    ang = jnp.degrees(jnp.arccos(cosang))
    live = dataset["captured"] < 0.5
    ang_live = jnp.where(live, ang, jnp.nan)
    cap_pred = logit > 0.0
    acc = jnp.mean(
        (cap_pred == (dataset["captured"] > 0.5)).astype(jnp.float32)
    )
    return {
        "median_deg": float(jnp.nanmedian(ang_live)),
        "p99_deg": float(jnp.nanpercentile(ang_live, 99.0)),
        "capture_acc": float(acc),
    }


def distill_for_scene_kerr(
    key,
    r0: float,
    rs: float,
    spin: float,
    *,
    cth0: float = 0.0,
    base_params=None,
    rays: int = 2_000_000,
    steps: int = 12_000,
    max_steps: int = 500,
    dt: float = 0.1,
    r_margin: float = 1.3,
    cth_margin: float = 0.2,
    batch_size: int = 16384,
    lr: float = 1e-4,
    eval_rays: int = 131_072,
    integrator: str = "euler",
    psi_range=None,
    boundary_frac: float = 0.35,
    err_cap_deg: float | None = 5.0,
):
    """Per-scene Kerr distillation (the Kerr analog of
    models/neural.distill_for_scene — GravLensX, the roadmap's cited
    speedup at reference docs/ROADMAP.md:1217-1337, trains *per-scene*
    networks, and it is specifically a Kerr surrogate).

    The scene manifold is much narrower than the Schwarzschild one: rs
    and a* are pinned, r0 lives in a x`r_margin` band of the camera
    radius, and — because Kerr is only axisymmetric, not spherically
    symmetric — the camera's polar latitude pins cos(theta0) to a
    +-`cth_margin` band around `cth0` (the orbit camera holds a constant
    latitude, so one distilled net serves the whole orbit). Directions
    still sweep the full (psi, alpha) sphere with photon-ring boundary
    concentration. Warm-starting from the general net preserves width,
    so the distilled weights stay eligible for whatever kernel served
    the general ones, and swap into a compiled renderer with zero
    recompilation.

    Returns (params, metrics, (r_range, rs_range), spin_range).
    """
    rs = float(rs)
    spin = float(spin)
    r_lo = max(float(r0) / r_margin, 1.6 * rs)
    r_hi = max(float(r0) * r_margin, r_lo * 1.001)
    cth_lo = max(float(cth0) - cth_margin, -1.0)
    cth_hi = min(float(cth0) + cth_margin, 1.0)
    r_range = (r_lo, r_hi)
    rs_range = (rs, rs)
    spin_range = (spin, spin)
    if isinstance(key, int):
        key = jax.random.PRNGKey(key)
    k_data, k_eval, k_fit = jax.random.split(key, 3)
    common = dict(
        max_steps=max_steps, dt=dt, r_range=r_range, rs_range=rs_range,
        spin_range=spin_range, cth_range=(cth_lo, cth_hi),
        boundary_frac=boundary_frac,
        psi_range=psi_range or (0.0, float(np.pi)),
        integrator=integrator,
    )
    dataset = make_dataset_kerr(k_data, rays, **common)
    eval_set = make_dataset_kerr(k_eval, eval_rays, **common)
    result = train(
        k_fit, dataset, steps=steps, batch_size=batch_size, lr=lr,
        warm_start=base_params, err_cap_deg=err_cap_deg,
    )
    metrics = evaluate(result.params, eval_set)
    metrics["final_loss"] = result.final_loss
    return result.params, metrics, (r_range, rs_range), spin_range
