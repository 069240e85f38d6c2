"""Reference tracer: vectorized XLA implementation of the per-pixel
geodesic ray-trace loop.

This is the correctness oracle for the Pallas kernel and the CPU-jax path of
the renderer. The loop reproduces `trace_ray` (reference:
src/ray_tracer_euler.wgsl:138-171) exactly for the Euler/Schwarzschild
configuration:

    for i in 0..max_steps:
        steps = i + 1
        rel = pos - bh;  dist = |rel|
        if dist > 100           -> escaped (background sampled with vel)
        if dist < 1.05 rs       -> captured (black)        # inside geodesic
        step;  pos = rel' + bh;  vel = normalize(vel')

Rays that exhaust max_steps also sample the background with their current
velocity (wgsl:170). The vectorized formulation uses masked updates under
one `lax.while_loop` with a global all-done early exit — the whole-array
equivalent of per-thread `break` (SURVEY.md section 5, long-context note).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..core.scene import CAPTURE_FACTOR, DEFAULT_DT, ESCAPE_RADIUS
from ..models.disk import intersect_equatorial
from .geodesic import STEP_FNS, adaptive_dt, model_acceleration, model_capture_radius

# Ray status codes.
STATUS_RUNNING = 0  # still integrating / exhausted max_steps -> background
STATUS_ESCAPED = 1  # |pos - bh| > escape_radius -> background
STATUS_CAPTURED = 2  # crossed the (padded) horizon -> black
STATUS_DISK = 3  # hit the accretion disk -> disk emission


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Static trace configuration (hashable; part of the jit cache key).

    `integrator`/`model` select kernel functions — the analog of
    the reference's hot-swappable `--shader` flag (reference: src/main.rs:30).

    `model="custom"` is the full runtime hot-swap analog (reference:
    src/lib.rs:425-429 loads arbitrary user WGSL from `--shader <path>`):
    `custom_accel` is a user-supplied acceleration in struct-of-arrays
    plane form,

        accel(rel, vel, r, r2, rs, spin) -> (ax, ay, az)

    where `rel`/`vel` are 3-tuples of same-shaped fp32 arrays and
    `r`/`r2`/`rs`/`spin` broadcast over them. ONE signature serves both
    execution paths: the XLA oracle wraps its (..., 3) state into plane
    tuples, and the Pallas kernel calls it directly on its (block,)
    register planes — the plugin is traced into the device kernel, not
    interpreted host-side. Termination keeps the reference semantics with
    `capture_r = custom_capture_factor * rs` (wgsl:62's 1.05 by default).
    """

    integrator: str = "euler"  # "euler" | "rk4" | "leapfrog"
    model: str = "schwarzschild"  # "schwarzschild" | "kerr" | "flat" | "custom"
    adaptive: bool = False  # adaptive step size (docs/ROADMAP.md:195-201)
    dt: float = DEFAULT_DT
    escape_radius: float = ESCAPE_RADIUS
    disk: bool = False  # equatorial thin accretion disk
    disk_r_isco_factor: float = 3.0  # in units of r_s
    disk_r_outer_factor: float = 10.0
    # model="custom" plugin physics (hashed by identity -> jit cache key)
    custom_accel: object = None
    custom_capture_factor: float = float(CAPTURE_FACTOR)
    # math tier of the Pallas kernel's in-loop renormalization
    # (ops/pallas_trace.py); the XLA oracle is always exact
    fast_math: bool = False

    def __post_init__(self):
        if self.model == "custom" and self.custom_accel is None:
            raise ValueError(
                "model='custom' needs custom_accel(rel, vel, r, r2, rs, spin)"
                " -> (ax, ay, az) on component-plane tuples"
            )


def custom_accel_arrays(config: TraceConfig):
    """Adapt a plane-tuple plugin acceleration to (..., 3) array state.

    Bridges `TraceConfig.custom_accel` (SoA planes, the Pallas-native form)
    into the oracle's array-of-structs convention so one plugin definition
    drives both paths.
    """
    plug = config.custom_accel

    def accel_fn(rel, vel, r, rs, spin):
        ax, ay, az = plug(
            (rel[..., 0], rel[..., 1], rel[..., 2]),
            (vel[..., 0], vel[..., 1], vel[..., 2]),
            r, r * r, rs, spin,
        )
        return jnp.stack(
            [jnp.broadcast_to(a, rel[..., 0].shape) for a in (ax, ay, az)],
            axis=-1,
        )

    return accel_fn


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TraceResult:
    """Per-pixel integration outputs, all shaped (..., ) over the pixel grid."""

    final_pos: jnp.ndarray  # (..., 3) absolute position at termination
    final_vel: jnp.ndarray  # (..., 3) unit direction at termination
    status: jnp.ndarray  # (...,) int32 STATUS_*
    steps: jnp.ndarray  # (...,) int32 steps taken (wgsl steps_taken)


def trace_rays(
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    bh_pos: jnp.ndarray,
    rs: jnp.ndarray,
    spin: jnp.ndarray,
    max_steps: int,
    config: TraceConfig = TraceConfig(),
) -> TraceResult:
    """Integrate a batch of rays to termination.

    origins/directions: fp32 (..., 3). bh_pos fp32[3]; rs/spin fp32 scalars.
    """
    rs = jnp.asarray(rs, jnp.float32)
    spin = jnp.asarray(spin, jnp.float32)
    bh_pos = jnp.asarray(bh_pos, jnp.float32)
    if config.model == "kerr":
        # exact Kerr geodesics integrate (q, p) in Hamiltonian form — a
        # different state layout than the (pos, vel) acceleration models
        return _trace_rays_kerr_schild(
            origins, directions, bh_pos, rs, spin, max_steps, config
        )
    if config.model == "custom":
        # runtime-swappable physics (the --shader hot-swap analog; see
        # TraceConfig docstring): one plane-form plugin serves oracle+kernel
        accel_fn = custom_accel_arrays(config)
        r_capture = rs * jnp.float32(config.custom_capture_factor)
    else:
        accel_fn = model_acceleration(config.model)
        r_capture = model_capture_radius(config.model, rs, spin)
    step_fn = STEP_FNS[config.integrator]
    if config.model == "schwarzschild":
        # keep the literal wgsl:62 expression for bit-parity
        r_capture = rs * CAPTURE_FACTOR
    r_isco = config.disk_r_isco_factor * rs
    r_outer = config.disk_r_outer_factor * rs

    pos0 = jnp.asarray(origins, jnp.float32)
    # wgsl:140: vel = normalize(direction)
    d = jnp.asarray(directions, jnp.float32)
    vel0 = d / jnp.sqrt(jnp.sum(d * d, axis=-1, keepdims=True))
    batch_shape = pos0.shape[:-1]
    status0 = jnp.zeros(batch_shape, jnp.int32)
    steps0 = jnp.zeros(batch_shape, jnp.int32)

    def cond(carry):
        i, pos, vel, status, steps = carry
        return jnp.logical_and(i < max_steps, jnp.any(status == STATUS_RUNNING))

    def body(carry):
        i, pos, vel, status, steps = carry
        active = status == STATUS_RUNNING
        rel = pos - bh_pos
        dist = jnp.sqrt(jnp.sum(rel * rel, axis=-1))
        # steps_taken = i + 1 for every ray still in the loop (wgsl:149)
        steps = jnp.where(active, i + 1, steps)
        escaped = active & (dist > config.escape_radius)
        captured = active & ~escaped & (dist < r_capture)
        stepping = active & ~escaped & ~captured

        dt = (
            adaptive_dt(dist, rs, config.dt)
            if config.adaptive
            else jnp.full_like(dist, config.dt)
        )
        new_rel, new_vel = step_fn(accel_fn, rel, vel, dist, rs, spin, dt)
        new_vel_n = new_vel / jnp.sqrt(
            jnp.sum(new_vel * new_vel, axis=-1, keepdims=True)
        )
        new_pos = new_rel + bh_pos

        if config.disk:
            hit, hit_rel = intersect_equatorial(rel, new_rel, r_isco, r_outer)
            hit = hit & stepping
            new_pos = jnp.where(hit[..., None], hit_rel + bh_pos, new_pos)
            status = jnp.where(hit, STATUS_DISK, status)

        m3 = stepping[..., None]
        pos = jnp.where(m3, new_pos, pos)
        vel = jnp.where(m3, new_vel_n, vel)
        status = jnp.where(escaped, STATUS_ESCAPED, status)
        status = jnp.where(captured, STATUS_CAPTURED, status)
        return i + 1, pos, vel, status, steps

    _, pos, vel, status, steps = jax.lax.while_loop(
        cond, body, (jnp.int32(0), pos0, vel0, status0, steps0)
    )
    return TraceResult(final_pos=pos, final_vel=vel, status=status, steps=steps)


def _trace_rays_kerr_schild(
    origins, directions, bh_pos, rs, spin, max_steps, config: TraceConfig
) -> TraceResult:
    """Exact Kerr null geodesics in Cartesian Kerr-Schild coordinates.

    Hamiltonian integration of (q, p) with conserved E = -p_t = 1
    (models/kerr_schild.py; reference roadmap: docs/ROADMAP.md:514-826).
    Loop structure, step semantics, and termination bookkeeping mirror the
    main trace loop; capture tests use the Kerr-Schild radial coordinate
    (the horizon lives at r_+ in KS r, not in coordinate distance).
    """
    from ..models import kerr_schild as ks

    r_capture = ks.capture_radius(rs, spin)
    r_isco = config.disk_r_isco_factor * rs
    r_outer = config.disk_r_outer_factor * rs

    q0 = jnp.asarray(origins, jnp.float32) - bh_pos
    d = jnp.asarray(directions, jnp.float32)
    d = d / jnp.sqrt(jnp.sum(d * d, axis=-1, keepdims=True))
    p0 = ks.init_momentum(q0, d, rs, spin)
    batch_shape = q0.shape[:-1]
    status0 = jnp.zeros(batch_shape, jnp.int32)
    steps0 = jnp.zeros(batch_shape, jnp.int32)

    def step_euler(q, p, dt):
        # semi-implicit: p first, then q with the updated p (the reference
        # shader's update order, wgsl:80-85, carried over to (q, p))
        _, dp = ks.derivs(q, p, rs, spin)
        p2 = p + dp * dt
        dq2, _ = ks.derivs(q, p2, rs, spin)
        return q + dq2 * dt, p2

    def step_rk4(q, p, dt):
        def f(q, p):
            return ks.derivs(q, p, rs, spin)

        k1q, k1p = f(q, p)
        k2q, k2p = f(q + 0.5 * dt * k1q, p + 0.5 * dt * k1p)
        k3q, k3p = f(q + 0.5 * dt * k2q, p + 0.5 * dt * k2p)
        k4q, k4p = f(q + dt * k3q, p + dt * k3p)
        sixth = dt * (1.0 / 6.0)
        return (
            q + sixth * (k1q + 2.0 * k2q + 2.0 * k3q + k4q),
            p + sixth * (k1p + 2.0 * k2p + 2.0 * k3p + k4p),
        )

    def step_leapfrog(q, p, dt):
        # kick-drift-kick on (q, p) with midpoint-corrected drift and a
        # corrector iteration on the final kick: the KS Hamiltonian is
        # non-separable (dq depends on q, dp on p), so naive KDK is only
        # 1st order; both one-iteration corrections restore genuine 2nd
        # order (H drift quarters when dt halves — tests/test_geodesic.py)
        # (ROADMAP.md:179-190 comparator; see geodesic.leapfrog_step)
        half = 0.5 * dt
        _, dp1 = ks.derivs(q, p, rs, spin)
        ph = p + dp1 * half
        dq_a, _ = ks.derivs(q, ph, rs, spin)
        q_mid = q + dq_a * half
        dq_b, _ = ks.derivs(q_mid, ph, rs, spin)
        q2 = q + dq_b * dt
        _, dp2a = ks.derivs(q2, ph, rs, spin)
        p_pred = ph + dp2a * half
        _, dp2 = ks.derivs(q2, p_pred, rs, spin)
        return q2, ph + dp2 * half

    step = {"euler": step_euler, "rk4": step_rk4, "leapfrog": step_leapfrog}[
        config.integrator
    ]

    def cond(carry):
        i, q, p, status, steps = carry
        return jnp.logical_and(i < max_steps, jnp.any(status == STATUS_RUNNING))

    def body(carry):
        i, q, p, status, steps = carry
        active = status == STATUS_RUNNING
        rho = jnp.sqrt(jnp.sum(q * q, axis=-1))
        r_ks = ks.ks_radius(q, rs, spin)
        steps = jnp.where(active, i + 1, steps)
        escaped = active & (rho > config.escape_radius)
        captured = active & ~escaped & (r_ks < r_capture)
        stepping = active & ~escaped & ~captured

        dt = (
            adaptive_dt(r_ks, rs, config.dt)
            if config.adaptive
            else jnp.full_like(rho, config.dt)
        )
        new_q, new_p = step(q, p, dt[..., None])

        if config.disk:
            hit, hit_rel = intersect_equatorial(q, new_q, r_isco, r_outer)
            hit = hit & stepping
            new_q = jnp.where(hit[..., None], hit_rel, new_q)
            status = jnp.where(hit, STATUS_DISK, status)

        m3 = stepping[..., None]
        q = jnp.where(m3, new_q, q)
        p = jnp.where(m3, new_p, p)
        status = jnp.where(escaped, STATUS_ESCAPED, status)
        status = jnp.where(captured, STATUS_CAPTURED, status)
        return i + 1, q, p, status, steps

    _, q, p, status, steps = jax.lax.while_loop(
        cond, body, (jnp.int32(0), q0, p0, status0, steps0)
    )
    # q and p are frozen at each ray's termination step, so evaluating the
    # coordinate direction here yields exactly the at-termination direction
    vel = ks.final_direction(q, p, rs, spin)
    return TraceResult(final_pos=q + bh_pos, final_vel=vel, status=status, steps=steps)
