"""Pallas-Triton kernel for the geodesic ray-trace (NVIDIA GPU).

The fused per-ray loop of the renderer: the GPU counterpart of the
reference's WGSL compute shader (reference: src/ray_tracer_euler.wgsl:
173-215). One program owns a 1-D block of `block` rays (a power of two):

  * rays are generated in-kernel from the flat local pixel id
    (y = id // W_local, x = id % W_local), so only the 32-float params
    vector and, for the multires fix-up, a mask plane are read;
  * ray state (position, velocity or Kerr momentum, status, step count)
    lives in registers for the whole integration — no device-memory
    traffic inside the loop;
  * the block runs one `lax.while_loop` whose condition is "some ray of
    this block is still running", so a block inside the shadow or fully
    escaped stops early instead of waiting for the slowest ray of the
    image (the XLA oracle loops until the last ray of the frame is done);
  * finished rays freeze by select, exactly like the oracle
    (ops/trace.py), so status and per-ray step counts follow the oracle's
    semantics step for step.

The arithmetic mirrors the oracle's operation order (ops/trace.py,
ops/geodesic.py, models/*). `TraceConfig.fast_math` selects the math tier
of the per-step velocity renormalization: sqrt and three divides (exact,
the library default) or v * rsqrt(v.v) (approximate, the app default,
faster on the H100: PERF.md). The exact Kerr-Schild flavor renormalizes
nothing, so the tier does not change it. Shading stays in the XLA epilogue
(renderer.shade_image), which XLA fuses on the GPU.

`kernel_mode()` is the single platform decision of the package: compiled
Pallas-Triton on a GPU, the Pallas interpreter on the CPU (tests), and an
error anywhere else. The kernel applies it to the platform it is lowered
for (`lax.platform_dependent`), so the device a call runs on decides,
never the process's default backend.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..core.scene import CAPTURE_FACTOR
from .trace import (
    STATUS_CAPTURED,
    STATUS_DISK,
    STATUS_ESCAPED,
    STATUS_RUNNING,
    TraceConfig,
    TraceResult,
)

# Rays per program and warps per program: the fastest shape of the
# scripts/kernel_ab.py --sweep grid at 1080p x 500 on the H100 (PERF.md).
DEFAULT_BLOCK = 128
DEFAULT_NUM_WARPS = 2
assert DEFAULT_BLOCK >= 32 and DEFAULT_BLOCK & (DEFAULT_BLOCK - 1) == 0

KERNEL_COMPILED = "compiled"
KERNEL_INTERPRET = "interpret"


def kernel_mode(platform: str | None = None) -> str:
    """How Pallas kernels run on `platform` (default: JAX's backend).

    "compiled" on a GPU (Pallas through Triton; "cuda" is the GPU's
    lowering-platform name), "interpret" on the CPU (the Pallas
    interpreter, for tests; the renderer's CPU default is the XLA oracle).
    Any other platform is an error: there is no kernel for it and no silent
    fallback.
    """
    platform = jax.default_backend() if platform is None else platform
    if platform in ("gpu", "cuda"):
        return KERNEL_COMPILED
    if platform == "cpu":
        return KERNEL_INTERPRET
    raise RuntimeError(
        f"bhr_tpu has no kernel route for platform {platform!r}: it runs "
        "compiled on an NVIDIA GPU, or on the CPU through the XLA oracle "
        "and the Pallas interpreter"
    )


# params vector layout (fp32[32])
_P_CAM = 0  # 0:3 camera position
_P_FWD = 3  # 3:6 forward
_P_RIGHT = 6  # 6:9 right
_P_UP = 9  # 9:12 up
_P_BH = 12  # 12:15 black hole position
_P_RS = 15
_P_FOVF = 16  # tan(fov / 2)
_P_SPIN = 17
_P_CAP = 18  # capture radius
_P_WF = 19  # float(width) — FULL image width (for ray-gen UVs)
_P_HF = 20  # float(height) — FULL image height
_P_ASPECT = 21
_P_ROW0 = 22  # first global pixel row of this band (0 on a single device)
_P_SIZE = 32


def build_params(camera, scene, config: TraceConfig, row0=0):
    """Pack camera/scene dynamics into the fp32[32] params vector.

    `row0` offsets the in-kernel ray-gen for row-band sharding
    (parallel/mesh.py) and the multires halo; UVs always reference the full
    image dimensions from `scene`.
    """
    from .geodesic import model_capture_radius

    rs = jnp.asarray(scene.schwarzschild_radius, jnp.float32)
    spin = jnp.asarray(scene.spin, jnp.float32)
    if config.model == "schwarzschild":
        capture_r = rs * CAPTURE_FACTOR  # wgsl:62 literal
    elif config.model == "custom":
        capture_r = rs * jnp.float32(config.custom_capture_factor)
    else:
        capture_r = model_capture_radius(config.model, rs, spin)
    w = jnp.float32(scene.screen_width)
    h = jnp.float32(scene.screen_height)
    vals = [
        *(camera.position[k] for k in range(3)),
        *(camera.forward[k] for k in range(3)),
        *(camera.right[k] for k in range(3)),
        *(camera.up[k] for k in range(3)),
        *(jnp.asarray(scene.black_hole_position, jnp.float32)[k] for k in range(3)),
        rs,
        jnp.tan(jnp.asarray(scene.fov, jnp.float32) * 0.5),
        spin,
        capture_r,
        w,
        h,
        w / h,
        row0,
    ]
    vals = [jnp.asarray(v, jnp.float32) for v in vals]
    vals += [jnp.float32(0.0)] * (_P_SIZE - len(vals))
    return jnp.stack(vals)


# ---- tuple-vec3 helpers over (block,) planes -------------------------------


def _vdot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _vaxpy(a, b, s):  # a + b * s
    return (a[0] + b[0] * s, a[1] + b[1] * s, a[2] + b[2] * s)


def _vwhere(m, a, b):
    return tuple(jnp.where(m, x, y) for x, y in zip(a, b))


def _vnorm(v):
    s = jnp.sqrt(_vdot(v, v))
    return (v[0] / s, v[1] / s, v[2] / s)


def _vnorm_rsqrt(v):
    """v * rsqrt(v.v): the fast_math tier of the in-loop renormalization
    (approximate on the GPU; within the oracle parity contract)."""
    s = lax.rsqrt(_vdot(v, v))
    return (v[0] * s, v[1] * s, v[2] * s)


# ---- physics on component planes (mirrors the oracle's modules) -------------


def _accel_fn(config: TraceConfig):
    """accel(rel, vel, r, rs, spin) on planes for the acceleration models.

    Mirrors models/schwarzschild.acceleration (wgsl:69-79), models/kerr
    (Lense-Thirring drag, spin axis +Y) and models/flat; model="custom"
    calls the user plug-in (TraceConfig.custom_accel) on the same planes.
    """
    if config.model == "custom":
        plug = config.custom_accel
        return lambda rel, vel, r, rs, spin: plug(rel, vel, r, r * r, rs, spin)
    if config.model == "flat":
        return lambda rel, vel, r, rs, spin: tuple(jnp.zeros_like(c) for c in vel)

    def schwarzschild(rel, vel, r, rs, spin):
        r_vec = (rel[0] / r, rel[1] / r, rel[2] / r)
        v_rad = _vdot(vel, r_vec)
        rs_over_r = rs / r
        factor = rs / (2.0 * r * r * (1.0 - rs_over_r))
        one_m = 1.0 - rs_over_r
        one_p = 1.0 + rs_over_r
        return tuple(
            -factor * (vel[k] * one_m - r_vec[k] * v_rad * one_p) for k in range(3)
        )

    if config.model == "schwarzschild":
        return schwarzschild

    def kerr_lt(rel, vel, r, rs, spin):
        ax, ay, az = schwarzschild(rel, vel, r, rs, spin)
        m = rs * 0.5
        j = spin * m * m
        r_hat = (rel[0] / r, rel[1] / r, rel[2] / r)
        jr3 = j / (r * r * r)
        jdotr = r_hat[1]
        bg = (
            jr3 * (3.0 * jdotr * r_hat[0]),
            jr3 * (3.0 * jdotr * r_hat[1] - 1.0),
            jr3 * (3.0 * jdotr * r_hat[2]),
        )
        return (
            ax + (vel[1] * bg[2] - vel[2] * bg[1]),
            ay + (vel[2] * bg[0] - vel[0] * bg[2]),
            az + (vel[0] * bg[1] - vel[1] * bg[0]),
        )

    if config.model == "kerr_lt":
        return kerr_lt
    raise ValueError(f"no plane acceleration for model {config.model!r}")


def _step_fn(integrator: str, accel):
    """(rel, vel, r, rs, spin, dt) -> (rel', vel') — ops/geodesic.STEP_FNS."""

    def guarded_r(p, rs):
        return jnp.maximum(jnp.sqrt(_vdot(p, p)), 1.0001 * jnp.maximum(rs, 1e-6))

    def euler(rel, vel, r, rs, spin, dt):
        a = accel(rel, vel, r, rs, spin)
        nv = _vaxpy(vel, a, dt)
        return _vaxpy(rel, nv, dt), nv

    def rk4(rel, vel, r, rs, spin, dt):
        def deriv(p, v):
            return v, accel(p, v, guarded_r(p, rs), rs, spin)

        half = 0.5 * dt
        k1p, k1v = deriv(rel, vel)
        k2p, k2v = deriv(_vaxpy(rel, k1p, half), _vaxpy(vel, k1v, half))
        k3p, k3v = deriv(_vaxpy(rel, k2p, half), _vaxpy(vel, k2v, half))
        k4p, k4v = deriv(_vaxpy(rel, k3p, dt), _vaxpy(vel, k3v, dt))
        sixth = dt * (1.0 / 6.0)

        def comb(k1, k2, k3, k4):
            return tuple(k1[k] + 2.0 * k2[k] + 2.0 * k3[k] + k4[k] for k in range(3))

        return (
            _vaxpy(rel, comb(k1p, k2p, k3p, k4p), sixth),
            _vaxpy(vel, comb(k1v, k2v, k3v, k4v), sixth),
        )

    def leapfrog(rel, vel, r, rs, spin, dt):
        half = 0.5 * dt
        vh = _vaxpy(vel, accel(rel, vel, r, rs, spin), half)
        new_rel = _vaxpy(rel, vh, dt)
        rr = guarded_r(new_rel, rs)
        vp = _vaxpy(vh, accel(new_rel, vh, rr, rs, spin), half)
        return new_rel, _vaxpy(vh, accel(new_rel, vp, rr, rs, spin), half)

    return {"euler": euler, "rk4": rk4, "leapfrog": leapfrog}[integrator]


_KS_EPS = 1e-12


def _ks_r2(q, a2):
    """Kerr-Schild radial coordinate squared (models/kerr_schild.ks_radius)."""
    x, y, z = q
    b = (x * x + y * y + z * z) - a2
    disc = jnp.sqrt(b * b + 4.0 * a2 * (y * y))
    return jnp.maximum(0.5 * (b + disc), _KS_EPS)


def _ks_derivs(q, p, rs, a):
    """Plane transcription of models/kerr_schild.derivs (same expression
    trees: the flow is chaotic at the shadow edge, so regroupings show)."""
    m = rs * 0.5
    a2 = a * a
    x, y, z = q
    px, py, pz = p
    r2 = _ks_r2(q, a2)
    r = jnp.sqrt(r2)
    y2 = y * y
    w = r2 * r2 + a2 * y2
    inv_w = 1.0 / w
    r3 = r2 * r
    f = (2.0 * m) * r3 * inv_w
    bb = r2 + a2
    inv_bb = 1.0 / bb
    lx = (r * x + a * z) * inv_bb
    inv_r = 1.0 / r
    ly = y * inv_r
    lz = (r * z - a * x) * inv_bb
    r_w = r * inv_w
    drx = r_w * r2 * x
    dry = r_w * bb * y
    drz = r_w * r2 * z
    g1 = (2.0 * m) * (3.0 * r2 * w - 4.0 * r3 * r3) * (inv_w * inv_w)
    g2 = (4.0 * m) * a2 * r3 * (inv_w * inv_w)
    dfx = g1 * drx
    dfy = g1 * dry - g2 * y
    dfz = g1 * drz
    two_r_invbb = 2.0 * r * inv_bb
    inv_r2 = inv_r * inv_r
    dlx_x = (x * drx + r) * inv_bb - lx * (two_r_invbb * drx)
    dlx_y = (x * dry) * inv_bb - lx * (two_r_invbb * dry)
    dlx_z = (x * drz + a) * inv_bb - lx * (two_r_invbb * drz)
    dly_x = -y * inv_r2 * drx
    dly_y = inv_r - y * inv_r2 * dry
    dly_z = -y * inv_r2 * drz
    dlz_x = (z * drx - a) * inv_bb - lz * (two_r_invbb * drx)
    dlz_y = (z * dry) * inv_bb - lz * (two_r_invbb * dry)
    dlz_z = (z * drz + r) * inv_bb - lz * (two_r_invbb * drz)
    s = 1.0 + lx * px + ly * py + lz * pz
    fs = f * s
    dq = (px - fs * lx, py - fs * ly, pz - fs * lz)
    hs2 = 0.5 * s * s
    dp = (
        hs2 * dfx + fs * (dlx_x * px + dly_x * py + dlz_x * pz),
        hs2 * dfy + fs * (dlx_y * px + dly_y * py + dlz_y * pz),
        hs2 * dfz + fs * (dlx_z * px + dly_z * py + dlz_z * pz),
    )
    return dq, dp


def _ks_step_fn(integrator: str):
    """(q, p, rs, a, dt) -> (q', p') — ops/trace._trace_rays_kerr_schild."""

    def euler(q, p, rs, a, dt):
        _, dp = _ks_derivs(q, p, rs, a)
        p2 = _vaxpy(p, dp, dt)
        dq2, _ = _ks_derivs(q, p2, rs, a)
        return _vaxpy(q, dq2, dt), p2

    def rk4(q, p, rs, a, dt):
        half = 0.5 * dt
        k1q, k1p = _ks_derivs(q, p, rs, a)
        k2q, k2p = _ks_derivs(_vaxpy(q, k1q, half), _vaxpy(p, k1p, half), rs, a)
        k3q, k3p = _ks_derivs(_vaxpy(q, k2q, half), _vaxpy(p, k2p, half), rs, a)
        k4q, k4p = _ks_derivs(_vaxpy(q, k3q, dt), _vaxpy(p, k3p, dt), rs, a)
        sixth = dt * (1.0 / 6.0)

        def comb(k1, k2, k3, k4):
            return tuple(k1[k] + 2.0 * k2[k] + 2.0 * k3[k] + k4[k] for k in range(3))

        return (
            _vaxpy(q, comb(k1q, k2q, k3q, k4q), sixth),
            _vaxpy(p, comb(k1p, k2p, k3p, k4p), sixth),
        )

    def leapfrog(q, p, rs, a, dt):
        half = 0.5 * dt
        _, dp1 = _ks_derivs(q, p, rs, a)
        ph = _vaxpy(p, dp1, half)
        dq_a, _ = _ks_derivs(q, ph, rs, a)
        q_mid = _vaxpy(q, dq_a, half)
        dq_b, _ = _ks_derivs(q_mid, ph, rs, a)
        q2 = _vaxpy(q, dq_b, dt)
        _, dp2a = _ks_derivs(q2, ph, rs, a)
        p_pred = _vaxpy(ph, dp2a, half)
        _, dp2 = _ks_derivs(q2, p_pred, rs, a)
        return q2, _vaxpy(ph, dp2, half)

    return {"euler": euler, "rk4": rk4, "leapfrog": leapfrog}[integrator]


def _ks_init_momentum(q, d, rs, a):
    """Plane transcription of models/kerr_schild.init_momentum."""
    a2 = a * a
    x, y, z = q
    r2 = _ks_r2(q, a2)
    r = jnp.sqrt(r2)
    w = r2 * r2 + a2 * y * y
    f = rs * r2 * r / w
    bb = r2 + a2
    lx = (r * x + a * z) / bb
    ly = y / r
    lz = (r * z - a * x) / bb
    c = lx * d[0] + ly * d[1] + lz * d[2]
    disc = jnp.sqrt(jnp.maximum(1.0 - f * (1.0 - c * c), _KS_EPS))
    ut = (f * c + disc) / jnp.maximum(1.0 - f, 1e-6)
    fl = f * (ut + c)
    e_inv = 1.0 / jnp.maximum(ut - fl, _KS_EPS)
    return tuple((d[k] + fl * l) * e_inv for k, l in enumerate((lx, ly, lz)))


def _ks_direction(q, p, rs, a):
    """models/kerr_schild.final_direction on planes."""
    dq, _ = _ks_derivs(q, p, rs, a)
    n = jnp.sqrt(jnp.maximum(_vdot(dq, dq), _KS_EPS))
    return (dq[0] / n, dq[1] / n, dq[2] / n)


# ---- the kernel -------------------------------------------------------------


def _make_kernel(config: TraceConfig, max_steps: int, block: int,
                 local_w: int, n_pix: int, stride: int, masked: bool):
    """Kernel body for one static configuration (see module docstring)."""
    is_ks = config.model == "kerr"
    if is_ks:
        ks_step = _ks_step_fn(config.integrator)
    else:
        step = _step_fn(config.integrator, _accel_fn(config))
        renorm = _vnorm_rsqrt if config.fast_math else _vnorm

    def kernel(params_ref, *refs):
        if masked:
            mask_ref, *outs = refs
        else:
            mask_ref, outs = None, refs
        px_o, py_o, pz_o, vx_o, vy_o, vz_o, status_o, steps_o = outs

        def prm(k):
            return params_ref[k]

        cam = tuple(prm(_P_CAM + k) for k in range(3))
        fwd = tuple(prm(_P_FWD + k) for k in range(3))
        right = tuple(prm(_P_RIGHT + k) for k in range(3))
        up = tuple(prm(_P_UP + k) for k in range(3))
        bh = tuple(prm(_P_BH + k) for k in range(3))
        rs = prm(_P_RS)
        spin = prm(_P_SPIN)
        fov_factor = prm(_P_FOVF)
        capture_r = prm(_P_CAP)
        r_isco = config.disk_r_isco_factor * rs
        r_outer = config.disk_r_outer_factor * rs

        # ray-gen from the flat local pixel id (wgsl:183-198): pixel-index
        # UVs, Y flip, aspect, fov — the operation order of
        # core.camera.generate_rays
        pid = pl.program_id(0) * block + lax.broadcasted_iota(jnp.int32, (block,), 0)
        row = lax.div(pid, local_w)
        col = pid - row * local_w
        rows_f = (row * stride).astype(jnp.float32) + prm(_P_ROW0)
        cols_f = (col * stride).astype(jnp.float32)
        u = (cols_f / prm(_P_WF) - 0.5) * 2.0
        v = (rows_f / prm(_P_HF) - 0.5) * -2.0
        uf = (u * prm(_P_ASPECT)) * fov_factor
        vf = v * fov_factor
        d = tuple(fwd[k] + right[k] * uf + up[k] * vf for k in range(3))
        vel0 = _vnorm(_vnorm(d))  # generate_rays, then trace_rays' wgsl:140

        # padding rays and masked-off rays (multires fix-up) start finished:
        # they never hold their block in the loop
        live0 = pid < n_pix
        if masked:
            live0 = live0 & (mask_ref[...] > 0.0)
        status0 = jnp.where(live0, STATUS_RUNNING, STATUS_ESCAPED).astype(jnp.int32)
        zeros_i = jnp.zeros((block,), jnp.int32)
        zeros_f = jnp.zeros((block,), jnp.float32)
        rel0 = tuple(zeros_f + (cam[k] - bh[k]) for k in range(3))
        if is_ks:
            a_spin = spin * (rs * 0.5)
            vel0 = _ks_init_momentum(rel0, vel0, rs, a_spin)

        def cond(carry):
            i, status = carry[0], carry[7]
            running = jnp.max((status == STATUS_RUNNING).astype(jnp.int32))
            return jnp.logical_and(i < max_steps, running > 0)

        def body(carry):
            i, rx, ry, rz, vx, vy, vz, status, steps = carry
            rel, vel = (rx, ry, rz), (vx, vy, vz)
            active = status == STATUS_RUNNING
            dist = jnp.sqrt(_vdot(rel, rel))
            steps = jnp.where(active, i + 1, steps)
            if is_ks:
                r_test = jnp.sqrt(_ks_r2(rel, a_spin * a_spin))
            else:
                r_test = dist
            escaped = active & (dist > config.escape_radius)
            captured = active & ~escaped & (r_test < capture_r)
            stepping = active & ~escaped & ~captured
            if config.adaptive:
                dt = config.dt * jnp.clip((r_test - rs) * 0.1, 0.01, 1.0)
            else:
                dt = jnp.float32(config.dt)
            if is_ks:
                new_rel, new_vel = ks_step(rel, vel, rs, a_spin, dt)
            else:
                new_rel, new_vel = step(rel, vel, dist, rs, spin, dt)
                new_vel = renorm(new_vel)
            if config.disk:
                # models/disk.intersect_equatorial on planes
                oy, ny = rel[1], new_rel[1]
                crosses = oy * ny < 0.0
                t = -oy / jnp.where(crosses, ny - oy, 1.0)
                hit_rel = tuple(rel[k] + t * (new_rel[k] - rel[k]) for k in range(3))
                hr = jnp.sqrt(_vdot(hit_rel, hit_rel))
                hit = crosses & (hr >= r_isco) & (hr <= r_outer) & stepping
                new_rel = _vwhere(hit, hit_rel, new_rel)
                status = jnp.where(hit, STATUS_DISK, status)
            rel = _vwhere(stepping, new_rel, rel)
            vel = _vwhere(stepping, new_vel, vel)
            status = jnp.where(escaped, STATUS_ESCAPED, status)
            status = jnp.where(captured, STATUS_CAPTURED, status)
            return (i + 1, *rel, *vel, status, steps)

        init = (jnp.int32(0), *rel0, *vel0, status0, zeros_i)
        _, rx, ry, rz, vx, vy, vz, status, steps = lax.while_loop(cond, body, init)
        rel, vel = (rx, ry, rz), (vx, vy, vz)
        if is_ks:
            # q, p froze at termination: this is the at-termination direction
            vel = _ks_direction(rel, vel, rs, a_spin)
        px_o[...] = rel[0] + bh[0]
        py_o[...] = rel[1] + bh[1]
        pz_o[...] = rel[2] + bh[2]
        vx_o[...] = vel[0]
        vy_o[...] = vel[1]
        vz_o[...] = vel[2]
        status_o[...] = status
        steps_o[...] = steps

    return kernel


@functools.partial(
    jax.jit,
    static_argnames=(
        "local_shape", "max_steps", "config", "block", "num_warps", "stride",
    ),
)
def _pallas_trace(params, mask, *, local_shape, max_steps, config, block,
                  num_warps, stride):
    height, width = local_shape
    n_pix = height * width
    n_pad = -(-n_pix // block) * block
    masked = mask is not None
    kernel = _make_kernel(config, max_steps, block, width, n_pix, stride, masked)
    ray_spec = pl.BlockSpec((block,), lambda i: (i,))
    in_specs = [pl.BlockSpec((_P_SIZE,), lambda i: (0,))]
    operands = [params]
    if masked:
        flat = jnp.asarray(mask, jnp.float32).reshape(-1)
        in_specs.append(ray_spec)
        operands.append(jnp.pad(flat, (0, n_pad - n_pix)))

    def call(*ops, platform):
        return pl.pallas_call(
            kernel,
            grid=(n_pad // block,),
            in_specs=in_specs,
            out_specs=[ray_spec] * 8,
            out_shape=[jax.ShapeDtypeStruct((n_pad,), jnp.float32)] * 6
            + [jax.ShapeDtypeStruct((n_pad,), jnp.int32)] * 2,
            compiler_params=plt.CompilerParams(num_warps=num_warps, num_stages=1),
            backend="triton",
            interpret=kernel_mode(platform) == KERNEL_INTERPRET,
            name="geodesic_trace",
        )(*ops)

    # only the branch of the platform the call is lowered for is lowered;
    # any other platform fails to lower
    outs = lax.platform_dependent(
        *operands,
        **{p: functools.partial(call, platform=p) for p in ("cpu", "cuda")},
    )
    px, py, pz, vx, vy, vz, status, steps = (
        o[:n_pix].reshape(height, width) for o in outs
    )
    return TraceResult(
        final_pos=jnp.stack([px, py, pz], axis=-1),
        final_vel=jnp.stack([vx, vy, vz], axis=-1),
        status=status,
        steps=steps,
    )


def pallas_trace_image(
    camera,
    scene,
    config: TraceConfig = TraceConfig(),
    *,
    row0=0,
    local_shape: tuple[int, int] | None = None,
    mask=None,
    stride: int = 1,
) -> TraceResult:
    """Trace every pixel of the scene's image with the Pallas kernel.

    Returns a TraceResult shaped (H, W) — or `local_shape` for a band of
    the full image (row0 gives the band's first global row; mesh-sharded
    rendering and the multires halo). The kernel is compiled when the call
    runs on a GPU and interpreted when it runs on the CPU (`kernel_mode` of
    the lowering platform); nothing else is reachable. DEFAULT_BLOCK rays
    per program, DEFAULT_NUM_WARPS warps.

    `stride` > 1: trace every stride-th pixel of the full image — local
    pixel (i, j) is full-image pixel (i*stride + row0, j*stride),
    the multires low pass. `mask` (fp32 (H, W)): rays with mask 0 are not
    integrated (status ESCAPED, initial state; callers discard them) and a
    block whose rays are all masked costs no loop trip — the multires
    edge fix-up.
    """
    local_shape = tuple(local_shape or (scene.screen_height, scene.screen_width))
    params = build_params(camera, scene, config, row0=row0)
    return _pallas_trace(
        params,
        mask,
        local_shape=local_shape,
        max_steps=int(scene.max_steps),
        config=config,
        block=DEFAULT_BLOCK,
        num_warps=DEFAULT_NUM_WARPS,
        stride=int(stride),
    )
