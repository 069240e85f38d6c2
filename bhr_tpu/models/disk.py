"""Thin accretion disk: geometry, relativistic shading, blackbody LUT.

The reference never implemented the disk; this follows the formulation its
roadmap planned (reference: docs/ROADMAP.md:285-470): an equatorial thin
disk between r_isco = 3 r_s and r_outer = 10 r_s, Keplerian velocity field,
Doppler + gravitational-redshift g-factor, temperature profile
T(r) = T_isco (r/r_isco)^-3/4, blackbody color LUT, and relativistic beaming
I_obs = g^3 I_emit.

Conventions: the disk lies in the y = 0 equatorial plane (the app's orbit
plane is XZ with +Y up, reference: src/main.rs:858-862; the roadmap's z=0 is
an artifact of a different axis convention). Disk rotation is
counter-clockwise about +Y, matching the Kerr spin axis in models/kerr.py.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

# Default geometry in units of r_s (reference: docs/ROADMAP.md:330-333 uses
# r_isco = 6M = 3 r_s and r_outer = 20M = 10 r_s).
R_ISCO_FACTOR = 3.0
R_OUTER_FACTOR = 10.0
T_ISCO = 10000.0  # Kelvin, visualization-friendly (docs/ROADMAP.md:402)
LUT_T_MIN = 1000.0
LUT_T_MAX = 30000.0
LUT_STEPS = 512


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DiskParams:
    """Dynamic disk configuration (pytree data, can vary per frame)."""

    r_isco: jnp.ndarray = dataclasses.field(
        default_factory=lambda: jnp.float32(R_ISCO_FACTOR * 2.0)
    )
    r_outer: jnp.ndarray = dataclasses.field(
        default_factory=lambda: jnp.float32(R_OUTER_FACTOR * 2.0)
    )
    t_isco: jnp.ndarray = dataclasses.field(default_factory=lambda: jnp.float32(T_ISCO))

    @classmethod
    def for_scene(cls, rs) -> "DiskParams":
        rs = jnp.asarray(rs, jnp.float32)
        return cls(
            r_isco=R_ISCO_FACTOR * rs,
            r_outer=R_OUTER_FACTOR * rs,
            t_isco=jnp.float32(T_ISCO),
        )


def intersect_equatorial(old_pos, new_pos, r_isco, r_outer):
    """Segment vs y=0 plane crossing test within the disk annulus.

    Vectorized form of the roadmap's check_disk_intersection
    (docs/ROADMAP.md:293-313). Returns (hit_mask, hit_pos).
    """
    oy = old_pos[..., 1]
    ny = new_pos[..., 1]
    crosses = oy * ny < 0.0
    denom = ny - oy
    t = -oy / jnp.where(crosses, denom, 1.0)
    hit_pos = old_pos + t[..., None] * (new_pos - old_pos)
    r = jnp.sqrt(jnp.sum(hit_pos * hit_pos, axis=-1))
    hit = crosses & (r >= r_isco) & (r <= r_outer)
    return hit, hit_pos


def keplerian_velocity(hit_pos, rs):
    """Keplerian orbital velocity vector at a disk point (ROADMAP.md:360-370).

    |v| = sqrt(M / r^3) * r = sqrt(M / r) tangentially; the roadmap's
    keplerian_velocity returns sqrt(M/r^3) as an angular rate and multiplies
    by the unit tangent — we use the physical orbital speed beta = sqrt(M/r)
    (geometric units, M = rs/2), clipped below 1.
    """
    r = jnp.sqrt(jnp.sum(hit_pos * hit_pos, axis=-1, keepdims=True))
    m = jnp.asarray(rs, jnp.float32) * 0.5
    beta = jnp.sqrt(jnp.clip(m / r, 0.0, 0.81))  # clip: stay subluminal
    x = hit_pos[..., 0:1]
    z = hit_pos[..., 2:3]
    tangent = jnp.concatenate([z, jnp.zeros_like(x), -x], axis=-1)
    tangent = tangent / jnp.maximum(
        jnp.sqrt(jnp.sum(tangent * tangent, axis=-1, keepdims=True)), 1e-20
    )
    return beta * tangent


def redshift_factor(hit_pos, ray_direction, observer_r, rs):
    """Combined Doppler x gravitational g-factor (ROADMAP.md:374-397).

    g < 1 = blueshift toward observer by this convention (the roadmap
    computes doppler = (1 - beta cos) / sqrt(1 - beta^2) and multiplies the
    observed temperature by g — approaching material has cos > 0 giving
    g < 1... we follow the standard convention instead: T_obs = T_emit / g
    with g = doppler * grav as defined there, i.e. emission uses 1/g where
    the roadmap writes g. To stay faithful to the roadmap's API we return
    its g and let disk_emission invert it.
    """
    r_disk = jnp.sqrt(jnp.sum(hit_pos * hit_pos, axis=-1))
    v = keplerian_velocity(hit_pos, rs)
    beta = jnp.sqrt(jnp.sum(v * v, axis=-1))
    v_hat = v / jnp.maximum(beta[..., None], 1e-20)
    d = ray_direction / jnp.sqrt(
        jnp.sum(ray_direction * ray_direction, axis=-1, keepdims=True)
    )
    cos_theta = jnp.sum(v_hat * d, axis=-1)
    doppler = (1.0 - beta * cos_theta) / jnp.sqrt(1.0 - beta * beta)
    grav_emit = jnp.sqrt(jnp.clip(1.0 - rs / jnp.maximum(r_disk, 1.001 * rs), 1e-4, 1.0))
    grav_obs = jnp.sqrt(jnp.clip(1.0 - rs / jnp.maximum(observer_r, 1.001 * rs), 1e-4, 1.0))
    return doppler * (grav_emit / grav_obs)


def disk_temperature(r, r_isco, t_isco):
    """T(r) = T_isco (r / r_isco)^(-3/4) (ROADMAP.md:400-404)."""
    return t_isco * jnp.power(jnp.maximum(r / r_isco, 1e-6), -0.75)


# ---------------------------------------------------------------------------
# Blackbody color LUT (precomputed on host; ROADMAP.md:407-437 planned this
# in Python with the `colour` package — we embed the CIE 1931 analytic
# multi-lobe Gaussian fits instead, so there is no extra dependency).
# ---------------------------------------------------------------------------


def _cie_xyz_bar(wl_nm):
    """Wyman-Sloan-Shirley analytic fit to the CIE 1931 color matching fns."""

    def g(x, mu, s1, s2):
        s = np.where(x < mu, s1, s2)
        t = (x - mu) / s
        return np.exp(-0.5 * t * t)

    x = (
        1.056 * g(wl_nm, 599.8, 37.9, 31.0)
        + 0.362 * g(wl_nm, 442.0, 16.0, 26.7)
        - 0.065 * g(wl_nm, 501.1, 20.4, 26.2)
    )
    y = 0.821 * g(wl_nm, 568.8, 46.9, 40.5) + 0.286 * g(wl_nm, 530.9, 16.3, 31.1)
    z = 1.217 * g(wl_nm, 437.0, 11.8, 36.0) + 0.681 * g(wl_nm, 459.0, 26.0, 13.8)
    return x, y, z


@functools.lru_cache(maxsize=4)
def blackbody_lut_np(t_min=LUT_T_MIN, t_max=LUT_T_MAX, steps=LUT_STEPS):
    """(steps, 3) float32 numpy LUT — the host-side form (safe to call and
    cache inside jit traces, unlike a cached jnp array, which would leak a
    constant tracer)."""
    wl = np.linspace(380e-9, 780e-9, 200)
    wl_nm = wl * 1e9
    xbar, ybar, zbar = _cie_xyz_bar(wl_nm)
    h, c, kb = 6.62607015e-34, 2.99792458e8, 1.380649e-23
    temps = np.linspace(t_min, t_max, steps)
    # Planck law B(wl, T), shape (steps, n_wl)
    with np.errstate(over="ignore"):
        b = (2 * h * c**2 / wl**5) / (np.expm1(h * c / (wl * kb * temps[:, None])))
    xyz = np.stack([b @ xbar, b @ ybar, b @ zbar], axis=-1)
    m = np.array(
        [
            [3.2406, -1.5372, -0.4986],
            [-0.9689, 1.8758, 0.0415],
            [0.0557, -0.2040, 1.0570],
        ]
    )
    rgb = xyz @ m.T
    rgb = np.clip(rgb, 0.0, None)
    peak = np.maximum(rgb.max(axis=-1, keepdims=True), 1e-12)
    rgb = rgb / peak
    return rgb.astype(np.float32)


def blackbody_lut(t_min=LUT_T_MIN, t_max=LUT_T_MAX, steps=LUT_STEPS):
    """(steps, 3) float32 sRGB-linear colors for temperatures in [t_min, t_max].

    Planck spectrum -> CIE XYZ -> linear sRGB, each color normalized to max
    channel 1 (hue only; brightness comes from beaming), negative channels
    clipped.
    """
    return jnp.asarray(blackbody_lut_np(t_min, t_max, steps))


def temperature_to_color(t, lut=None, t_min=LUT_T_MIN, t_max=LUT_T_MAX):
    """Linear LUT sample (clamped), analog of ROADMAP.md:440-447."""
    if lut is None:
        lut = blackbody_lut()
    steps = lut.shape[0]
    x = (t - t_min) / (t_max - t_min) * (steps - 1)
    x = jnp.clip(x, 0.0, steps - 1.0)
    i0 = jnp.floor(x).astype(jnp.int32)
    i1 = jnp.minimum(i0 + 1, steps - 1)
    f = (x - i0.astype(jnp.float32))[..., None]
    return lut[i0] * (1.0 - f) + lut[i1] * f


def temperature_to_color_select(t, t_min=LUT_T_MIN, t_max=LUT_T_MAX,
                                coarse=64):
    """Gather-free blackbody color: piecewise-linear clamp-sum evaluation.

    temperature_to_color reads the LUT with two row-gathers per pixel;
    this variant evaluates the SAME piecewise-linear curve as a clamp-sum
    over compile-time segment constants, so the multires epilogue stays
    gather-free:

        c(x) = lut[0] + sum_i (lut[i+1] - lut[i]) * clamp(x - i, 0, 1)

    over a `coarse`-entry subsample of the host LUT — ~5 elementwise ops
    per segment per pixel, zero gathers. With
    coarse=LUT_STEPS it reproduces temperature_to_color's curve exactly;
    the default 64-segment subsample differs by < 1.5 u8 levels anywhere
    on the curve (tests/test_models_disk.py) — used by the multires
    approximation path where the epilogue must stay gather-free.
    """
    lut_np = blackbody_lut_np(t_min, t_max, LUT_STEPS)
    if coarse and coarse < LUT_STEPS:
        # uniform resample on the 512-entry piecewise-linear curve (uniform
        # spacing is what makes the single x-scale below exact)
        xs = np.linspace(0, LUT_STEPS - 1, coarse)
        lut_np = np.stack(
            [np.interp(xs, np.arange(LUT_STEPS), lut_np[:, c]) for c in range(3)],
            axis=-1,
        ).astype(np.float32)
    steps = lut_np.shape[0]
    x = (t - t_min) / (t_max - t_min) * (steps - 1)
    x = jnp.clip(x, 0.0, steps - 1.0)
    deltas = np.diff(lut_np, axis=0)  # (steps-1, 3) compile-time constants
    chans = [jnp.full_like(x, float(lut_np[0, c])) for c in range(3)]
    for i in range(steps - 1):
        w = jnp.clip(x - float(i), 0.0, 1.0)
        for c in range(3):
            d = float(deltas[i, c])
            if d != 0.0:
                chans[c] = chans[c] + d * w
    return jnp.stack(chans, axis=-1)


def disk_emission(hit_pos, ray_direction, observer_r, rs, params: DiskParams, lut=None):
    """Observed disk color at a hit point (ROADMAP.md:451-459).

    T_obs = T_emit / g,  I_obs = I_emit / g^3  (standard invariant-intensity
    convention; the roadmap's g is a redshift factor where g > 1 means
    redshifted, so observed quantities divide by it).

    `lut="select"` evaluates the blackbody curve gather-free
    (temperature_to_color_select) — the multires epilogue path.
    """
    r = jnp.sqrt(jnp.sum(hit_pos * hit_pos, axis=-1))
    g = redshift_factor(hit_pos, ray_direction, observer_r, rs)
    g = jnp.maximum(g, 1e-3)
    t_emit = disk_temperature(r, params.r_isco, params.t_isco)
    t_obs = t_emit / g
    if isinstance(lut, str) and lut == "select":
        color = temperature_to_color_select(t_obs)
    else:
        color = temperature_to_color(t_obs, lut)
    beaming = 1.0 / (g * g * g)
    # radial intensity falloff so the outer edge fades smoothly
    edge = jnp.clip((params.r_outer - r) / (params.r_outer - params.r_isco), 0.0, 1.0)
    intensity = beaming * (t_obs / T_ISCO) ** 2 * edge[...,]
    return color * jnp.clip(intensity, 0.0, 4.0)[..., None]
