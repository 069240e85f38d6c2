"""Kerr spacetime in Cartesian Kerr-Schild coordinates — exact null
geodesics via Hamiltonian integration.

The reference's roadmap specifies Boyer-Lindquist/Kerr-Schild Kerr geodesics
(reference: docs/ROADMAP.md:514-826); this module implements the Kerr-Schild
form, which is the accelerator-friendly one: Cartesian (no coordinate singularity at
the poles), horizon-penetrating (no 1/(1-rs/r) blowup at the horizon — no
clamps needed in the hot loop), and branch-free.

Metric (geometric units, M = rs/2, a = a* M, spin axis +Y so the app's XZ
orbit/disk plane is equatorial):

    g_{uv}  = eta_{uv} + f l_u l_v          eta = diag(-1, 1, 1, 1)
    g^{uv}  = eta^{uv} - f l^u l^v          l^u = (-1, l_vec)
    r(q):     r^4 - (rho^2 - a^2) r^2 - a^2 y^2 = 0,   rho^2 = x^2+y^2+z^2
    f       = 2 M r^3 / (r^4 + a^2 y^2)
    l_vec   = ((r x + a z)/(r^2+a^2),  y/r,  (r z - a x)/(r^2+a^2))
    l_t     = 1

Null geodesics are integrated in Hamiltonian form with the conserved energy
E = -p_t scaled to 1 (exact by construction — the metric is stationary):

    H(q, p)   = 1/2 g^{uv} p_u p_v = 1/2 (|p|^2 - 1 - f S^2),  S = 1 + l.p
    dq/dl     =  dH/dp = p - f S l
    dp_i/dl   = -dH/dq = 1/2 (d_i f) S^2 + f S (d_i l_j) p_j

H = 0 along every ray (checked in tests). At a* = 0 this is Schwarzschild in
ingoing Eddington-Finkelstein form (photon sphere at 3M — validated), and at
a* = 0.9 the analytic equatorial photon-ring radii are reproduced
(prograde 2M(1+cos(2/3 arccos(-a*)))/..., tests/test_kerr_schild.py).

All functions are vectorized over leading batch dims: q/p/d are (..., 3).
"""

from __future__ import annotations

import jax.numpy as jnp

from .kerr import capture_radius, horizon_radius  # shared: 1.05 * r_+

__all__ = [
    "aux",
    "derivs",
    "hamiltonian",
    "init_momentum",
    "final_direction",
    "capture_radius",
    "horizon_radius",
    "ks_radius",
]

_EPS = 1e-12


def _split(v):
    return v[..., 0], v[..., 1], v[..., 2]


def ks_radius(q, rs, spin):
    """The Kerr-Schild radial coordinate r (== |q| when a* = 0)."""
    m = jnp.asarray(rs, jnp.float32) * 0.5
    a = jnp.asarray(spin, jnp.float32) * m
    a2 = a * a
    x, y, z = _split(q)
    rho2 = x * x + y * y + z * z
    b = rho2 - a2
    disc = jnp.sqrt(b * b + 4.0 * a2 * (y * y))
    return jnp.sqrt(jnp.maximum(0.5 * (b + disc), _EPS))


def aux(q, rs, spin):
    """Shared quantities: (r, f, l_vec) at position q (relative to the BH)."""
    m = jnp.asarray(rs, jnp.float32) * 0.5
    a = jnp.asarray(spin, jnp.float32) * m
    x, y, z = _split(q)
    rho2 = x * x + y * y + z * z
    b = rho2 - a * a
    r2 = 0.5 * (b + jnp.sqrt(b * b + 4.0 * a * a * y * y))
    r2 = jnp.maximum(r2, _EPS)
    r = jnp.sqrt(r2)
    w = jnp.maximum(r2 * r2 + a * a * y * y, _EPS)  # r^4 + a^2 y^2
    f = 2.0 * m * r2 * r / w
    bb = r2 + a * a
    lx = (r * x + a * z) / bb
    ly = y / r
    lz = (r * z - a * x) / bb
    return r, f, jnp.stack([lx, ly, lz], axis=-1)


def derivs(q, p, rs, spin):
    """Hamiltonian right-hand side: (dq/dl, dp/dl) with p_t = -1.

    NOTE: expression trees (groupings, reciprocal-multiplies) are kept
    IDENTICAL to the Pallas kernel's exact-tier transcription
    (ops/pallas_trace.py ks_all) — the geodesic flow is chaotic near the
    shadow boundary, so even algebraically equal regroupings (e.g.
    (r2+a2)*y vs r2*y + a2*y) amplify their 1-ulp differences into visible
    per-pixel noise over hundreds of steps. Any change here must be
    mirrored there (kernel-vs-oracle parity tests will catch drift)."""
    m = jnp.asarray(rs, jnp.float32) * 0.5
    a = jnp.asarray(spin, jnp.float32) * m
    a2 = a * a
    x, y, z = _split(q)
    px, py, pz = _split(p)

    rho2 = x * x + y * y + z * z
    b = rho2 - a2
    disc = jnp.sqrt(b * b + 4.0 * a2 * (y * y))
    r2 = jnp.maximum(0.5 * (b + disc), _EPS)
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

    # dr/dq_i = r (r^2 q_i + a^2 y delta_iy) / W
    r_w = r * inv_w
    drx = r_w * r2 * x
    dry = r_w * bb * y  # r2 y + a2 y = (r2 + a2) y
    drz = r_w * r2 * z

    # df/dq_i = 2M [(3 r^2 W - 4 r^6) dr_i - 2 a^2 y r^3 delta_iy] / W^2
    g1 = (2.0 * m) * (3.0 * r2 * w - 4.0 * r3 * r3) * (inv_w * inv_w)
    g2 = (4.0 * m) * a2 * r3 * (inv_w * inv_w)
    dfx = g1 * drx
    dfy = g1 * dry - g2 * y
    dfz = g1 * drz

    # dl_j/dq_i (3x3). Common terms:
    # lx = (r x + a z)/B, ly = y/r, lz = (r z - a x)/B, B = r^2 + a^2
    two_r_invbb = 2.0 * r * inv_bb
    inv_r2 = inv_r * inv_r
    # d lx / d(x,y,z)
    dlx_x = (x * drx + r) * inv_bb - lx * (two_r_invbb * drx)
    dlx_y = (x * dry) * inv_bb - lx * (two_r_invbb * dry)
    dlx_z = (x * drz + a) * inv_bb - lx * (two_r_invbb * drz)
    # d ly / d(x,y,z)   (ly = y / r)
    dly_x = -y * inv_r2 * drx
    dly_y = inv_r - y * inv_r2 * dry
    dly_z = -y * inv_r2 * drz
    # d lz / d(x,y,z)
    dlz_x = (z * drx - a) * inv_bb - lz * (two_r_invbb * drx)
    dlz_y = (z * dry) * inv_bb - lz * (two_r_invbb * dry)
    dlz_z = (z * drz + r) * inv_bb - lz * (two_r_invbb * drz)

    s = 1.0 + lx * px + ly * py + lz * pz  # l^u p_u with p_t = -1
    fs = f * s

    dqx = px - fs * lx
    dqy = py - fs * ly
    dqz = pz - fs * lz

    hs2 = 0.5 * s * s
    dpx = hs2 * dfx + fs * (dlx_x * px + dly_x * py + dlz_x * pz)
    dpy = hs2 * dfy + fs * (dlx_y * px + dly_y * py + dlz_y * pz)
    dpz = hs2 * dfz + fs * (dlx_z * px + dly_z * py + dlz_z * pz)

    dq = jnp.stack([dqx, dqy, dqz], axis=-1)
    dp = jnp.stack([dpx, dpy, dpz], axis=-1)
    return dq, dp


def hamiltonian(q, p, rs, spin):
    """H = 1/2 g^{uv} p_u p_v with p_t = -1; zero along null geodesics."""
    _, f, l = aux(q, rs, spin)
    s = 1.0 + jnp.sum(l * p, axis=-1)
    return 0.5 * (jnp.sum(p * p, axis=-1) - 1.0 - f * s * s)


def init_momentum(q, d, rs, spin):
    """Null covariant momentum for a photon at q with coordinate direction d.

    Solves g_{uv} u^u u^v = 0 for the future-directed u^t with u_vec = d
    (unit), lowers the index, and rescales so E = -p_t = 1.

    Expression trees mirror the kernel's ks_init_p exactly (see derivs)."""
    m = jnp.asarray(rs, jnp.float32) * 0.5
    a = jnp.asarray(spin, jnp.float32) * m
    a2 = a * a
    x, y, z = _split(q)
    dx, dy, dz = _split(d)
    rho2 = x * x + y * y + z * z
    b = rho2 - a2
    r2 = jnp.maximum(0.5 * (b + jnp.sqrt(b * b + 4.0 * a2 * y * y)), _EPS)
    r = jnp.sqrt(r2)
    w = r2 * r2 + a2 * y * y
    f = jnp.asarray(rs, jnp.float32) * r2 * r / w  # 2M = rs
    bb = r2 + a2
    lx = (r * x + a * z) / bb
    ly = y / r
    lz = (r * z - a * x) / bb
    c = lx * dx + ly * dy + lz * dz
    disc = jnp.sqrt(jnp.maximum(1.0 - f * (1.0 - c * c), _EPS))
    ut = (f * c + disc) / jnp.maximum(1.0 - f, 1e-6)
    big_l = ut + c  # l_u u^u
    fl = f * big_l
    e_inv = 1.0 / jnp.maximum(ut - fl, _EPS)  # E = -p_t = u^t - f (l.u)
    return jnp.stack(
        [(dx + fl * lx) * e_inv, (dy + fl * ly) * e_inv, (dz + fl * lz) * e_inv],
        axis=-1,
    )


def final_direction(q, p, rs, spin):
    """Coordinate direction dq/dl, normalized — the shading direction."""
    dq, _ = derivs(q, p, rs, spin)
    n = jnp.sqrt(jnp.maximum(jnp.sum(dq * dq, axis=-1, keepdims=True), _EPS))
    return dq / n
