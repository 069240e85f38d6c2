"""Kerr-Schild geodesic validation against analytic invariants.

The equatorial circular-photon-orbit radii of Kerr are known in closed form
(Bardeen 1972): r_ph = 2M (1 + cos(2/3 arccos(-a*))) prograde,
with +a* -> -a* for retrograde. A photon launched tangentially just inside
the ring must be captured; just outside, it must escape — a bracketing test
that is robust to the orbit's instability. a* = 0 must reproduce the
Schwarzschild photon sphere at 3M in both directions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bhr_tpu.models import kerr_schild as ks

RS = 2.0  # M = 1
M = RS / 2.0


def photon_ring_radius(a_star: float, prograde: bool) -> float:
    s = -a_star if prograde else a_star
    return 2.0 * M * (1.0 + np.cos(2.0 / 3.0 * np.arccos(s)))


def _equatorial_tangential(r_bl: float, spin: float, prograde: bool):
    """Photon at BL radius r_bl on the equator with tangential direction.

    KS Cartesian embedding of the equatorial r-circle (spin +Y):
    (x, z) = (r cos(phi) - a sin(phi)... ) at phi=0: q = (r, 0, a),
    tangent d(position)/d(phi) = (-a, 0, r)."""
    a = spin * M
    q = jnp.asarray([r_bl, 0.0, a], jnp.float32)
    d = jnp.asarray([-a, 0.0, r_bl], jnp.float32)
    d = d / jnp.linalg.norm(d)
    if not prograde:
        d = -d
    return q, d


def _trace(q, d, spin, max_steps=60_000, dt=0.02):
    """Integrate one photon; returns (status, q) with status 1=escape,
    2=capture, 0=still going."""
    p = ks.init_momentum(q, d, RS, spin)
    cap = float(ks.capture_radius(RS, spin))

    def cond(c):
        i, q, p = c
        r = ks.ks_radius(q, RS, spin)
        rho = jnp.linalg.norm(q)
        return (i < max_steps) & (r > cap) & (rho < 100.0)

    def body(c):
        i, q, p = c
        dq, dp = ks.derivs(q, p, RS, spin)
        p2 = p + dp * dt
        dq2, _ = ks.derivs(q, p2, RS, spin)
        return i + 1, q + dq2 * dt, p2

    _, qf, pf = jax.lax.while_loop(cond, body, (jnp.int32(0), q, p))
    r = float(ks.ks_radius(qf, RS, spin))
    rho = float(jnp.linalg.norm(qf))
    if r <= cap * 1.0001:
        return 2, qf
    if rho >= 99.0:
        return 1, qf
    return 0, qf


@pytest.mark.parametrize("spin,prograde", [
    (0.9, True), (0.9, False), (0.0, True), (0.0, False), (0.5, True),
])
def test_photon_ring_bracketing(spin, prograde):
    r_ph = photon_ring_radius(spin, prograde)
    q_in, d_in = _equatorial_tangential(r_ph * 0.97, spin, prograde)
    q_out, d_out = _equatorial_tangential(r_ph * 1.03, spin, prograde)
    status_in, _ = _trace(q_in, d_in, spin)
    status_out, _ = _trace(q_out, d_out, spin)
    assert status_in == 2, (
        f"photon at 0.97 r_ph (r_ph={r_ph:.3f}, spin={spin}, "
        f"prograde={prograde}) was not captured"
    )
    assert status_out == 1, (
        f"photon at 1.03 r_ph (r_ph={r_ph:.3f}, spin={spin}, "
        f"prograde={prograde}) did not escape"
    )


def test_prograde_ring_smaller_than_retrograde():
    """Frame dragging: the prograde ring sits well inside the retrograde
    one (1.56 M vs 3.91 M at a* = 0.9) — validates the spin direction."""
    assert photon_ring_radius(0.9, True) < 2.0 * M
    assert photon_ring_radius(0.9, False) > 3.8 * M


def test_hamiltonian_conserved_along_ray():
    """H = 0 exactly at init (null momentum) and drifts only at integrator
    order along the trajectory."""
    q = jnp.asarray([10.0, 3.0, -4.0], jnp.float32)
    d = jnp.asarray([-0.9, -0.2, 0.3], jnp.float32)
    d = d / jnp.linalg.norm(d)
    spin = 0.9
    p = ks.init_momentum(q, d, RS, spin)
    h0 = float(ks.hamiltonian(q, p, RS, spin))
    assert abs(h0) < 1e-6, f"initial momentum not null: H = {h0}"

    dt = 0.02
    cap = float(ks.capture_radius(RS, spin))

    def body(c, _):
        q, p = c
        live = ks.ks_radius(q, RS, spin) > cap  # freeze at capture, like
        dq, dp = ks.derivs(q, p, RS, spin)      # the production kernels
        step = jnp.float32(dt) * live
        p2 = p + dp * step
        dq2, _ = ks.derivs(q, p2, RS, spin)
        return (q + dq2 * step, p2), ks.hamiltonian(q, p, RS, spin)

    (_, _), hs = jax.lax.scan(body, (q, p), None, length=1000)
    drift = float(np.abs(np.asarray(hs)).max())
    assert drift < 5e-3, f"H drifted to {drift} over 1000 steps"


def test_schwarzschild_limit_matches_radial_physics():
    """a* = 0: KS r is |q| and f = rs/r (ingoing Eddington-Finkelstein)."""
    q = jnp.asarray([[3.0, 4.0, 0.0], [0.0, 0.0, 7.5]], jnp.float32)
    r, f, l = ks.aux(q, RS, 0.0)
    np.testing.assert_allclose(np.asarray(r), [5.0, 7.5], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(f), RS / np.array([5.0, 7.5]), rtol=1e-6)
    # l is the radial unit vector
    np.testing.assert_allclose(
        np.asarray(l), [[0.6, 0.8, 0.0], [0.0, 0.0, 1.0]], atol=1e-6
    )


def test_capture_radius_shrinks_with_spin():
    assert float(ks.capture_radius(RS, 0.9)) < float(ks.capture_radius(RS, 0.0))
    np.testing.assert_allclose(
        float(ks.horizon_radius(RS, 0.0)), RS, rtol=1e-6
    )


def test_horizon_penetration_no_nans():
    """KS coordinates are horizon-penetrating: integrating a plunging ray
    through r_+ produces finite state (the property that lets the GPU
    kernel run clamp-free)."""
    q = jnp.asarray([6.0, 0.5, 0.0], jnp.float32)
    d = jnp.asarray([-1.0, 0.0, 0.0], jnp.float32)
    spin = 0.9
    p = ks.init_momentum(q, d, RS, spin)
    dt = 0.02

    def body(c, _):
        q, p = c
        dq, dp = ks.derivs(q, p, RS, spin)
        p2 = p + dp * dt
        dq2, _ = ks.derivs(q, p2, RS, spin)
        return (q + dq2 * dt, p2), ks.ks_radius(q, RS, spin)

    (qf, pf), rs_along = jax.lax.scan(body, (q, p), None, length=300)
    rs_along = np.asarray(rs_along)
    assert rs_along.min() < float(ks.horizon_radius(RS, spin))  # went inside
    assert np.isfinite(np.asarray(qf)).all() and np.isfinite(np.asarray(pf)).all()
