"""Example physics plugin: the Paczynski-Wiita pseudo-Newtonian potential.

Phi(r) = -GM / (r - rs) reproduces the Schwarzschild ISCO and marginally
bound orbits in a Newtonian framework — the classic "toy metric" for
accretion studies. Acceleration (with GM = rs/2 in the reference's
geometric units where rs = 2GM):

    a = -(rs / 2) / (r - rs)^2 * r_hat

Run it from the CLI exactly like the reference hot-swaps WGSL integrators
(reference: src/main.rs:30, src/lib.rs:425-429):

    python -m bhr_tpu.app --plugin examples/plugins/paczynski_wiita.py \
        --frames 10 --out /tmp/pw_frames

The signature is struct-of-arrays plane form: rel/vel are 3-tuples of
same-shaped fp32 arrays, r/r2/rs/spin broadcast over them. It is traced by
JAX into both the XLA oracle and the Pallas GPU kernel — write it with jnp
ops only (no Python control flow on array values).
"""


def acceleration(rel, vel, r, r2, rs, spin):
    del vel, spin  # velocity-independent central force
    gm = 0.5 * rs
    d = r - rs
    # live rays never reach r <= rs (capture at CAPTURE_FACTOR * rs first);
    # frozen rays' lanes are masked out by the kernel, so no clamp needed
    f = -gm / (d * d * r)  # -(GM / d^2) * (1 / r) folds the r_hat division
    return (rel[0] * f, rel[1] * f, rel[2] * f)


# capture a bit outside rs so the d = r - rs denominator stays comfortably
# positive for live rays (the Schwarzschild default 1.05 works too)
CAPTURE_FACTOR = 1.10
