#!/usr/bin/env python
"""Regenerate the docs/img showcase assets (run on the GPU)."""

import os
import sys

import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from bhr_tpu import BlackHoleRenderer, Camera, SceneParams
from bhr_tpu.animation import OrbitAnimator

OUT = os.path.join(os.path.dirname(__file__), "..", "docs", "img")


def main():
    os.makedirs(OUT, exist_ok=True)

    r = BlackHoleRenderer(960, 540)
    scene = SceneParams(screen_width=960, screen_height=540, max_steps=500)
    r.render_frame(Camera.default(), scene)
    r.save_image(os.path.join(OUT, "schwarzschild_960.png"))

    rk = BlackHoleRenderer(960, 540, model="kerr", disk=True)
    ks = SceneParams(
        schwarzschild_radius=2.0,
        spin=jnp.float32(0.9),
        screen_width=960,
        screen_height=540,
        max_steps=800,
    )
    rk.render_frame(Camera.new([0.0, 3.5, 26.0], [0, 0, 0], [0, 1, 0]), ks)
    rk.save_image(os.path.join(OUT, "kerr_disk_960.png"))

    hs = SceneParams(screen_width=960, screen_height=540, max_steps=200, debug_mode=1)
    r.render_frame(Camera.default(), hs)
    r.save_image(os.path.join(OUT, "heatmap_960.png"))

    vs = SceneParams(screen_width=480, screen_height=270, max_steps=200)
    OrbitAnimator(r).save_video(
        os.path.join(OUT, "orbit_480.avi"), 90, fps=18.0, scene=vs
    )

    # Phase-5 surrogate next to the integrated render: left = geodesic
    # kernel, right = XL MLP (the point of the image is that you cannot
    # tell which is which)
    import numpy as np

    nr = BlackHoleRenderer(
        960, 540, integrator="neural",
        neural_params=os.path.join(
            os.path.dirname(__file__), "..", "bhr_tpu", "assets",
            "neural_schwarzschild_orbit_xl.npz",
        ),
    )
    left = np.asarray(r.render_frame(Camera.default(), scene))
    right = np.asarray(nr.render_frame(Camera.default(), scene))
    half_l = left[:, : 960 // 2]
    half_r = right[:, 960 // 2 :]
    divider = np.full((540, 2, 4), (255, 255, 255, 255), np.uint8)
    combo = np.concatenate([half_l, divider, half_r[:, 2:]], axis=1)
    from PIL import Image

    Image.fromarray(combo, "RGBA").save(
        os.path.join(OUT, "neural_split_960.png")
    )
    print("showcase assets written to", os.path.abspath(OUT))


if __name__ == "__main__":
    main()
