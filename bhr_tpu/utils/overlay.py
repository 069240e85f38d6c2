"""Performance overlay + heatmap legend: the headless analog of the
reference's optional egui GUI (reference: src/main.rs:587-826, cargo feature
`gui`).

The reference draws an FPS window with stats.js-style mini line graphs for
frame/CPU/GPU times (main.rs:762-826) and, in debug mode, a step-count
legend window mirroring the shader gradient (main.rs:637-759). With no
window system on a headless host, the same panels are rasterized directly onto
the output frames (PIL, host-side, display path only — never in the render
hot path).
"""

from __future__ import annotations

import numpy as np

from ..ops.heatmap import steps_to_color

PANEL_ALPHA = 0.65
GRAPH_W, GRAPH_H = 120, 28


def _text(draw, xy, s, fill=(235, 235, 235, 255)):
    draw.text(xy, s, fill=fill)


def _mini_graph(draw, x, y, samples, color, label, current):
    """stats.js-style filled line graph (main.rs:587-633)."""
    draw.rectangle([x, y, x + GRAPH_W, y + GRAPH_H], fill=(20, 20, 24, 255))
    if samples:
        window = samples[-GRAPH_W:]
        mx = max(max(window), 1e-6)
        for i, v in enumerate(window):
            px = x + int(i * GRAPH_W / len(window))
            h = int(min(v / mx, 1.0) * (GRAPH_H - 2))
            draw.line([px, y + GRAPH_H - 1 - h, px, y + GRAPH_H - 1], fill=color)
    _text(draw, (x + 2, y + 1), f"{label} {current:.1f}ms", fill=(255, 255, 255, 255))


def draw_performance_overlay(frame_rgba: np.ndarray, stats) -> np.ndarray:
    """Rasterize the perf panel onto a uint8 (H, W, 4) frame copy.

    `stats` is a utils.perf.PerformanceStats. Mirrors the egui panel
    contents: current/avg/min/max FPS + frame/CPU/GPU mini graphs
    (main.rs:762-826).
    """
    from PIL import Image, ImageDraw

    img = Image.fromarray(np.ascontiguousarray(frame_rgba), "RGBA")
    overlay = Image.new("RGBA", img.size, (0, 0, 0, 0))
    draw = ImageDraw.Draw(overlay)
    pad = 6
    w = GRAPH_W + 2 * pad
    h = 64 + 3 * (GRAPH_H + 4) + pad
    draw.rectangle([4, 4, 4 + w, 4 + h], fill=(0, 0, 0, int(255 * PANEL_ALPHA)))
    x, y = 4 + pad, 4 + pad
    _text(draw, (x, y), f"FPS: {stats.current_fps:.1f}")
    _text(draw, (x, y + 13), f"Avg: {stats.avg_fps():.1f}")
    _text(draw, (x, y + 26), f"Min: {stats.min_fps():.1f}  Max: {stats.max_fps():.1f}")
    _text(draw, (x, y + 39), f"std: {stats.std_dev_fps():.2f} ms")
    y += 58
    _mini_graph(draw, x, y, list(stats.frame_times), (96, 200, 96, 255),
                "frame", stats.current_frame_time)
    y += GRAPH_H + 4
    _mini_graph(draw, x, y, list(stats.cpu_times), (96, 160, 255, 255),
                "cpu", stats.current_cpu_time)
    y += GRAPH_H + 4
    _mini_graph(draw, x, y, list(stats.gpu_times), (255, 180, 80, 255),
                "dev", stats.current_gpu_time or 0.0)
    return np.asarray(Image.alpha_composite(img, overlay))


def draw_legend(height: int = 200, width: int = 46, max_steps: int = 200) -> np.ndarray:
    """Step-count heatmap legend strip, uint8 (height, width, 4).

    Mirrors draw_legend_ui (main.rs:637-759): the exact shader gradient
    (blue -> cyan -> green -> yellow -> red) with step labels, top = max.
    """
    import jax.numpy as jnp
    from PIL import Image, ImageDraw

    steps = jnp.asarray(
        np.linspace(max_steps, 0, height).round().astype(np.int32)
    )
    colors = np.asarray(steps_to_color(steps, max_steps))
    strip = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
    bar_w = 18
    img = np.zeros((height, width, 4), np.uint8)
    img[..., 3] = 255
    img[:, :bar_w, :3] = strip[:, None, :]
    pil = Image.fromarray(img, "RGBA")
    draw = ImageDraw.Draw(pil)
    for frac in (0.0, 0.5, 1.0):
        yy = int(frac * (height - 10))
        label = int(round((1.0 - frac) * max_steps))
        _text(draw, (bar_w + 2, yy), str(label))
    return np.asarray(pil)


def draw_legend_onto(frame_rgba: np.ndarray, max_steps: int = 200) -> np.ndarray:
    """Composite the legend into the frame's top-right corner."""
    legend = draw_legend(max_steps=max_steps)
    out = np.ascontiguousarray(frame_rgba).copy()
    h, w = legend.shape[:2]
    fh, fw = out.shape[:2]
    h, w = min(h, fh - 8), min(w, fw - 8)
    out[4 : 4 + h, fw - 4 - w : fw - 4] = legend[:h, :w]
    return out
