"""Image readback and file output.

The analog of the reference's readback + save path (reference:
src/lib.rs:613-702): device texture -> host RGBA8 bytes -> PNG/JPEG by file
extension. "Readback" is a single jax.device_get at the save
boundary — the only host<->device transfer in the pipeline (SURVEY.md
section 2.2, communication backend).

Encoding prefers the native C++ writer (see native/bhr_native.cpp) which
runs PNG deflate on a background thread pool so animation dumps don't stall
the render loop; it falls back to PIL, then to a pure-Python PNG encoder.
"""

from __future__ import annotations

import os
import struct
import zlib

import jax
import numpy as np


def get_image_data(frame) -> np.ndarray:
    """Device array -> host uint8 (H, W, 4) RGBA (reference: lib.rs:613-686).

    Accepts uint8 RGBA (H, W, 4) or fp32 RGB(A) in [0, 1].
    """
    arr = np.asarray(jax.device_get(frame))
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0).round().astype(np.uint8)
    if arr.ndim != 3:
        raise ValueError(f"expected (H, W, C) image, got shape {arr.shape}")
    if arr.shape[-1] == 3:
        alpha = np.full(arr.shape[:-1] + (1,), 255, np.uint8)
        arr = np.concatenate([arr, alpha], axis=-1)
    return arr


def save_image(frame, path: str, *, use_native: bool | None = None) -> None:
    """Save a rendered frame; format chosen by extension (lib.rs:692-702)."""
    rgba = get_image_data(frame)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        if use_native is not False:
            from . import native

            if native.available():
                native.write_png(path, rgba)
                return
        _save_png(rgba, path)
    else:
        from PIL import Image

        img = Image.fromarray(rgba, "RGBA")
        if ext in (".jpg", ".jpeg"):
            img = img.convert("RGB")
        img.save(path)


def _save_png(rgba: np.ndarray, path: str) -> None:
    """PNG encode via PIL, falling back to a minimal pure-Python encoder."""
    try:
        from PIL import Image

        Image.fromarray(rgba, "RGBA").save(path)
    except ImportError:  # pragma: no cover - PIL is normally present
        write_png_pure(path, rgba)


def write_png_pure(path: str, rgba: np.ndarray) -> None:
    """Minimal RGBA8 PNG writer (zlib, filter type 0). Dependency-free."""
    h, w = rgba.shape[:2]

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgba.reshape(h, w * 4)], axis=1
    ).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
