"""Runtime-swappable physics plugins — the reference's `--shader` analog.

The reference loads *arbitrary user WGSL at runtime* (reference:
src/lib.rs:425-429, src/main.rs:30 — a deliberate hot-swap mechanism for
iterating on integrators without recompiling the host binary). The
JAX analog is a user Python file defining an acceleration in
struct-of-arrays plane form:

    # my_metric.py
    def acceleration(rel, vel, r, r2, rs, spin):
        '''rel/vel: 3-tuples of same-shaped fp32 arrays; r/r2/rs/spin
        broadcast. Return (ax, ay, az).'''
        ...

    CAPTURE_FACTOR = 1.05   # optional: capture radius in units of rs

The function is traced by JAX into BOTH execution paths — the vectorized
XLA oracle (ops/trace.py) and the Pallas device kernel
(ops/pallas_trace.py) — so a plugin runs at device speed, exactly like the
reference's runtime-compiled WGSL runs at GPU speed. The plane signature is
the Pallas-native one; the oracle adapts it (ops/trace.custom_accel_arrays).

Use from the API:   BlackHoleRenderer(..., custom_physics="my_metric.py")
Use from the CLI:   python -m bhr_tpu.app --plugin my_metric.py
"""

from __future__ import annotations

import functools
import importlib.util
import pathlib

from ..core.scene import CAPTURE_FACTOR


def load_plugin(source):
    """Resolve a physics plugin to (accel_fn, capture_factor).

    `source` may be a callable (used directly; optional `capture_factor`
    attribute), a module-like object with an `acceleration` function, or a
    path to a Python file defining one. File loads are cached by resolved
    path so repeated renderer constructions reuse one function object (and
    therefore one jit cache entry — TraceConfig hashes the callable by
    identity).
    """
    if callable(source) and not hasattr(source, "acceleration"):
        return source, float(getattr(source, "capture_factor", CAPTURE_FACTOR))
    if hasattr(source, "acceleration"):
        mod = source
    else:
        mod = _load_module(str(pathlib.Path(source).resolve()))
    accel = getattr(mod, "acceleration", None)
    if not callable(accel):
        raise ValueError(
            f"physics plugin {source!r} must define acceleration(rel, vel, "
            "r, r2, rs, spin) -> (ax, ay, az) on component-plane tuples"
        )
    return accel, float(getattr(mod, "CAPTURE_FACTOR", CAPTURE_FACTOR))


@functools.lru_cache(maxsize=32)
def _load_module(resolved_path: str):
    path = pathlib.Path(resolved_path)
    if not path.exists():
        raise FileNotFoundError(f"physics plugin not found: {resolved_path}")
    spec = importlib.util.spec_from_file_location(
        f"bhr_plugin_{path.stem}", path
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
