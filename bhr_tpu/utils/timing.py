"""Device timing: the analog of wgpu timestamp queries.

The reference wraps its compute pass in GPU timestamp writes and reads the
previous frame's pair each frame (reference: src/main.rs:510-531, 887-921;
src/lib.rs:569-577). Here device time is measured by bracketing a
dispatch with block_until_ready — TimestampQuery mirrors the query-set
object the reference passes into render_frame, and `jax.profiler` hooks
provide deep traces when needed.
"""

from __future__ import annotations

import contextlib
import time

import jax


class TimestampQuery:
    """Populated by BlackHoleRenderer.render_frame(..., timestamp_query=q).

    Semantics note: unlike the wgpu pass-only timestamps, this measures
    dispatch + completion from the host (it forces a sync). The reference
    app also syncs each frame for its readback (main.rs:890), so frame
    pacing is comparable. To subtract the fixed dispatch round trip, pass
    the overhead measured by `calibrate_dispatch_overhead_ms` as
    `overhead_ms`; it is subtracted from the bracket (floored at 0).
    """

    def __init__(self, overhead_ms: float = 0.0):
        self.gpu_time_ms: float | None = None
        self.overhead_ms = float(overhead_ms)
        self._t0: float | None = None

    def begin(self) -> None:
        self._t0 = time.perf_counter()

    def end(self) -> None:
        if self._t0 is not None:
            bracket = (time.perf_counter() - self._t0) * 1000.0
            self.gpu_time_ms = max(bracket - self.overhead_ms, 0.0)


def calibrate_dispatch_overhead_ms(reps: int = 5) -> float:
    """Median host-side cost of dispatching + syncing a trivially small
    computation — the fixed per-dispatch overhead (launch and stream
    synchronization) that a wall-clock bracket includes on top of actual
    device time. The device work itself is ~microseconds, so the median
    bracket IS the dispatch overhead to within noise.
    """
    import jax.numpy as jnp

    f = jax.jit(lambda x: x * 2.0 + 1.0)
    jax.block_until_ready(f(jnp.float32(0.5)))  # compile outside the timing
    times = []
    for k in range(max(reps, 1)):
        x = jnp.float32(0.25 + 0.125 * k + (time.perf_counter() % 1.0))
        t0 = time.perf_counter()
        jax.block_until_ready(f(x))
        times.append((time.perf_counter() - t0) * 1000.0)
    times.sort()
    return times[len(times) // 2]


def time_fn(fn, *args, warmup: int = 3, iters: int = 10) -> float:
    """Median wall time (ms) of a jitted callable, synchronized per call."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1000.0)
    times.sort()
    return times[len(times) // 2]


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """jax.profiler trace context (the deep-dive companion of the
    CSV+timestamp tooling)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
