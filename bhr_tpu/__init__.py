"""bhr_tpu: general-relativistic black-hole raytracer in JAX (GPU).

A ground-up JAX/XLA/Pallas framework with the capabilities of the reference
Rust+wgpu/WGSL implementation (etoal83/black-hole-raytracer): Schwarzschild
(and Kerr) null-geodesic ray tracing with gravitational lensing, photon
sphere, event-horizon capture and Einstein rings, an equirectangular HDR
star-map skybox, debug step-count heatmaps, an orbiting-camera animation
loop, performance statistics + CSV logging, and a notebook-friendly
library API — plus multi-chip rendering over a jax device mesh.

Public API mirrors the reference library surface (reference: src/lib.rs):
Camera, SceneParams, GpuContext/TpuContext, BlackHoleRenderer, block_on,
normalize, cross, QUAD_VERTICES.
"""

from .core.camera import Camera, generate_rays, orbit_camera
from .core.math import cross, direction_to_equirectangular_uv, normalize
from .core.scene import (
    CAPTURE_FACTOR,
    DEBUG_NONE,
    DEBUG_STEPS,
    DEFAULT_DT,
    ESCAPE_RADIUS,
    SceneParams,
)
from .animation import OrbitAnimator, PathAnimator
from .ops.display import QUAD_VERTICES, Vertex
from .ops.pallas_trace import pallas_trace_image
from .ops.trace import TraceConfig, TraceResult, trace_rays
from .renderer import (
    BlackHoleRenderer,
    GpuContext,
    TpuContext,
    block_on,
    render_image,
)
from .utils.perf import PerfLogger, PerformanceStats
from .utils.timing import TimestampQuery

__version__ = "0.1.0"

__all__ = [
    "BlackHoleRenderer",
    "Camera",
    "CAPTURE_FACTOR",
    "DEBUG_NONE",
    "DEBUG_STEPS",
    "DEFAULT_DT",
    "ESCAPE_RADIUS",
    "GpuContext",
    "OrbitAnimator",
    "PathAnimator",
    "PerfLogger",
    "PerformanceStats",
    "QUAD_VERTICES",
    "SceneParams",
    "TimestampQuery",
    "TpuContext",
    "TraceConfig",
    "TraceResult",
    "Vertex",
    "block_on",
    "cross",
    "direction_to_equirectangular_uv",
    "generate_rays",
    "normalize",
    "orbit_camera",
    "pallas_trace_image",
    "render_image",
    "trace_rays",
]
