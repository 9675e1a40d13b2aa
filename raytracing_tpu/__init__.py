"""raytracing_tpu — a differentiable ray/path tracer in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
reference WebCL ray tracer (eaymerich/2015-RayTracing): multi-sphere and
triangle-mesh ray tracing, 3D uniform-grid acceleration, disk area lights
with shadow rays, thin-lens depth of field, and progressive Monte Carlo
path tracing — all differentiable end-to-end and shardable over device
meshes.

Layer map (SURVEY §7): core/ io/ ops/ accel/ render/ diff/ parallel/ models/.
"""

from .core.config import RenderConfig
from .core.types import (
    AABB, Camera, Hits, Lights, MeshInstance, Rays, Scene, Spheres,
    Triangles, build_scene, make_spheres, make_triangles, replace,
)
from .render import pathtracer
from .render.direct import render_direct
from .render.simple import render_fake_shade

__version__ = "0.1.0"

__all__ = [
    "AABB", "Camera", "Hits", "Lights", "MeshInstance", "Rays",
    "RenderConfig", "Scene", "Spheres", "Triangles", "build_scene",
    "make_spheres", "make_triangles", "pathtracer", "render_direct",
    "render_fake_shade", "replace",
]
