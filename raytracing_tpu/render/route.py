"""Which implementation runs a render, chosen from what the code can see.

Every entry point (pathtracer, direct, parallel.mesh, the CLI, the viewer,
models.assignments, bench.py) asks this module; no user option picks a
kernel. The answer depends only on the platform the render runs on and the
scene's table sizes:

  * ``TRITON`` — the fused per-ray Pallas kernel (ops/pallas/fused_pass.py,
    Triton route): GPU only, brute force over tables of any size. Its
    derivatives are the XLA pipeline's (pathtracer, direct). A config that
    asks for the uniform grid takes it only up to ``GRID_OBJECTS``
    objects.
  * ``XLA``  — the wavefront stage pipeline (render/stages.py) compiled by
    XLA. Runs on every platform, is differentiable through XLA's AD, and is
    the oracle every other route is compared with. Training always runs
    it, and so does a grid config past ``GRID_OBJECTS`` objects.
"""
from __future__ import annotations

import jax

from ..core.config import RenderConfig
from ..core.types import Scene
from ..ops.pallas import fused_pass
from .stages import _all_triangles

XLA = "xla"
TRITON = "triton"

# With cfg.use_grid, the fused kernel's brute force beat the XLA grid
# traversal (16^3) at 2048 spheres and lost to it at 4096, on an H100 at
# 1024^2 b5 (scripts/route_sweep.py). Brute force against brute force,
# the kernel won at every size measured (64 to 8192).
GRID_OBJECTS = 2048


def platform() -> str:
    """Platform the next computation runs on: the default device's when
    one is set (``jax.default_device``), else the default backend's."""
    dev = jax.config.jax_default_device
    if dev is not None:
        return getattr(dev, "platform", dev)
    return jax.default_backend()


def forward(scene: Scene, cfg: RenderConfig,
            on: str | None = None) -> str:
    """Route of a forward render (progressive path or direct lighting) of
    ``scene`` under ``cfg`` on platform ``on`` (default: ``platform()``)."""
    if (on or platform()) != "gpu" or not fused_pass.covers(scene, cfg):
        return XLA
    if cfg.use_grid and (scene.spheres.count + _all_triangles(scene).count
                         > GRID_OBJECTS):
        return XLA
    return TRITON
