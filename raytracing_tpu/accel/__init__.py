"""Acceleration structures: uniform grid build + DDA traversal."""
from __future__ import annotations

from ..core.types import Scene, replace
from .grid import Grid, build_sphere_grid, build_triangle_grid

__all__ = ["Grid", "build_sphere_grid", "build_triangle_grid",
           "prepare_grids"]


def auto_slabs(n_items: int) -> int:
    """Cubic grid resolution for ``n_items`` objects: n ~ cbrt(N / 40),
    about 40 items per cell, so per-cell fixed cost and per-item work stay
    balanced (cornell's 32 triangles -> 1, a 1,012-triangle teapot -> 3)."""
    return max(1, round((max(n_items, 1) / 40.0) ** (1.0 / 3.0)))


def prepare_grids(scene: Scene, n_slabs: int | tuple | str = 1,
                  mesh_slabs: int | str = "xml") -> Scene:
    """Build all acceleration grids host-side (the analog of preRender's
    splitSphereData/splitTriangleData calls, ref code.js:1784-1804).
    ``n_slabs="auto"`` picks the scene resolution with auto_slabs. Each
    mesh gets its own grid (code.js:899-1045): ``mesh_slabs="xml"``
    honors the mesh's XML nslabs, ``"auto"`` uses auto_slabs, and an int
    overrides every mesh."""
    if n_slabs == "auto":
        total = scene.triangles.count \
            + sum(m.tris.count for m in scene.meshes)
        n_slabs = auto_slabs(total)
    sphere_grid = None
    triangle_grid = None
    if scene.spheres.count:
        sphere_grid = build_sphere_grid(scene.spheres,
                                        scene.sphere_bounds_min,
                                        scene.sphere_bounds_max, n_slabs)
    if scene.triangles.count:
        triangle_grid = build_triangle_grid(scene.triangles,
                                            scene.triangle_bounds_min,
                                            scene.triangle_bounds_max, n_slabs)

    def mesh_res(m):
        if mesh_slabs == "xml":
            return m.nslabs
        if mesh_slabs == "auto":
            return auto_slabs(m.tris.count)
        return mesh_slabs

    meshes = tuple(
        replace(m, grid=build_triangle_grid(m.tris, m.bounds_min,
                                            m.bounds_max, mesh_res(m)))
        for m in scene.meshes)
    return replace(scene, sphere_grid=sphere_grid,
                   triangle_grid=triangle_grid, meshes=meshes)
