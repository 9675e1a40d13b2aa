"""Programmatic scene builders (original scenes; same *schema* as the
reference's XML scenes — camera/lights/materials/spheres/triangles/meshes).

`cornell_box` is a classic Cornell-box layout in the reference's coordinate
conventions (2-unit box, disk light on the ceiling, camera at +z), suitable
for golden tests and benchmarks without copying any reference scene file.
"""
from __future__ import annotations

import numpy as np

from ..core.types import Camera, Lights, Scene, build_scene, make_spheres, \
    make_triangles


def _quad(p00, p10, p11, p01, normal):
    """Two triangles for a quad, consistent winding, shared normal."""
    tris = [
        (p00, p10, p11),
        (p00, p11, p01),
    ]
    v = np.asarray(tris, np.float32)
    n = np.broadcast_to(np.asarray(normal, np.float32), (2, 3, 3)).copy()
    return v, n


def cornell_box(cols: int = 320, rows: int = 240,
                sphere_center=(-0.4, -0.55, 0.2), sphere_radius=0.45,
                sphere2_center=(0.45, -0.65, -0.3), sphere2_radius=0.35,
                light_irradiance=(5.0, 5.0, 5.0), light_radius=0.25,
                focal_length=2.8, lens_diameter=0.0) -> Scene:
    """Closed-ish 2-unit Cornell box with two spheres and one ceiling disk
    light. Walls wind so their front faces point inward (single-sided
    triangles visible from inside)."""
    s = 1.0
    eps = 0.01
    quads = []
    # back wall (z = -s), normal +z
    quads.append(_quad([-s, -s, -s + eps], [s, -s, -s + eps],
                       [s, s, -s + eps], [-s, s, -s + eps], [0, 0, 1]))
    # floor (y = -s), normal +y
    quads.append(_quad([-s, -s + eps, s], [s, -s + eps, s],
                       [s, -s + eps, -s], [-s, -s + eps, -s], [0, 1, 0]))
    # ceiling (y = +s), normal -y
    quads.append(_quad([-s, s - eps, -s], [s, s - eps, -s],
                       [s, s - eps, s], [-s, s - eps, s], [0, -1, 0]))
    # left wall (x = -s), red, normal +x
    quads.append(_quad([-s + eps, -s, s], [-s + eps, -s, -s],
                       [-s + eps, s, -s], [-s + eps, s, s], [1, 0, 0]))
    # right wall (x = +s), green, normal -x
    quads.append(_quad([s - eps, -s, -s], [s - eps, -s, s],
                       [s - eps, s, s], [s - eps, s, -s], [-1, 0, 0]))

    v = np.concatenate([q[0] for q in quads])
    n = np.concatenate([q[1] for q in quads])
    # materials: 0 white, 1 red, 2 green, 3 blue, 4 yellow
    materials = np.array([
        [1.0, 1.0, 1.0, 1.0],
        [0.9, 0.2, 0.2, 1.0],
        [0.2, 0.9, 0.2, 1.0],
        [0.255, 0.412, 0.882, 1.0],
        [0.9, 0.9, 0.1, 1.0],
    ], np.float32)
    tri_mats = np.array([0, 0, 0, 0, 0, 0, 1, 1, 2, 2], np.int32)

    # fix winding so each front face matches its normal: the single-sided
    # test accepts div = dot(cross(e2,e1), d) > 0 and a front hit has
    # d·normal < 0, so cross(e2,e1) must be ANTI-parallel to the outward
    # normal; flip vertex order where it is not.
    for i in range(v.shape[0]):
        gn = np.cross(v[i, 2] - v[i, 0], v[i, 1] - v[i, 0])  # cross(e2, e1)
        if np.dot(gn, n[i, 0]) > 0:
            v[i] = v[i, ::-1]

    triangles = make_triangles(v, n, tri_mats)
    spheres = make_spheres([sphere_center, sphere2_center],
                           [sphere_radius, sphere2_radius],
                           [3, 4])
    lights = Lights.make([[0.0, 0.85, 0.0]], [[0.0, -1.0, 0.0]],
                         [list(light_irradiance)], [light_radius])
    cam = Camera.look_at([0.0, 0.0, 2.6], [0.0, -0.1, 0.0], [0.0, 1.0, 0.0],
                         60.0, cols, rows)
    return build_scene(camera=cam, spheres=spheres, triangles=triangles,
                       lights=lights, materials=materials,
                       focal_length=focal_length,
                       lens_diameter=lens_diameter)


def big_mesh_scene(name: str = "house_of_parliament.json",
                   cols: int = 512, rows: int = 512) -> Scene:
    """Large-triangle-count scene from a reference mesh JSON (the assets
    the reference's grid exists for — house_of_parliament.json is 5,322
    triangles, ref Assign04-07 tri/). Normalized to the unit cube, one
    overhead disk light, camera auto-framed."""
    import os

    from ..core.types import AABB, Camera, Lights
    from ..io.mesh_json import load_mesh_json, normalize_unit_cube

    path = None
    for d in ["Assign07-3D_uniform_grid_acceleration",
              "Assign06-1D_uniform_slab_acceleration",
              "Assign05-Bounding_Box", "Assign04-Triangle_Mesh",
              "Assign10-Path_Tracing"]:
        from .assignments import REF_ROOT
        p = f"{REF_ROOT}/{d}/tri/{name}"
        if os.path.exists(p):
            path = p
            break
    if path is None:
        raise FileNotFoundError(name)
    md = normalize_unit_cube(load_mesh_json(path))
    tris = make_triangles(md.positions, md.normals, md.material_indices)
    materials = np.asarray(md.materials, np.float32).reshape(-1, 4)
    if materials.size == 0:
        materials = np.array([[0.8, 0.8, 0.8, 1.0]], np.float32)
    lights = Lights.make([[0.0, 2.5, 0.0]], [[0.0, -1.0, 0.0]],
                         [[8.0, 8.0, 8.0]], [0.8])
    import jax.numpy as jnp
    bounds = AABB(pmin=jnp.asarray(md.bounds_min),
                  pmax=jnp.asarray(md.bounds_max))
    cam = Camera.auto_frame(bounds, cols, rows)
    return build_scene(camera=cam, triangles=tris, lights=lights,
                       materials=materials, focal_length=2.0,
                       lens_diameter=0.0)


def sphere_field(n_spheres: int, cols: int = 512, rows: int = 512,
                 seed: int = 7, spread: float = 4.0) -> Scene:
    """Random multi-sphere scene (Assign02-style benchmark scene) with one
    overhead light; camera auto-aimed at the cloud."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, (n_spheres, 3)).astype(np.float32)
    radii = rng.uniform(0.15, 0.5, n_spheres).astype(np.float32)
    mats = rng.integers(0, 5, n_spheres).astype(np.int32)
    materials = np.array([
        [0.9, 0.3, 0.3, 1.0], [0.3, 0.9, 0.3, 1.0], [0.3, 0.3, 0.9, 1.0],
        [0.9, 0.9, 0.3, 1.0], [0.9, 0.9, 0.9, 1.0]], np.float32)
    spheres = make_spheres(centers, radii, mats)
    lights = Lights.make([[0.0, spread * 2.5, 0.0]], [[0.0, -1.0, 0.0]],
                         [[25.0, 25.0, 25.0]], [spread * 0.5])
    cam = Camera.look_at([0.0, 0.0, spread * 3.0], [0.0, 0.0, 0.0],
                         [0.0, 1.0, 0.0], 60.0, cols, rows)
    return build_scene(camera=cam, spheres=spheres, lights=lights,
                       materials=materials, focal_length=float(spread * 3.0),
                       lens_diameter=0.0)
