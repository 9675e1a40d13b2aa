"""The reference's ten-assignment progression as ready-to-run model configs.

Each ``assignNN()`` returns ``(render_fn, args, cfg)`` such that
``render_fn(*args)`` produces an (H, W, 3) float image reproducing that
assignment's capability (SURVEY §0 table):

  01  one sphere, primary rays, fake depth shade     (Assign01 code.cl:116-147)
  02  PDB molecule spheres, closest hit, CPK colors  (Assign02 code.cl:158-232)
  03  wavefront split: ray-gen + trace as separate
      jitted stages over a persistent ray buffer     (Assign03 code.cl:132-187)
  04  triangle mesh + sphere pass composition via
      shared ray.maxt                                (Assign04 code.cl:217-315)
  05  AABB-gated traversal (scene-bounds ray clip)   (Assign05)
  06  1-D slab acceleration (grid with n x 1 x 1)    (Assign06)
  07  full 3-D uniform grid DDA                      (Assign07 code.cl:372-447)
  08  XML scene, shadow rays, ambient+cosine shade   (Assign08 code.cl:916-939)
  09  thin-lens camera, stratified lens sampling     (Assign09 code.cl:1380ish)
  10  progressive Monte Carlo path tracing           (Assign10, SURVEY §3.4)

Reference *data* files (PDB molecules, mesh JSON, XML scenes) are loaded
from /root/reference when present (read-only), else the programmatic scenes
in models/scenes.py are used.
"""
from __future__ import annotations

import os
import jax.numpy as jnp
import numpy as np

from ..core.config import RenderConfig
from ..core.types import AABB, Camera, make_spheres
from ..io.pdb import load_pdb
from ..render.direct import render_direct
from ..render.pathtracer import init_state, image, render_passes
from ..render.simple import render_fake_shade
from .scenes import cornell_box

REF_ROOT = os.environ.get("RT_REFERENCE_DIR", "/root/reference")


def _ref(path: str) -> str | None:
    p = os.path.join(REF_ROOT, path)
    return p if os.path.exists(p) else None


def molecule_scene(name: str = "c60.pdb", cols: int = 512,
                   rows: int = 512):
    """(spheres, per-sphere colors, camera) from a reference PDB file, or a
    synthetic fallback molecule. Camera auto-framed from bounds
    (ref Assign02 code.js:485)."""
    path = _ref(f"Assign02-Multi_Sphere_Ray_Tracing/mol/{name}") \
        or _ref(f"Assign10-Path_Tracing/mol/{name}")
    if path:
        mol = load_pdb(path)
        spheres = make_spheres(mol.centers, mol.radii)
        colors = jnp.asarray(mol.colors[mol.color_ids])
        bounds = AABB(pmin=jnp.asarray(mol.bounds_min),
                      pmax=jnp.asarray(mol.bounds_max))
    else:
        rng = np.random.default_rng(0)
        centers = rng.normal(size=(64, 3)).astype(np.float32) * 3
        radii = rng.uniform(0.6, 1.2, 64).astype(np.float32)
        spheres = make_spheres(centers, radii)
        colors = jnp.asarray(rng.uniform(0.2, 1.0, (64, 4)).astype(np.float32))
        bounds = spheres.bounds()
    cam = Camera.auto_frame(bounds, cols, rows)
    return spheres, colors, cam


def assign01(cols=512, rows=512):
    """Single hard-coded sphere, fake depth shade (Assign01)."""
    spheres = make_spheres([[0.0, 0.0, 0.0]], [0.5])
    colors = jnp.ones((1, 4))
    cam = Camera.look_at([0, 0, 2], [0, 0, 0], [0, 1, 0], 60.0, cols, rows)
    return render_fake_shade, (cam, spheres, colors), RenderConfig(
        width=cols, height=rows)


def assign02(cols=512, rows=512, molecule="c60.pdb"):
    spheres, colors, cam = molecule_scene(molecule, cols, rows)
    return render_fake_shade, (cam, spheres, colors), RenderConfig(
        width=cols, height=rows)


def assign03(cols=512, rows=512, molecule="c60.pdb"):
    """Wavefront split: explicit ray-gen stage + trace stage sharing a
    persistent ray buffer (the Assign03 two-kernel structure)."""
    import jax

    from ..ops.closest_hit import closest_hit_spheres, fetch_rows, \
        sphere_hit_attrs
    from ..render.camera import pinhole_rays, pixel_grid

    spheres, colors, cam = molecule_scene(molecule, cols, rows)

    @jax.jit
    def gen_stage():
        col, row = pixel_grid(cam)
        return pinhole_rays(cam, col, row)

    @jax.jit
    def trace_stage(rays):
        ch = closest_hit_spheres(rays, spheres)
        _, n, _ = sphere_hit_attrs(rays, spheres, ch)
        shade = jnp.sum(cam.w[None, :] * n, -1)
        rgb = fetch_rows(colors[:, :3], ch.idx) * shade[:, None]
        img = jnp.where(ch.valid[:, None], rgb, 0.0)
        return img.reshape(cam.rows, cam.cols, 3)

    def run():
        rays = gen_stage()       # kernel 1: initTrace analog
        return trace_stage(rays)  # kernel 2: molTrace analog

    return run, (), RenderConfig(width=cols, height=rows)


def _mesh_scene(cols, rows, use_grid: bool, n_slabs: int = 1,
                slab_1d: bool = False):
    scene = cornell_box(cols=cols, rows=rows)
    cfg = RenderConfig(width=cols, height=rows, spp=1, bounces=0,
                       use_grid=use_grid, n_slabs=n_slabs)
    if use_grid:
        from ..accel import prepare_grids
        scene = prepare_grids(scene, n_slabs)
    return scene, cfg


def assign04(cols=512, rows=512):
    """Triangle mesh + spheres composed through shared maxt; direct shade."""
    scene, cfg = _mesh_scene(cols, rows, use_grid=False)
    return render_direct, (scene, cfg), cfg


def assign05(cols=512, rows=512):
    """AABB culling: same pipeline — every ray is clipped to the scene AABB
    (ref initTrace bound arg, Assign05 code.cl:304-325); object-level AABB
    gates are inherent to the grid path."""
    return assign04(cols, rows)


def assign06(cols=512, rows=512, n_slabs=8):
    """1-D slab acceleration (historical Assign06, code.js:459-513): a TRUE
    n x 1 x 1 grid — binning by x-extent only, the DDA marching along x with
    the y/z axes degenerate (single slab)."""
    scene, cfg = _mesh_scene(cols, rows, use_grid=True,
                             n_slabs=(n_slabs, 1, 1))
    return render_direct, (scene, cfg), cfg


def assign07(cols=512, rows=512, n_slabs=4, scene_xml: str | None = None,
             mesh_slabs: int | str = "xml"):
    """Full 3-D uniform grid DDA. ``scene_xml`` swaps in a mesh-instancing
    XML scene (e.g. cornell_teapot.xml — the asset class the reference's
    grid exists for); each large mesh then gets its own grid at its XML
    ``nslabs`` (``mesh_slabs="xml"``, the reference's per-mesh meshTrace
    dispatch) or at an int override, while the walls run brute
    (code.js:1293-1303)."""
    if scene_xml is not None:
        from ..accel import prepare_grids
        from ..io.scene_xml import load_scene
        scene = prepare_grids(load_scene(scene_xml, cols, rows), n_slabs,
                              mesh_slabs=mesh_slabs)
        cfg = RenderConfig(width=cols, height=rows, spp=1, bounces=0,
                           use_grid=True, n_slabs=n_slabs)
        return render_direct, (scene, cfg), cfg
    scene, cfg = _mesh_scene(cols, rows, use_grid=True, n_slabs=n_slabs)
    return render_direct, (scene, cfg), cfg


def assign08(cols=320, rows=240, scene_xml: str | None = None):
    """XML scene + point/disk lights + shadow rays + ambient-cosine shade."""
    if scene_xml is None:
        scene_xml = _ref("Assign08-Shadow_Tracing/scenes/cornell.xml")
    if scene_xml:
        from ..io.scene_xml import load_scene
        scene = load_scene(scene_xml, cols, rows)
    else:
        scene = cornell_box(cols=cols, rows=rows)
    cfg = RenderConfig(width=cols, height=rows, spp=1, bounces=0)
    return render_direct, (scene, cfg), cfg


def assign09(cols=320, rows=240, spp=4, focal_length=2.8,
             lens_diameter=0.25):
    """Thin-lens depth of field with stratified lens sampling."""
    scene = cornell_box(cols=cols, rows=rows, focal_length=focal_length,
                        lens_diameter=lens_diameter)
    cfg = RenderConfig(width=cols, height=rows, spp=spp, bounces=0)
    return render_direct, (scene, cfg), cfg


def assign10(cols=320, rows=240, spp=1, bounces=5, passes=32,
             scene_xml: str | None = None):
    """Progressive Monte Carlo path tracing (the flagship pipeline)."""
    if scene_xml:
        from ..io.scene_xml import load_scene
        scene = load_scene(scene_xml, cols, rows)
    else:
        scene = cornell_box(cols=cols, rows=rows)
    cfg = RenderConfig(width=cols, height=rows, spp=spp, bounces=bounces)

    def run():
        state = init_state(cfg)
        state = render_passes(scene, state, cfg, passes)
        return image(state, cfg)

    return run, (), cfg


ALL = {f"assign{i:02d}": fn for i, fn in enumerate(
    [assign01, assign02, assign03, assign04, assign05, assign06, assign07,
     assign08, assign09, assign10], start=1)}
