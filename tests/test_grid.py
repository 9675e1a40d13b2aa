"""Uniform grid: build-layout parity + DDA-vs-brute-force equivalence
(SURVEY §4 item 4: grid-vs-brute-force intersection equivalence)."""
import numpy as np
import jax.numpy as jnp
import pytest

from raytracing_tpu.core.types import Rays, make_spheres, make_triangles
from raytracing_tpu.accel.grid import build_grid, build_sphere_grid, \
    build_triangle_grid
from raytracing_tpu.accel.traverse import grid_closest_spheres, \
    grid_closest_triangles
from raytracing_tpu.ops.closest_hit import closest_hit_spheres, \
    closest_hit_triangles


def random_rays(rng, n, spread=2.0):
    o = rng.normal(size=(n, 3)).astype(np.float32) * spread
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return Rays(o=jnp.array(o), d=jnp.array(d),
                mint=jnp.zeros(n), maxt=jnp.full(n, jnp.inf))


def test_csr_layout(rng):
    # one object spanning several cells must appear in each overlapped cell
    # (cell boundaries at -1, -0.5, 0, 0.5, 1 for n=4)
    lo = np.array([[-0.9, 0.05, 0.05]], np.float32)
    hi = np.array([[0.9, 0.2, 0.2]], np.float32)
    g = build_grid(lo, hi, [-1, -1, -1], [1, 1, 1], 4)
    off = np.array(g.cell_offsets)
    assert off.shape == (4 ** 3 + 1,)
    assert (np.diff(off) >= 0).all()
    # object spans x cells 0..3 at (iy, iz) = (2, 2) -> 4 references
    assert off[-1] == 4
    items = np.array(g.items)
    refs = [(c, k) for c in range(64) for k in range(g.max_per_cell)
            if items[c, k] == 0]
    cells = sorted(c for c, _ in refs)
    assert cells == [2 * 16 + 2 * 4 + ix for ix in range(4)]


def test_csr_native_matches_python(rng):
    n_obj = 40
    lo = rng.uniform(-1, 0.5, (n_obj, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.05, 0.5, (n_obj, 3)).astype(np.float32)
    g_py = build_grid(lo, hi, [-1, -1, -1], [1, 1, 1], 5, use_native=False)
    g_nat = build_grid(lo, hi, [-1, -1, -1], [1, 1, 1], 5, use_native=True)
    assert (np.array(g_py.cell_offsets) == np.array(g_nat.cell_offsets)).all()
    assert (np.array(g_py.item_indices) == np.array(g_nat.item_indices)).all()


@pytest.mark.parametrize("method", ["march", "dense"])
@pytest.mark.parametrize("n_slabs", [1, 2, 4, 5])  # up to 5^3 = 125 cells
def test_grid_spheres_match_brute(rng, n_slabs, method):
    S, R = 30, 200
    cen = rng.uniform(-2, 2, (S, 3)).astype(np.float32)
    rad = rng.uniform(0.1, 0.6, S).astype(np.float32)
    sp = make_spheres(cen, rad, np.arange(S))
    lo, hi = cen - rad[:, None], cen + rad[:, None]
    grid = build_sphere_grid(sp, lo.min(0), hi.max(0), n_slabs)
    rays = random_rays(rng, R)
    brute = closest_hit_spheres(rays, sp)
    gridc = grid_closest_spheres(rays, sp, grid, method=method)
    assert (np.array(gridc.valid) == np.array(brute.valid)).all()
    ok = np.array(brute.valid)
    np.testing.assert_allclose(np.array(gridc.t)[ok], np.array(brute.t)[ok],
                               atol=1e-4)
    assert (np.array(gridc.idx)[ok] == np.array(brute.idx)[ok]).all()


@pytest.mark.parametrize("method", ["march", "dense"])
@pytest.mark.parametrize("n_slabs", [1, 3, 5])  # 5^3: gather cell fetch
@pytest.mark.parametrize("two_sided", [False, True])
def test_grid_triangles_match_brute(rng, n_slabs, two_sided, method):
    T, R = 25, 200
    base = rng.uniform(-2, 2, (T, 1, 3)).astype(np.float32)
    v = base + rng.uniform(-0.6, 0.6, (T, 3, 3)).astype(np.float32)
    tris = make_triangles(v, mat_ids=np.arange(T))
    grid = build_triangle_grid(tris, v.reshape(-1, 3).min(0),
                               v.reshape(-1, 3).max(0), n_slabs)
    rays = random_rays(rng, R)
    brute = closest_hit_triangles(rays, tris, two_sided=two_sided)
    gridc = grid_closest_triangles(rays, tris, grid, two_sided=two_sided,
                                   method=method)
    assert (np.array(gridc.valid) == np.array(brute.valid)).all()
    ok = np.array(brute.valid)
    np.testing.assert_allclose(np.array(gridc.t)[ok], np.array(brute.t)[ok],
                               atol=1e-4)
    assert (np.array(gridc.idx)[ok] == np.array(brute.idx)[ok]).all()


def test_slab_1d_spheres_match_brute(rng):
    """True n x 1 x 1 slab grid (Assign06 code.js:459-513: x-extent binning,
    degenerate y/z march) must agree with brute force."""
    S, R = 30, 200
    cen = rng.uniform(-2, 2, (S, 3)).astype(np.float32)
    rad = rng.uniform(0.1, 0.6, S).astype(np.float32)
    sp = make_spheres(cen, rad, np.arange(S))
    lo, hi = cen - rad[:, None], cen + rad[:, None]
    grid = build_sphere_grid(sp, lo.min(0), hi.max(0), (8, 1, 1))
    assert grid.n == (8, 1, 1)
    assert np.array(grid.cell_offsets).shape == (8 + 1,)
    rays = random_rays(rng, R)
    brute = closest_hit_spheres(rays, sp)
    gridc = grid_closest_spheres(rays, sp, grid)
    assert (np.array(gridc.valid) == np.array(brute.valid)).all()
    ok = np.array(brute.valid)
    np.testing.assert_allclose(np.array(gridc.t)[ok], np.array(brute.t)[ok],
                               atol=1e-4)


def test_csr_native_matches_python_anisotropic(rng):
    n_obj = 40
    lo = rng.uniform(-1, 0.5, (n_obj, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.05, 0.5, (n_obj, 3)).astype(np.float32)
    for n in [(8, 1, 1), (2, 3, 4)]:
        g_py = build_grid(lo, hi, [-1, -1, -1], [1, 1, 1], n,
                          use_native=False)
        g_nat = build_grid(lo, hi, [-1, -1, -1], [1, 1, 1], n,
                           use_native=True)
        assert (np.array(g_py.cell_offsets)
                == np.array(g_nat.cell_offsets)).all()
        assert (np.array(g_py.item_indices)
                == np.array(g_nat.item_indices)).all()


def test_per_mesh_grids_match_folded_brute(rng):
    """Production-parity check for per-mesh independent grids (ref meshTrace
    dispatched once per mesh with its own nslabs, code.js:1293-1303): a
    scene with two mesh instances at DIFFERENT grid resolutions rendered
    through the per-mesh DDA path must equal the folded brute-force render."""
    import dataclasses

    from raytracing_tpu import RenderConfig
    from raytracing_tpu.accel import prepare_grids
    from raytracing_tpu.core.types import MeshInstance
    from raytracing_tpu.models.scenes import cornell_box
    from raytracing_tpu.render.direct import render_direct

    def tetra(center, scale, mat):
        c = np.asarray(center, np.float32)
        p = c + scale * np.array(
            [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
        f = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]])
        v = p[f]
        n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        vn = np.broadcast_to(n[:, None, :], (4, 3, 3)).copy()
        tris = make_triangles(v, vn, np.full(4, mat, np.int32))
        return v, tris

    scene = cornell_box(cols=48, rows=36)
    meshes = []
    for center, nslabs, mat in [((-0.2, -0.4, 0.55), 3, 1),
                                ((0.2, 0.1, 0.3), (2, 1, 1), 2)]:
        v, tris = tetra(center, 0.35, mat)
        meshes.append(MeshInstance(
            tris=tris, bounds_min=jnp.asarray(v.reshape(-1, 3).min(0)),
            bounds_max=jnp.asarray(v.reshape(-1, 3).max(0)), nslabs=nslabs))
    scene = dataclasses.replace(scene, meshes=tuple(meshes))

    cfg_brute = RenderConfig(width=48, height=36, spp=1, bounces=0)
    cfg_grid = dataclasses.replace(cfg_brute, use_grid=True, n_slabs=2)
    gscene = prepare_grids(scene, 2)
    assert gscene.meshes[0].grid.n == (3, 3, 3)
    assert gscene.meshes[1].grid.n == (2, 1, 1)
    img_b = np.asarray(render_direct(scene, cfg_brute))
    img_g = np.asarray(render_direct(gscene, cfg_grid))
    np.testing.assert_allclose(img_g, img_b, atol=2e-5)
    assert img_b.max() > 0.05


def test_grid_respects_ray_window(rng):
    # segment rays that stop before the object must not hit (shadow semantics)
    cen = np.array([[0, 0, -5]], np.float32)
    rad = np.array([1.0], np.float32)
    sp = make_spheres(cen, rad)
    grid = build_sphere_grid(sp, [-1, -1, -6], [1, 1, -4], 2)
    rays = Rays(o=jnp.zeros((2, 3)), d=jnp.array([[0, 0, -1.0]] * 2),
                mint=jnp.zeros(2), maxt=jnp.array([3.0, 10.0]))
    ch = grid_closest_spheres(rays, sp, grid)
    v = np.array(ch.valid)
    assert not v[0] and v[1]


@pytest.mark.parametrize("method", ["march", "dense"])
def test_grid_item_ids_above_2048(method):
    """Item ids past 2048 (where a float cell table read back through a
    reduced-precision matrix product would round them) come back exact:
    ids travel as int32 through the grid's own items table."""
    rng = np.random.default_rng(2048)
    S, R = 2600, 256
    cen = rng.uniform(-4, 4, (S, 3)).astype(np.float32)
    rad = np.full(S, 0.12, np.float32)
    sp = make_spheres(cen, rad, np.arange(S) % 7)
    lo, hi = cen - rad[:, None], cen + rad[:, None]
    g = build_sphere_grid(sp, lo.min(0), hi.max(0), 6)
    # aim every ray at a sphere with a large id
    tgt = rng.integers(2049, S, R)
    o = rng.normal(size=(R, 3)).astype(np.float32) * 6
    d = cen[tgt] - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    rays = Rays(o=jnp.array(o), d=jnp.array(d),
                mint=jnp.zeros(R), maxt=jnp.full(R, jnp.inf))
    ref = closest_hit_spheres(rays, sp)
    got = grid_closest_spheres(rays, sp, g, method=method)
    ok = np.array(ref.valid)
    assert (np.array(got.valid) == ok).all()
    assert (np.array(ref.idx)[ok] > 2048).mean() > 0.3
    # the brute reference uses the expanded quadratic, the grid the omc
    # form: a different champion is accepted only at a float tie in t
    same = np.array(got.idx)[ok] == np.array(ref.idx)[ok]
    assert same.mean() > 0.98
    np.testing.assert_allclose(np.array(got.t)[ok], np.array(ref.t)[ok],
                               rtol=1e-5)
