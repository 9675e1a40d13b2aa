"""Intersection ops vs the NumPy oracle (SURVEY §4: oracle allclose tests)."""
import numpy as np
import jax.numpy as jnp
import pytest

from raytracing_tpu.core.types import Rays, make_spheres, make_triangles
from raytracing_tpu.ops import intersect as I
from raytracing_tpu.ops.closest_hit import (
    anyhit_spheres, anyhit_triangles,
    closest_hit_spheres, closest_hit_triangles,
    sphere_hit_attrs, triangle_hit_attrs,
)
import oracle


def random_rays(rng, n, spread=1.0):
    o = rng.normal(size=(n, 3)).astype(np.float32) * spread
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    mint = np.zeros(n, np.float32)
    maxt = np.full(n, np.inf, np.float32)
    return o, d, mint, maxt


@pytest.mark.parametrize("formulation", ["matmul", "pairwise"])
def test_sphere_ts_vs_oracle(rng, formulation):
    R, S = 48, 33
    o, d, mint, maxt = random_rays(rng, R)
    cen = (rng.normal(size=(S, 3)) * 2).astype(np.float32)
    rad = rng.uniform(0.1, 0.8, S).astype(np.float32)
    fn = I.sphere_ts_matmul if formulation == "matmul" else I.sphere_ts_pairwise
    ts = np.array(fn(jnp.array(o), jnp.array(d), jnp.array(mint),
                     jnp.array(maxt), jnp.array(cen), jnp.array(rad),
                     jnp.ones(S, bool)))
    if formulation == "matmul":  # matmul form is (S, R): objects first
        ts = ts.T
    ts_o = oracle.sphere_ts(o, d, mint, maxt, cen, rad)
    fin = np.isfinite(ts_o)
    assert (np.isfinite(ts) == fin).mean() > 0.999
    both = fin & np.isfinite(ts)
    np.testing.assert_allclose(ts[both], ts_o[both], atol=5e-5)


@pytest.mark.parametrize("formulation", ["matmul", "pairwise"])
@pytest.mark.parametrize("two_sided", [False, True])
def test_triangle_ts_vs_oracle(rng, formulation, two_sided):
    R, T = 48, 29
    o, d, mint, maxt = random_rays(rng, R)
    v = rng.normal(size=(T, 3, 3)).astype(np.float32)
    if formulation == "matmul":
        ts = I.triangle_ts_matmul(jnp.array(o), jnp.array(d), jnp.array(mint),
                                  jnp.array(maxt), I.tri_constants(jnp.array(v)),
                                  jnp.ones(T, bool), two_sided=two_sided).T
    else:
        ts = I.triangle_ts_pairwise(jnp.array(o), jnp.array(d), jnp.array(mint),
                                    jnp.array(maxt), jnp.array(v),
                                    jnp.ones(T, bool), two_sided=two_sided)
    ts = np.array(ts)
    ts_o = oracle.triangle_ts(o, d, mint, maxt, v, two_sided=two_sided)
    fin = np.isfinite(ts_o)
    assert (np.isfinite(ts) == fin).mean() > 0.999
    both = fin & np.isfinite(ts)
    np.testing.assert_allclose(ts[both], ts_o[both], atol=1e-5)


def test_sphere_window_clipping(rng):
    # a hit outside [mint, maxt] must be rejected; tmax root used when
    # origin is inside the sphere (ref code.cl:222-236)
    o = np.zeros((2, 3), np.float32)
    d = np.array([[0, 0, -1], [0, 0, -1]], np.float32)
    cen = np.array([[0, 0, -5]], np.float32)
    rad = np.array([1.0], np.float32)
    mint = np.array([0.0, 4.5], np.float32)
    maxt = np.array([np.inf, np.inf], np.float32)
    ts = np.array(I.sphere_ts_matmul(jnp.array(o), jnp.array(d),
                                     jnp.array(mint), jnp.array(maxt),
                                     jnp.array(cen), jnp.array(rad),
                                     jnp.ones(1, bool)))  # (S, R)
    assert np.isclose(ts[0, 0], 4.0)
    assert np.isclose(ts[0, 1], 6.0)  # near root 4.0 < mint -> far root


def test_single_sided_rejects_backface():
    # winding: triangle visible only from the div>0 side (ref code.cl:257)
    v = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    o = np.array([[0.2, 0.2, 1.0], [0.2, 0.2, -1.0]], np.float32)
    d = np.array([[0, 0, -1], [0, 0, 1]], np.float32)
    mint = np.zeros(2, np.float32)
    maxt = np.full(2, np.inf, np.float32)
    tc = I.tri_constants(jnp.array(v))
    ts = np.array(I.triangle_ts_matmul(jnp.array(o), jnp.array(d),
                                       jnp.array(mint), jnp.array(maxt),
                                       tc, jnp.ones(1, bool)))  # (T, R)
    hits = np.isfinite(ts[0, :])
    assert hits.sum() == 1  # exactly one side sees it
    ts2 = np.array(I.triangle_ts_matmul(jnp.array(o), jnp.array(d),
                                        jnp.array(mint), jnp.array(maxt),
                                        tc, jnp.ones(1, bool), two_sided=True))
    assert np.isfinite(ts2[0, :]).all()


def test_champion_matches_oracle_argmin(rng):
    R, S = 40, 21
    o, d, mint, maxt = random_rays(rng, R)
    cen = (rng.normal(size=(S, 3)) * 2).astype(np.float32)
    rad = rng.uniform(0.2, 0.9, S).astype(np.float32)
    rays = Rays(o=jnp.array(o), d=jnp.array(d), mint=jnp.array(mint),
                maxt=jnp.array(maxt))
    ch = closest_hit_spheres(rays, make_spheres(cen, rad), obj_chunk=8)
    ts_o = oracle.sphere_ts(o, d, mint, maxt, cen, rad)
    best, bi = ts_o.min(-1), ts_o.argmin(-1)
    ok = np.isfinite(best)
    assert (np.array(ch.valid) == ok).all()
    np.testing.assert_allclose(np.array(ch.t)[ok], best[ok], atol=5e-5)
    assert (np.array(ch.idx)[ok] == bi[ok]).all()


def test_champion_triangles_and_attrs(rng):
    R, T = 40, 17
    o, d, mint, maxt = random_rays(rng, R)
    v = rng.normal(size=(T, 3, 3)).astype(np.float32)
    rays = Rays(o=jnp.array(o), d=jnp.array(d), mint=jnp.array(mint),
                maxt=jnp.array(maxt))
    tris = make_triangles(v, mat_ids=np.arange(T))
    ch = closest_hit_triangles(rays, tris, obj_chunk=5)
    ts_o = oracle.triangle_ts(o, d, mint, maxt, v)
    best, bi = ts_o.min(-1), ts_o.argmin(-1)
    ok = np.isfinite(best)
    assert (np.array(ch.valid) == ok).all()
    np.testing.assert_allclose(np.array(ch.t)[ok], best[ok], atol=2e-5)
    p, n, mat = triangle_hit_attrs(rays, tris, ch)
    assert (np.array(mat)[ok] == bi[ok]).all()
    assert (np.array(mat)[~ok] == -1).all()
    nn = np.array(n)[ok]
    np.testing.assert_allclose(np.linalg.norm(nn, axis=-1), 1.0, atol=1e-5)


def test_dead_rays_never_hit(rng):
    cen = np.array([[0, 0, -5]], np.float32)
    rad = np.array([1.0], np.float32)
    rays = Rays(o=jnp.zeros((4, 3)),
                d=jnp.array([[0, 0, -1]] * 4, jnp.float32),
                mint=jnp.full((4,), 7.0), maxt=jnp.full((4,), 7.0))
    ch = closest_hit_spheres(rays, make_spheres(cen, rad))
    assert not np.array(ch.valid).any()


def test_padding_mask_excluded(rng):
    cen = np.array([[0, 0, -5]], np.float32)
    rad = np.array([1.0], np.float32)
    sp = make_spheres(cen, rad, pad_to=8)
    rays = Rays(o=jnp.zeros((1, 3)), d=jnp.array([[0, 0, -1.0]]),
                mint=jnp.zeros(1), maxt=jnp.full(1, jnp.inf))
    ch = closest_hit_spheres(rays, sp, obj_chunk=4)
    assert np.array(ch.valid)[0] and np.array(ch.idx)[0] == 0
    assert np.isclose(np.array(ch.t)[0], 4.0)


def test_anyhit(rng):
    cen = np.array([[0, 0, -5]], np.float32)
    rad = np.array([1.0], np.float32)
    # ray 0: segment ends before the sphere (maxt=3) -> free
    # ray 1: segment crosses it -> occluded
    rays = Rays(o=jnp.zeros((2, 3)), d=jnp.array([[0, 0, -1.0]] * 2),
                mint=jnp.zeros(2), maxt=jnp.array([3.0, 10.0]))
    occ = np.array(anyhit_spheres(rays, make_spheres(cen, rad)))
    assert not occ[0] and occ[1]


def test_aabb_window_vs_oracle(rng):
    R = 64
    o, d, _, _ = random_rays(rng, R, spread=3.0)
    pmin = np.array([-1.0, -2.0, -1.5])
    pmax = np.array([1.0, 0.5, 2.0])
    tmin, tmax, ok = I.aabb_window(jnp.array(o), jnp.array(d),
                                   jnp.array(pmin, dtype=jnp.float32),
                                   jnp.array(pmax, dtype=jnp.float32))
    tmin_o, tmax_o, ok_o = oracle.aabb_window(o, d, pmin, pmax)
    assert (np.array(ok) == ok_o).mean() > 0.98
    both = np.array(ok) & ok_o
    np.testing.assert_allclose(np.array(tmin)[both], tmin_o[both], atol=1e-4)
    np.testing.assert_allclose(np.array(tmax)[both],
                               np.minimum(tmax_o[both], 3e38), rtol=1e-4)


def test_light_disk(rng):
    pos = jnp.array([0.0, 1.0, 0.0])
    nrm = jnp.array([0.0, -1.0, 0.0])
    o = jnp.array([[0.0, 0.0, 0.0], [0.5, 0.0, 0.0], [0.0, 0.0, 0.0]])
    d = jnp.array([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]])
    t = np.array(I.light_disk_t(o, d, pos, nrm, jnp.float32(0.2)))
    assert np.isclose(t[0], 1.0)       # straight up through center
    assert not np.isfinite(t[1])       # off-disk (0.5 > r)
    assert not np.isfinite(t[2])       # parallel to plane
