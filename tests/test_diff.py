"""Gradients vs finite differences (SURVEY §4 item 3; BASELINE.json
pixel-gradient allclose)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracing_tpu import RenderConfig, Camera, make_spheres, replace
from raytracing_tpu.diff.fd import check_grad, finite_difference
from raytracing_tpu.diff.soft import render_fake_shade_soft
from raytracing_tpu.models.scenes import cornell_box
from raytracing_tpu.render import pathtracer
from raytracing_tpu.render.simple import render_fake_shade


COLORS = jnp.array([[0.9, 0.4, 0.2, 1.0], [0.2, 0.5, 0.9, 1.0]])


def _cam(cols=24, rows=18):
    return Camera.look_at([0, 0, 3], [0, 0, 0], [0, 1, 0], 60.0, cols, rows)


def _interior_mask(img_fn, x, thresh=0.0):
    """Pixels whose 4-neighborhood is uniformly hit — visibility-stable
    under small perturbations, where hard-renderer AD == FD."""
    img = np.array(img_fn(x))
    hit = img.sum(-1) > thresh
    m = hit.copy()
    m[1:] &= hit[:-1]
    m[:-1] &= hit[1:]
    m[:, 1:] &= hit[:, :-1]
    m[:, :-1] &= hit[:, 1:]
    # also erode once more for safety
    m2 = m.copy()
    m2[1:] &= m[:-1]; m2[:-1] &= m[1:]
    m2[:, 1:] &= m[:, :-1]; m2[:, :-1] &= m[:, 1:]
    return jnp.asarray(m2)


def test_grad_sphere_center_interior():
    cam = _cam()
    radius = jnp.array([0.55, 0.35])

    def img_of(center):
        sp = make_spheres(center, radius)
        return render_fake_shade(cam, sp, COLORS)

    center0 = jnp.array([[-0.4, 0.0, 0.0], [0.55, 0.1, 0.3]])
    m = _interior_mask(img_of, center0)

    def loss(center):
        img = img_of(center)
        return jnp.sum(img * m[:, :, None]) / jnp.sum(m)

    check_grad(loss, center0, eps=1e-3, rtol=0.08, atol=1e-3)


def test_grad_sphere_radius_interior():
    cam = _cam()
    center = jnp.array([[-0.4, 0.0, 0.0], [0.55, 0.1, 0.3]])

    def img_of(radius):
        sp = make_spheres(center, radius)
        return render_fake_shade(cam, sp, COLORS)

    r0 = jnp.array([0.55, 0.35])
    m = _interior_mask(img_of, r0)

    def loss(radius):
        img = img_of(radius)
        return jnp.sum(img * m[:, :, None]) / jnp.sum(m)

    check_grad(loss, r0, eps=1e-3, rtol=0.08, atol=1e-3)


def test_grad_camera_eye_interior():
    radius = jnp.array([0.55, 0.35])
    center = jnp.array([[-0.4, 0.0, 0.0], [0.55, 0.1, 0.3]])
    sp = make_spheres(center, radius)

    def img_of(eye):
        cam = Camera.look_at(eye, [0, 0, 0], [0, 1, 0], 60.0, 24, 18)
        return render_fake_shade(cam, sp, COLORS)

    eye0 = jnp.array([0.0, 0.0, 3.0])
    m = _interior_mask(img_of, eye0)

    def loss(eye):
        return jnp.sum(img_of(eye) * m[:, :, None]) / jnp.sum(m)

    check_grad(loss, eye0, eps=1e-3, rtol=0.08, atol=1e-3)


def test_grad_albedo_pathtracer_exact():
    # albedo enters the estimator smoothly -> AD must match FD tightly
    cfg = RenderConfig(width=16, height=12, spp=1, bounces=2, seed=7)
    scene = cornell_box(cols=16, rows=12)

    def loss(materials):
        sc = replace(scene, materials=materials)
        state = pathtracer.init_state(cfg)
        state = pathtracer.render_passes(sc, state, cfg, 1)
        return jnp.mean(state["acc"])

    check_grad(loss, scene.materials, eps=1e-3, rtol=0.03, atol=1e-5)


def test_grad_light_irradiance_linear():
    # acc is LINEAR in irradiance through NEE -> grads exact
    cfg = RenderConfig(width=12, height=8, spp=1, bounces=1, seed=3)
    scene = cornell_box(cols=12, rows=8)

    def loss(irr):
        lights = dataclasses.replace(scene.lights, irradiance=irr)
        sc = replace(scene, lights=lights)
        state = pathtracer.init_state(cfg)
        state = pathtracer.render_passes(sc, state, cfg, 1)
        return jnp.mean(state["acc"])

    check_grad(loss, scene.lights.irradiance, eps=1e-2, rtol=0.02, atol=1e-6)


def test_soft_renderer_grad_everywhere():
    cam = _cam(16, 12)
    radius = jnp.array([0.55, 0.35])

    def loss(center):
        sp = make_spheres(center, radius)
        img = render_fake_shade_soft(cam, sp, COLORS,
                                     bandwidth=0.05, tau=0.05)
        return jnp.mean(img)

    center0 = jnp.array([[-0.4, 0.0, 0.0], [0.55, 0.1, 0.3]])
    # includes silhouette motion: the soft renderer's AD matches its own FD
    check_grad(loss, center0, eps=1e-3, rtol=0.05, atol=1e-5)


def test_soft_converges_to_hard():
    cam = _cam(32, 24)
    center = jnp.array([[-0.4, 0.0, 0.0], [0.55, 0.1, 0.3]])
    radius = jnp.array([0.55, 0.35])
    sp = make_spheres(center, radius)
    hard = np.array(render_fake_shade(cam, sp, COLORS))
    soft = np.array(render_fake_shade_soft(cam, sp, COLORS,
                                           bandwidth=1e-4, tau=1e-4))
    # agree away from edges
    diff = np.abs(hard - soft).max(-1)
    assert np.quantile(diff, 0.9) < 5e-3


def test_grad_triangle_vertices_interior():
    # BASELINE.json: gradients wrt triangle vertices. A big quad faces the
    # camera; loss over interior pixels -> AD == FD.
    import jax.numpy as jnp
    from raytracing_tpu import make_triangles
    from raytracing_tpu.ops.closest_hit import (closest_hit_triangles,
                                                triangle_hit_attrs)
    from raytracing_tpu.render.camera import pinhole_rays, pixel_grid

    cam = _cam(20, 16)

    def img_of(v):
        tris = make_triangles(v)
        col, row = pixel_grid(cam)
        rays = pinhole_rays(cam, col, row)
        ch = closest_hit_triangles(rays, tris)
        p, n, _ = triangle_hit_attrs(rays, tris, ch)
        # depth+normal shading: depends smoothly on vertex positions
        shade = jnp.where(ch.valid, jnp.einsum("j,ij->i", cam.w, n)
                          / (1.0 + ch.t), 0.0)
        return shade.reshape(16, 20, 1)

    # one big slightly-tilted triangle (a second one would add an interior
    # shared edge whose visibility flips under FD perturbation)
    v0 = jnp.array([[[-2.0, -2.0, 0.0], [2.0, -2.0, -0.3], [0.0, 2.5, 0.1]]])
    m = _interior_mask(img_of, v0)

    def loss(v):
        return jnp.sum(img_of(v)[:, :, 0] * m) / jnp.sum(m)

    check_grad(loss, v0, eps=1e-3, rtol=0.08, atol=1e-3)


def test_pathtracer_geometry_grad_finite():
    # gradients wrt sphere centers through the full path tracer stay finite
    cfg = RenderConfig(width=12, height=8, spp=1, bounces=2, seed=11)
    scene = cornell_box(cols=12, rows=8)

    def loss(center):
        spheres = dataclasses.replace(scene.spheres, center=center)
        sc = replace(scene, spheres=spheres)
        state = pathtracer.init_state(cfg)
        state = pathtracer.render_passes(sc, state, cfg, 1)
        return jnp.mean(state["acc"])

    g = jax.grad(loss)(scene.spheres.center)
    assert np.isfinite(np.array(g)).all()
    assert np.abs(np.array(g)).sum() > 0


# ---------------------------------------------------------------------------
# Edge-aware gradients through the REAL direct-lighting pipeline: FD-allclose
# on a full-image loss — NO interior masking, silhouette and shadow-boundary
# pixels included (VERDICT r1 item 5; BASELINE.json north star).
# ---------------------------------------------------------------------------

def _soft_scene(cols=48, rows=36):
    from raytracing_tpu.diff.soft import render_direct_soft
    cfg = RenderConfig(width=cols, height=rows, spp=1, bounces=0)
    scene = cornell_box(cols=cols, rows=rows)
    return scene, cfg, render_direct_soft


def test_soft_direct_fd_allclose_sphere_center_no_mask():
    scene, cfg, render_soft = _soft_scene()

    def loss(c):
        sc = dataclasses.replace(
            scene, spheres=dataclasses.replace(scene.spheres, center=c))
        return jnp.mean(render_soft(sc, cfg, bandwidth=1e-2, tau=1e-2))

    g = np.asarray(jax.grad(loss)(scene.spheres.center))
    c0 = np.asarray(scene.spheres.center)
    eps = 5e-4
    for i in range(c0.shape[0]):
        for j in range(3):
            e = np.zeros_like(c0)
            e[i, j] = eps
            fd = float((loss(jnp.asarray(c0 + e))
                        - loss(jnp.asarray(c0 - e))) / (2 * eps))
            assert abs(g[i, j] - fd) < 2e-4 + 5e-3 * abs(fd), (i, j, g[i, j], fd)
    assert np.abs(g).max() > 1e-3      # silhouette terms present


def test_soft_direct_fd_allclose_triangle_vertex_no_mask():
    scene, cfg, render_soft = _soft_scene()

    def loss(v):
        sc = dataclasses.replace(
            scene, triangles=dataclasses.replace(scene.triangles, v=v))
        return jnp.mean(render_soft(sc, cfg, bandwidth=1e-2, tau=1e-2))

    g = np.asarray(jax.grad(loss)(scene.triangles.v))
    v0 = np.asarray(scene.triangles.v)
    eps = 5e-4
    for (ti, vi, ci) in [(6, 0, 0), (6, 1, 1), (8, 2, 2), (2, 0, 1)]:
        e = np.zeros_like(v0)
        e[ti, vi, ci] = eps
        fd = float((loss(jnp.asarray(v0 + e))
                    - loss(jnp.asarray(v0 - e))) / (2 * eps))
        assert abs(g[ti, vi, ci] - fd) < 2e-4 + 5e-3 * abs(fd), \
            (ti, vi, ci, g[ti, vi, ci], fd)
    assert np.isfinite(g).all()


def test_soft_direct_converges_to_hard():
    from raytracing_tpu.render.direct import render_direct
    scene, cfg, render_soft = _soft_scene()
    hard = np.asarray(render_direct(scene, cfg))
    l1 = []
    for bw in [2e-2, 5e-3, 1e-3]:
        soft = np.asarray(render_soft(scene, cfg, bandwidth=bw, tau=bw))
        l1.append(np.abs(soft - hard).mean())
    assert l1[0] > l1[1] > l1[2]
    assert l1[2] < 0.02


# ---------------------------------------------------------------------------
# Soft PATH TRACER (full Assign10 schedule — silhouettes included)
# ---------------------------------------------------------------------------

def _soft_pt_setup(cols=32, rows=24, bounces=1):
    from raytracing_tpu.diff.soft import render_pathtrace_soft
    from raytracing_tpu.models.scenes import cornell_box
    scene = cornell_box(cols=cols, rows=rows)
    cfg = RenderConfig(width=cols, height=rows, spp=1, bounces=bounces)
    return scene, cfg, render_pathtrace_soft


def test_soft_pathtracer_converges_to_hard():
    """bandwidth, tau -> 0: the soft path tracer's accumulator approaches
    the hard pipeline's with IDENTICAL draws (same pass_key slot layout);
    residual is confined to edge pixels."""
    from raytracing_tpu.render import pathtracer
    scene, cfg, render_soft = _soft_pt_setup()
    soft = np.asarray(render_soft(scene, cfg, bandwidth=2e-4, tau=2e-4))
    st = pathtracer.init_state(cfg)
    hard = np.asarray(pathtracer._render_pass(scene, st, cfg)["acc"]) \
        .reshape(cfg.height, cfg.width, 3)
    d = np.abs(soft - hard)
    assert d.mean() < 2e-3
    assert (d < 1e-2).mean() > 0.98


def test_soft_pathtracer_fd_allclose_sphere_center_no_mask():
    """FD vs AD of a FULL-IMAGE loss (no interior masking — silhouette
    pixels included) through the complete path-tracing schedule: emitter
    hits, NEE soft shadows, one cosine bounce. eps must sit below the
    tangent-frame flip scale (FD at coarser steps straddles that
    genuine discontinuity of the estimator; AD matches the eps->0 limit)."""
    scene, cfg, render_soft = _soft_pt_setup()

    def loss(c):
        sc = dataclasses.replace(
            scene, spheres=dataclasses.replace(scene.spheres, center=c))
        return jnp.mean(render_soft(sc, cfg, bandwidth=1e-2, tau=1e-2))

    g = np.asarray(jax.grad(loss)(scene.spheres.center))
    assert np.isfinite(g).all()
    c0 = np.asarray(scene.spheres.center)
    eps = 1e-4
    for i in range(c0.shape[0]):
        for j in range(3):
            e = np.zeros_like(c0)
            e[i, j] = eps
            fd = float((loss(jnp.asarray(c0 + e))
                        - loss(jnp.asarray(c0 - e))) / (2 * eps))
            assert abs(g[i, j] - fd) < 2e-3 + 5e-2 * abs(fd), \
                (i, j, g[i, j], fd)
    assert np.abs(g).max() > 1e-3       # silhouette terms present


def test_soft_pathtracer_fd_allclose_triangle_vertex_no_mask():
    """FD vs AD of a full-image loss wrt a WALL triangle vertex through the
    soft path tracer (bounce included) — edge pixels unmasked."""
    scene, cfg, render_soft = _soft_pt_setup()
    v0 = np.asarray(scene.triangles.v)

    def loss(v):
        sc = dataclasses.replace(
            scene, triangles=dataclasses.replace(scene.triangles, v=v))
        return jnp.mean(render_soft(sc, cfg, bandwidth=1e-2, tau=1e-2))

    g = np.asarray(jax.grad(loss)(scene.triangles.v))
    assert np.isfinite(g).all()
    eps = 1e-4
    checked = 0
    # probe the largest-gradient components (where the signal lives)
    flat = np.abs(g).ravel()
    for idx in np.argsort(flat)[::-1][:6]:
        i, j, k = np.unravel_index(idx, g.shape)
        e = np.zeros_like(v0)
        e[i, j, k] = eps
        fd = float((loss(jnp.asarray(v0 + e))
                    - loss(jnp.asarray(v0 - e))) / (2 * eps))
        assert abs(g[i, j, k] - fd) < 3e-3 + 5e-2 * abs(fd), \
            (int(i), int(j), int(k), g[i, j, k], fd)
        checked += 1
    assert checked == 6 and np.abs(g).max() > 1e-3


def test_auto_slabs_resolution():
    from raytracing_tpu.accel import auto_slabs, prepare_grids
    from raytracing_tpu.models.scenes import cornell_box
    assert auto_slabs(32) == 1
    assert auto_slabs(1012) == 3
    assert auto_slabs(5322) == 5
    scene = prepare_grids(cornell_box(cols=8, rows=8), "auto")
    assert scene.triangle_grid.n == (1, 1, 1)
    assert scene.sphere_grid.n == (1, 1, 1)
