"""End-to-end renderer tests (SURVEY §4: oracle image allclose, golden
behavior, progressive accumulation, checkpoint/resume)."""
import numpy as np
import jax.numpy as jnp

from raytracing_tpu import Camera, RenderConfig, make_spheres, replace
from raytracing_tpu.accel import prepare_grids
from raytracing_tpu.models.scenes import cornell_box
from raytracing_tpu.render import pathtracer
from raytracing_tpu.render.direct import render_direct
from raytracing_tpu.render.simple import render_fake_shade
import oracle


def test_fake_shade_matches_oracle(rng):
    cols, rows = 24, 18
    cam = Camera.look_at([0, 0, 3], [0, 0, 0], [0, 1, 0], 60.0, cols, rows)
    centers = np.array([[-0.5, 0, 0], [0.6, 0.2, 0.4]], np.float32)
    radii = np.array([0.5, 0.3], np.float32)
    colors = np.array([[0.9, 0.4, 0.2, 1], [0.2, 0.5, 0.9, 1]], np.float32)
    img = np.array(render_fake_shade(cam, make_spheres(centers, radii),
                                     jnp.asarray(colors)))
    img_o = oracle.fake_shade_image(
        np.array(cam.eye), np.array(cam.w),
        (np.array(cam.u), np.array(cam.v), np.array(cam.w),
         float(cam.width), float(cam.height)),
        centers, radii, colors, cols, rows)
    np.testing.assert_allclose(img, img_o, atol=2e-4)


def test_direct_renderer_shadows():
    # the sphere must cast a shadow on the floor: some floor pixels darker
    scene = cornell_box(cols=48, rows=36)
    cfg = RenderConfig(width=48, height=36, spp=1, bounces=0)
    img = np.array(render_direct(scene, cfg))
    assert np.isfinite(img).all()
    assert img.max() > 0.3
    floor = img[30:, 8:40].reshape(-1, 3).sum(-1)
    # ambient floor: shadowed pixels near ambient*albedo, lit pixels higher
    assert floor.min() < 0.75 * floor.max()


def test_direct_progressive_passes():
    """n_passes accumulation: same estimator (means agree within MC noise);
    the routed entry point equals the XLA route with the same pass keys."""
    import dataclasses

    import jax.numpy as jnp

    scene = cornell_box(cols=48, rows=36)
    cfg = RenderConfig(width=48, height=36, spp=1, bounces=0)
    i1 = np.array(render_direct(scene, cfg))
    i8 = np.array(render_direct(scene, cfg, n_passes=8))
    assert np.isfinite(i8).all()
    assert abs(i1.mean() - i8.mean()) < 0.05 * max(i1.mean(), 1e-6)

    from raytracing_tpu.render import route
    from raytracing_tpu.render.direct import render_direct_xla
    assert route.forward(scene, cfg) == route.XLA
    x8 = np.array(render_direct_xla(scene, cfg, None, 8))
    np.testing.assert_allclose(x8, i8, rtol=2e-4, atol=2e-4)

    # thin-lens spp>1 (stratified lens + fresh light samples per pass)
    scene2 = dataclasses.replace(scene, lens_radius=jnp.float32(0.1))
    cfg4 = RenderConfig(width=32, height=24, spp=4, bounces=0)
    t1 = np.array(render_direct(scene2, cfg4))
    t8 = np.array(render_direct(scene2, cfg4, n_passes=8))
    assert abs(t1.mean() - t8.mean()) < 0.05 * max(t1.mean(), 1e-6)


def test_pathtracer_progressive_mean_stable():
    scene = cornell_box(cols=32, rows=24)
    cfg = RenderConfig(width=32, height=24, spp=1, bounces=2, seed=5)
    st = pathtracer.init_state(cfg)
    st4 = pathtracer.render_passes(scene, st, cfg, 4)
    st16 = pathtracer.render_passes(scene, st4, cfg, 12)
    img4 = np.array(pathtracer.image(st4, cfg))
    img16 = np.array(pathtracer.image(st16, cfg))
    assert int(st16["passes"]) == 16
    # progressive estimates of the same integral: means agree within MC noise
    assert abs(img4.mean() - img16.mean()) < 0.05 * max(img16.mean(), 1e-6)
    # and more passes reduce noise vs a fresh 4-pass render w/ different seed
    cfg2 = RenderConfig(width=32, height=24, spp=1, bounces=2, seed=99)
    stb = pathtracer.render_passes(scene, pathtracer.init_state(cfg2), cfg2, 4)
    imgb = np.array(pathtracer.image(stb, cfg2))
    assert np.abs(img4 - imgb).mean() > 0  # different seeds differ (sanity)


def test_pathtracer_spp_equivalence():
    # spp=4 x 1 pass integrates like spp=1 x several passes (same estimator)
    scene = cornell_box(cols=16, rows=12)
    cfg1 = RenderConfig(width=16, height=12, spp=1, bounces=1, seed=3)
    cfg4 = RenderConfig(width=16, height=12, spp=4, bounces=1, seed=3)
    st1 = pathtracer.render_passes(scene, pathtracer.init_state(cfg1), cfg1, 8)
    st4 = pathtracer.render_passes(scene, pathtracer.init_state(cfg4), cfg4, 2)
    img1 = np.array(pathtracer.image(st1, cfg1))
    img4 = np.array(pathtracer.image(st4, cfg4))
    assert abs(img1.mean() - img4.mean()) < 0.12 * max(img1.mean(), 1e-6)


def test_checkpoint_resume(tmp_path):
    scene = cornell_box(cols=16, rows=12)
    cfg = RenderConfig(width=16, height=12, spp=1, bounces=1, seed=13)
    st = pathtracer.render_passes(scene, pathtracer.init_state(cfg), cfg, 3)
    path = str(tmp_path / "ckpt.npz")
    pathtracer.save_checkpoint(path, st)
    st2 = pathtracer.load_checkpoint(path)
    a = pathtracer.render_passes(scene, st, cfg, 2)
    b = pathtracer.render_passes(scene, st2, cfg, 2)
    np.testing.assert_allclose(np.array(a["acc"]), np.array(b["acc"]),
                               atol=1e-6)
    assert int(b["passes"]) == 5


def test_grid_image_equals_brute_image():
    scene = cornell_box(cols=24, rows=18)
    cfg_b = RenderConfig(width=24, height=18, spp=1, bounces=1, seed=2)
    cfg_g = RenderConfig(width=24, height=18, spp=1, bounces=1, seed=2,
                         use_grid=True, n_slabs=3)
    gscene = prepare_grids(scene, 3)
    ib = np.array(pathtracer.image(
        pathtracer.render_passes(scene, pathtracer.init_state(cfg_b), cfg_b, 2),
        cfg_b))
    ig = np.array(pathtracer.image(
        pathtracer.render_passes(gscene, pathtracer.init_state(cfg_g), cfg_g, 2),
        cfg_g))
    np.testing.assert_allclose(ib, ig, atol=1e-4)


def test_emitter_visible():
    # pixels looking at the ceiling light should read the emitter directly
    scene = cornell_box(cols=32, rows=24)
    cfg = RenderConfig(width=32, height=24, spp=1, bounces=0, seed=1)
    st = pathtracer.render_passes(scene, pathtracer.init_state(cfg), cfg, 4)
    img = np.array(pathtracer.image(st, cfg))
    top_center = img[:6, 12:20]
    rest = img[12:]
    assert top_center.max() > rest.mean()


def test_fake_shade_orbit_frames():
    """Orbit animation (Assign02 rotate analog) as one jitted scan: frames
    are finite, correctly shaped, and actually differ (the camera moves)."""
    import jax.numpy as jnp
    import numpy as np

    from raytracing_tpu.core.types import Camera, make_spheres
    from raytracing_tpu.render.simple import render_fake_shade_orbit

    spheres = make_spheres([[0.0, 0.0, 0.0], [0.7, 0.2, 0.0]], [0.5, 0.2])
    colors = jnp.ones((2, 4))
    cam = Camera.look_at([0, 0, 2], [0, 0, 0], [0, 1, 0], 60.0, 32, 24)
    frames = np.asarray(render_fake_shade_orbit(
        cam, spheres, colors, spheres.bounds(), n_frames=4))
    assert frames.shape == (4, 24, 32, 3)
    assert np.isfinite(frames).all()
    assert np.abs(frames[0] - frames[2]).max() > 1e-3
