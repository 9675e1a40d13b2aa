"""Multi-device sharding on the virtual 8-CPU mesh (SURVEY §4 item 5)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracing_tpu import RenderConfig
from raytracing_tpu.models.scenes import cornell_box
from raytracing_tpu.parallel import mesh as pm
from raytracing_tpu.render import pathtracer

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


def _setup(n_dev=8):
    cfg = RenderConfig(width=8 * n_dev, height=8, spp=1, bounces=1, seed=4)
    scene = cornell_box(cols=cfg.width, rows=cfg.height)
    return cfg, scene


def test_sharded_render_matches_single_device():
    cfg, scene = _setup()
    # single device
    ref_state = pathtracer.render_passes(scene, pathtracer.init_state(cfg),
                                         cfg, 2)
    # sharded over 8 devices
    m = pm.make_mesh(8)
    sscene = pm.replicate_scene(scene, m)
    sstate = pm.shard_state(pathtracer.init_state(cfg), m)
    render = pm.sharded_render_passes(m, cfg, 2)
    out = render(sscene, sstate)
    np.testing.assert_allclose(np.array(out["acc"]),
                               np.array(ref_state["acc"]), atol=1e-5)
    # accumulator is actually sharded over the rays axis
    sh = out["acc"].sharding
    assert len(sh.device_set) == 8


def test_train_step_grads_match_single_device():
    cfg, scene = _setup()
    m = pm.make_mesh(8)
    sscene = pm.replicate_scene(scene, m)
    params = {"center": sscene.spheres.center,
              "radius": sscene.spheres.radius,
              "materials": sscene.materials}
    target = jnp.zeros((cfg.height, cfg.width, 3))

    step = pm.make_train_step(m, cfg)
    state = pm.shard_state(pathtracer.init_state(cfg), m)
    (loss8, _), grads8 = step(params, sscene, state, target)

    m1 = pm.make_mesh(1)
    step1 = pm.make_train_step(m1, cfg)
    state1 = pm.shard_state(pathtracer.init_state(cfg), m1)
    (loss1, _), grads1 = step1(params, scene, state1, target)

    np.testing.assert_allclose(float(loss8), float(loss1), rtol=1e-5)
    for k in grads8:
        np.testing.assert_allclose(np.array(grads8[k]), np.array(grads1[k]),
                                   atol=1e-5, err_msg=k)
    assert np.isfinite(np.array(grads8["center"])).all()


def test_train_step_custom_loss_and_params():
    """Generalized make_train_step API: user loss fn + arbitrary parameter
    pytree via apply_params (here: light irradiance + L1 loss)."""
    import dataclasses

    cfg, scene = _setup(n_dev=1)
    m = pm.make_mesh(1)

    def apply_params(sc, params):
        lights = dataclasses.replace(sc.lights,
                                     irradiance=params["irradiance"])
        return dataclasses.replace(sc, lights=lights)

    step = pm.make_train_step(
        m, cfg, loss_fn=lambda img, t: jnp.mean(jnp.abs(img - t)),
        apply_params=apply_params)
    params = {"irradiance": scene.lights.irradiance}
    target = jnp.zeros((cfg.height, cfg.width, 3))
    state = pm.shard_state(pathtracer.init_state(cfg), m)
    (loss, _), grads = step(params, scene, state, target)
    g = np.array(grads["irradiance"])
    assert np.isfinite(float(loss)) and np.isfinite(g).all()
    assert np.abs(g).sum() > 0


def test_mesh_shapes():
    m = pm.make_mesh(8)
    assert m.devices.size == 8 and m.axis_names == ("rays",)
    m2 = pm.make_mesh(8, obj_parallel=2)
    assert m2.devices.shape == (4, 2) and m2.axis_names == ("rays", "obj")


def test_objsharded_closest_hit_matches():
    import jax.numpy as jnp
    from raytracing_tpu.core.types import Rays, make_spheres
    from raytracing_tpu.ops.closest_hit import closest_hit_spheres
    from raytracing_tpu.parallel.obj_parallel import \
        closest_hit_spheres_objsharded

    rng = np.random.default_rng(1)
    R, S = 256, 32
    o = rng.normal(size=(R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = Rays(o=jnp.array(o), d=jnp.array(d.astype(np.float32)),
                mint=jnp.zeros(R), maxt=jnp.full(R, jnp.inf))
    sp = make_spheres((rng.normal(size=(S, 3)) * 2).astype(np.float32),
                      rng.uniform(0.2, 0.8, S).astype(np.float32))
    mesh = pm.make_mesh(8, obj_parallel=4)
    ref = closest_hit_spheres(rays, sp)
    got = closest_hit_spheres_objsharded(rays, sp, mesh, axis="obj")
    assert (np.array(got.valid) == np.array(ref.valid)).all()
    ok = np.array(ref.valid)
    assert (np.array(got.idx)[ok] == np.array(ref.idx)[ok]).all()
    np.testing.assert_allclose(np.array(got.t)[ok], np.array(ref.t)[ok],
                               atol=1e-6)
