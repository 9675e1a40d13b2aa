"""The fused per-ray kernel (ops/pallas/fused_pass.py): parity with the XLA
stage pipeline under identical draws (Pallas interpreter on the CPU), its
hash draws, its wrapper's shapes and padding, and its lowering for CUDA.
The compiled kernel itself runs on the card (``gpu`` marker and
chip_smoke.py)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracing_tpu import RenderConfig
from raytracing_tpu.models.scenes import cornell_box
from raytracing_tpu.ops.pallas import fused_pass as F
from raytracing_tpu.render import pathtracer
from raytracing_tpu.render.direct import render_direct_xla

W, H = 16, 12


def _path_case(spp, rr, bounces, two_sided=False, seed=1234):
    cfg = RenderConfig(width=W, height=H, spp=spp, bounces=bounces,
                       russian_roulette=rr, rr_start_depth=1,
                       two_sided_triangles=two_sided, seed=seed)
    scene = cornell_box(cols=W, rows=H,
                        lens_diameter=0.2 if spp > 1 else 0.0)
    return cfg, scene


@pytest.mark.parametrize("spp,rr,bounces,two_sided", [
    (1, False, 2, False), (4, False, 1, False), (1, True, 4, False),
    (1, False, 1, True)])
def test_path_matches_xla_same_draws(spp, rr, bounces, two_sided):
    cfg, scene = _path_case(spp, rr, bounces, two_sided)
    st = pathtracer.init_state(cfg)
    st = {**st, "acc": jnp.full_like(st["acc"], 0.5),
          "passes": jnp.int32(3)}             # accumulates onto acc
    u = F.u_planes_for_pass(st["key"], st["passes"], cfg,
                            scene.lights.count)
    got = F.render_passes(scene, st, cfg, 1, u_planes=u, interpret=True)
    ref = pathtracer._render_pass(scene, st, cfg)
    assert int(got["passes"]) == 4
    a, b = np.asarray(got["acc"]), np.asarray(ref["acc"])
    assert a.shape == (cfg.total_rays, 3)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    assert (a > 0.5).mean() > 0.3                # light arrived


@pytest.mark.parametrize("spp", [1, 4])
def test_direct_matches_xla_same_draws(spp):
    cfg = RenderConfig(width=W, height=H, spp=spp, bounces=0)
    scene = cornell_box(cols=W, rows=H,
                        lens_diameter=0.2 if spp > 1 else 0.0)
    key = jax.random.PRNGKey(5)
    u = F.u_planes_for_direct(key, cfg, scene.lights.count)
    got = np.asarray(F.render_direct(scene, cfg, key, 1, u_planes=u,
                                     interpret=True))
    ref = np.asarray(render_direct_xla(scene, cfg, key, 1))
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_hash_draws_multipass_and_sharding_offset():
    """Hash mode: K passes in one launch equal K one-pass launches; a ray
    slice rendered with its global offset equals that slice of the full
    render (the shard_map contract); the estimate agrees with the XLA
    pipeline's in the mean."""
    cfg, scene = _path_case(1, False, 2)
    st = pathtracer.init_state(cfg)
    four = F.render_passes(scene, st, cfg, 4, interpret=True)
    one = st
    for _ in range(4):
        one = F.render_passes(scene, one, cfg, 1, interpret=True)
    np.testing.assert_allclose(np.asarray(four["acc"]),
                               np.asarray(one["acc"]), rtol=1e-6, atol=1e-6)
    half = cfg.total_rays // 2
    part = F.render_passes(scene, {**st, "acc": st["acc"][half:]}, cfg, 4,
                           ray_offset=half, interpret=True)
    np.testing.assert_array_equal(np.asarray(part["acc"]),
                                  np.asarray(four["acc"])[half:])
    xla = pathtracer.render_passes_xla(scene, st, cfg, 4)
    m_f = float(np.asarray(four["acc"]).mean())
    m_x = float(np.asarray(xla["acc"]).mean())
    assert abs(m_f - m_x) < 0.1 * m_x


def test_hash_uniforms_are_uniform_and_decorrelated():
    ids = jnp.arange(1 << 16, dtype=jnp.uint32)
    base = F._mix(F._mix(F._mix(jnp.uint32(7)) ^ jnp.uint32(9)) ^ ids)
    u0 = np.asarray(F._uniform(F._mix(base ^ jnp.uint32(F._mix_py(1)))))
    u1 = np.asarray(F._uniform(F._mix(base ^ jnp.uint32(F._mix_py(2)))))
    assert u0.min() >= 0.0 and u0.max() < 1.0
    hist = np.histogram(u0, bins=16, range=(0, 1))[0]
    assert np.abs(hist / hist.mean() - 1).max() < 0.05
    assert abs(np.corrcoef(u0, u1)[0, 1]) < 0.02
    assert abs(np.corrcoef(u0[1:], u0[:-1])[0, 1]) < 0.02
    # the host-side constant mixer is the device mixer
    x = np.array([0, 1, 12345, 0xFFFFFFFF], np.uint32)
    np.testing.assert_array_equal(np.asarray(F._mix(jnp.asarray(x))),
                                  [F._mix_py(int(v)) for v in x])


@pytest.mark.parametrize("n_rays", [1, 127, 129, 300])
def test_wrapper_pads_rays_to_blocks(n_rays):
    """Ray counts that are not a multiple of BLOCK are padded and sliced;
    the tables pad to powers of two."""
    cfg = RenderConfig(width=n_rays, height=1, spp=1, bounces=1)
    scene = cornell_box(cols=n_rays, rows=1)
    st = pathtracer.init_state(cfg)
    u = F.u_planes_for_pass(st["key"], st["passes"], cfg,
                            scene.lights.count)
    got = F.render_passes(scene, st, cfg, 1, u_planes=u, interpret=True)
    ref = pathtracer._render_pass(scene, st, cfg)
    assert got["acc"].shape == (n_rays, 3)
    np.testing.assert_allclose(np.asarray(got["acc"]),
                               np.asarray(ref["acc"]), rtol=1e-4, atol=1e-4)
    for t in F.scene_tables(scene, cfg):
        n = t.shape[0]
        assert t.ndim == 1 and n & (n - 1) == 0


@pytest.mark.parametrize("mode", ["path", "direct", "path_rr_parity"])
def test_lowers_to_triton_for_cuda(mode):
    """The kernel lowers through Pallas' Triton route for a CUDA target
    (the step before the card's own compiler), at the full 1024^2 size."""
    S = 1024
    scene = cornell_box(cols=S, rows=S)
    if mode == "direct":
        cfg = RenderConfig(width=S, height=S, spp=4, bounces=0)
        fn = jax.jit(lambda s: F.render_direct(s, cfg, None, 16))
        args = (scene,)
    elif mode == "path":
        cfg = RenderConfig(width=S, height=S, spp=1, bounces=5)
        st = pathtracer.init_state(cfg)
        fn = jax.jit(lambda s, st: F.render_passes(s, st, cfg, 16))
        args = (scene, st)
    else:
        cfg = RenderConfig(width=S, height=S, spp=1, bounces=5,
                           russian_roulette=True)
        st = pathtracer.init_state(cfg)
        u = jax.ShapeDtypeStruct(
            (2 * pathtracer.pass_draw_count(cfg, 1), cfg.total_rays),
            jnp.float32)
        fn = jax.jit(lambda s, st, u: F.render_passes(s, st, cfg, 1,
                                                      u_planes=u))
        args = (scene, st, u)
    text = fn.trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    assert "triton" in text and f"fused_{mode.split('_')[0]}_pass" in text


def test_routed_entry_points_take_xla_on_cpu():
    """On the CPU the routed entry points run the XLA pipeline (the fused
    kernel is GPU only; interpret mode is for tests)."""
    cfg, scene = _path_case(1, False, 1)
    st = pathtracer.init_state(cfg)
    a = pathtracer.render_passes(scene, st, cfg, 2)
    b = pathtracer.render_passes_xla(scene, st, cfg, 2)
    np.testing.assert_array_equal(np.asarray(a["acc"]), np.asarray(b["acc"]))


@pytest.fixture
def fused_route(monkeypatch):
    """Routed entry points take the fused kernel (in the interpreter)."""
    from functools import partial

    from raytracing_tpu.render import route
    monkeypatch.setattr(route, "forward", lambda *a, **k: route.TRITON)
    monkeypatch.setattr(F, "render_passes",
                        partial(F.render_passes, interpret=True))
    monkeypatch.setattr(F, "render_direct",
                        partial(F.render_direct, interpret=True))


@pytest.mark.parametrize("entry", ["path", "direct"])
def test_grad_through_fused_route_is_xla_grad(fused_route, entry):
    """On the fused route the value is the kernel's and the derivative is
    that of the XLA pipeline: jax.grad through the routed entry equals
    jax.grad through the XLA entry, and value_and_grad returns the XLA
    value with it (one estimator)."""
    from raytracing_tpu.render.direct import render_direct, render_direct_xla
    # a seed of its own: the routed jits are not traced for it elsewhere
    if entry == "path":
        cfg = RenderConfig(width=W, height=H, spp=1, bounces=2, seed=4321)
        st = pathtracer.init_state(cfg)

        def routed(sc):
            return pathtracer.image(
                pathtracer.render_passes(sc, st, cfg, 2), cfg)

        def xla(sc):
            return pathtracer.image(
                pathtracer.render_passes_xla(sc, st, cfg, 2), cfg)
    else:
        cfg = RenderConfig(width=W, height=H, spp=1, bounces=0, seed=4321)
        routed = lambda sc: render_direct(sc, cfg, None, 2)      # noqa: E731
        xla = lambda sc: render_direct_xla(sc, cfg, None, 2)     # noqa: E731
    scene = cornell_box(cols=W, rows=H)

    def loss(render):
        def f(center, materials):
            sp = dataclasses.replace(scene.spheres, center=center)
            sc = dataclasses.replace(scene, spheres=sp, materials=materials)
            return jnp.mean(render(sc) ** 2)
        return jax.value_and_grad(f, argnums=(0, 1))

    args = (scene.spheres.center, scene.materials)
    (v_r, g_r), (v_x, g_x) = loss(routed)(*args), loss(xla)(*args)
    # equal up to the float order of two separate compilations
    np.testing.assert_allclose(float(v_r), float(v_x), rtol=1e-6)
    for a, b in zip(g_r, g_x):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-6)
    assert float(jnp.abs(g_r[1]).sum()) > 0
    # undifferentiated, the routed call is the kernel's own estimate
    plain = float(jnp.mean(routed(scene) ** 2))
    assert plain != float(v_x) and abs(plain - float(v_x)) < 0.2 * float(v_x)


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu(gpu):
    """The kernel as compiled for the card against the XLA pipeline on the
    same card, same draws."""
    cfg, scene = _path_case(1, True, 5)
    cfg = dataclasses.replace(cfg, width=256, height=256)
    scene = cornell_box(cols=256, rows=256)
    with jax.default_device(gpu):
        st = pathtracer.init_state(cfg)
        u = F.u_planes_for_pass(st["key"], st["passes"], cfg,
                                scene.lights.count)
        a = np.asarray(jax.jit(lambda s, st, u: F.render_passes(
            s, st, cfg, 1, u_planes=u)["acc"])(scene, st, u))
        b = np.asarray(pathtracer.render_passes_xla(scene, st, cfg,
                                                    1)["acc"])
    d = np.abs(a - b).max(-1)
    assert (d > 1e-3).mean() < 2e-2
    assert abs(a.mean() - b.mean()) < 5e-3 * b.mean()
