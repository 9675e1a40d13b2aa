"""Single-pass direct-lighting renderer — Assign08 analog.

Schedule (ref Assign08-Shadow_Tracing/code.js:1194-1231):
  initTrace -> closest hit -> for each light:
    initShadowTrace -> occlusion -> sceneRender
  copyToPixel with 1/n_lights divisor.

Assign08 shading (ref Assign08 code.cl:916-939): shade = 0.2 ambient
+ clamp(dot(shadow_dir, n)) when unoccluded; pixel += material * clamp(shade).
(No area/irradiance/r^2 terms — those arrive in Assign10.)
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core import rng
from ..core.config import RenderConfig
from ..core.sampling import sample_disk_point
from ..core.types import Hits, Rays, Scene, replace, safe_normalize
from ..ops.closest_hit import fetch_rows
from ..ops.pallas import fused_pass
from . import route, stages
from .camera import generate_primary_rays

Array = jax.Array
INF = jnp.inf


@partial(jax.jit, static_argnames=("cfg", "n_passes"))
def render_direct(scene: Scene, cfg: RenderConfig, key=None,
                  n_passes: int = 1) -> Array:
    """(H, W, 3) float image in [0,1].

    ``n_passes > 1`` accumulates that many independent direct-lighting
    estimates (fresh lens + light-disk samples per pass) inside ONE jitted
    program — the progressive-accumulation idea of the reference's
    continuosRender (Assign09/10 code.js) applied to the Assign08/09
    single-bounce pipelines: soft shadows and depth of field converge with
    passes, and there is no host dispatch between passes. The
    implementation is the one ``route.forward`` names; derivatives of
    every route are those of the XLA pipeline."""
    if key is None:
        key = rng.base_key(cfg.seed)
    if route.forward(scene, cfg) == route.TRITON:
        return _fused_direct(scene, key, cfg, n_passes)
    return _direct_xla(scene, cfg, key, n_passes)


@partial(jax.custom_jvp, nondiff_argnums=(2, 3))
def _fused_direct(scene: Scene, key, cfg: RenderConfig,
                  n_passes: int) -> Array:
    return fused_pass.render_direct(scene, cfg, key, n_passes)


@_fused_direct.defjvp
def _fused_direct_jvp(cfg, n_passes, primals, tangents):
    # forward-only kernel: differentiated, the call is the XLA pipeline
    return jax.jvp(lambda sc, k: _direct_xla(sc, cfg, k, n_passes),
                   primals, tangents)


def _direct_xla(scene: Scene, cfg: RenderConfig, key, n_passes: int) -> Array:
    if key is None:
        key = rng.base_key(cfg.seed)

    if n_passes == 1:
        acc = _direct_pass_acc(scene, cfg, key)
    else:
        def body(p, acc):
            return acc + _direct_pass_acc(scene, cfg, rng.pass_key(key, p))

        acc = jax.lax.fori_loop(0, n_passes, body,
                                jnp.zeros((cfg.total_rays, 3)))
    n_lights = max(scene.lights.count, 1)
    img = acc.reshape(cfg.height, cfg.width, cfg.spp, 3).mean(2) \
        / (n_lights * n_passes)
    return jnp.clip(img, 0.0, 1.0)


def _direct_pass_acc(scene: Scene, cfg: RenderConfig, key) -> Array:
    """One direct-lighting estimate: per-ray accumulated radiance (R, 3),
    BEFORE the 1/n_lights divisor and clip."""
    cam = replace(scene.camera, cols=cfg.width, rows=cfg.height)
    # scene.lens_radius == 0 -> pinhole (Assign08); > 0 -> thin-lens DoF with
    # stratified spp sampling (Assign09, ref initTrace code.cl:482-509)
    rays = generate_primary_rays(cam, scene.bounds, scene.focal_length,
                                 scene.lens_radius, cfg.spp,
                                 rng.draw_key(key, rng.LENS))
    hits = Hits.none(rays.n)
    rays, hits = stages.trace_all(rays, hits, scene, cfg)

    acc = jnp.zeros((rays.n, 3))
    t_ax, b_ax = scene.lights.frames()
    for li in range(scene.lights.count):
        pos = scene.lights.position[li]
        u = rng.uniform2(rng.draw_key(key, rng.LIGHT, 0, li), rays.n)
        target = sample_disk_point(pos[None, :], t_ax[li][None, :],
                                   b_ax[li][None, :],
                                   scene.lights.radius[li][None], u)
        origin = hits.p + cfg.shadow_eps * hits.n
        delta = target - origin
        d2 = jnp.sum(delta * delta, -1)
        dist = jnp.sqrt(jnp.where(d2 > 0.0, d2, 1.0))
        dist = jnp.where(d2 > 0.0, dist, 0.0)
        sdir = safe_normalize(delta)
        shadow = Rays(o=origin, d=sdir,
                      mint=jnp.where(hits.valid, 0.0, INF),
                      maxt=jnp.where(hits.valid, dist, INF))
        occ = stages.occluded_any(shadow, scene, cfg)

        shade = jnp.full((rays.n,), cfg.ambient)
        cosx = jnp.clip(jnp.sum(sdir * hits.n, -1), 0.0, 1.0)
        shade = shade + jnp.where(~occ, cosx, 0.0)
        albedo = fetch_rows(scene.materials[:, :3], hits.mat_id)
        contrib = albedo * jnp.clip(shade, 0.0, 1.0)[:, None]
        acc = acc + jnp.where(hits.valid[:, None], contrib, 0.0)

    return acc


render_direct_xla = jax.jit(_direct_xla, static_argnames=("cfg", "n_passes"))
