"""Progressive Monte Carlo path tracer — the Assign10 pipeline as one jitted
wavefront program.

Schedule reproduces executeRender (ref Assign10-Path_Tracing/code.js:1806-1854):

  initTrace -> closest-hit (spheres+triangles+meshes merged)
  for each light: lightRender          (emitter hits, primary segment ONLY —
                                        the reference never credits emitter
                                        hits inside the bounce loop)
  for each light: NEE (shadow sample -> occlusion -> sceneRender)
  repeat cfg.bounces times:
     bouncePaths -> closest-hit -> for each light: NEE

Progressive state (acc, key, passes) is the complete resumable checkpoint
(SURVEY §5: the reference's (acu, seeds, passes) triple).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core import rng
from ..core.config import RenderConfig
from ..core.types import Hits, Scene, replace
from ..ops.pallas import fused_pass
from . import route, stages
from .camera import generate_primary_rays

Array = jax.Array


def pass_draw_count(cfg: RenderConfig, n_lights: int) -> int:
    """Slots in the pass-wide (R, n_draws, 2) uniform tensor: lens, NEE per
    light, then per depth: [rr when enabled], bounce, NEE per light."""
    per_depth = (1 if cfg.russian_roulette else 0) + 1 + n_lights
    return 1 + n_lights + cfg.bounces * per_depth


def init_state(cfg: RenderConfig) -> dict:
    """Zeroed progressive state (ref initAcu code.cl:448-456 runs once)."""
    n = cfg.total_rays
    return {
        "acc": jnp.zeros((n, 3), jnp.float32),
        "key": rng.base_key(cfg.seed),
        "passes": jnp.int32(0),
    }


def _render_pass(scene: Scene, state: dict, cfg: RenderConfig) -> dict:
    """One progressive pass (= spp samples/pixel) through the XLA stage
    pipeline. Pure function of (scene, state); differentiable."""
    acc, passes = state["acc"], state["passes"]
    kp = rng.pass_key(state["key"], passes)
    cam = replace(scene.camera, cols=cfg.width, rows=cfg.height)
    n_lights = scene.lights.count
    R = cfg.total_rays

    # ONE batched threefry draw for the whole pass (lens + per-depth light
    # sampling + bounces + optional RR) instead of many small uniform()
    # calls. Slot order per depth: [rr?], bounce, nee*L.
    n_draws = pass_draw_count(cfg, n_lights)
    u_all = jax.random.uniform(kp, (R, n_draws, 2))
    draw = iter(range(n_draws))

    lens_u = u_all[:, next(draw)] if cfg.spp == 1 else None
    rays = generate_primary_rays(cam, scene.bounds, scene.focal_length,
                                 scene.lens_radius, cfg.spp,
                                 rng.draw_key(kp, rng.LENS),
                                 lens_uv=lens_u)
    if cfg.spp > 1:
        next(draw)  # keep slot numbering stable across spp settings
    hits = Hits.none(rays.n)
    rays, hits = stages.trace_all(rays, hits, scene, cfg)

    for li in range(n_lights):
        acc, rays, hits = stages.light_render(acc, rays, hits, scene.lights,
                                              li, cfg)
    for li in range(n_lights):
        acc, hits = stages.nee_shade(acc, hits, scene, li, kp, cfg,
                                     u=u_all[:, next(draw)])

    for depth in range(1, cfg.bounces + 1):
        if cfg.russian_roulette:
            hits = stages.apply_russian_roulette(
                hits, kp, depth - 1, cfg, u=u_all[:, next(draw), 0])
        rays = stages.bounce_paths(hits, kp, cfg, u=u_all[:, next(draw)])
        rays, hits = stages.trace_all(rays, hits, scene, cfg)
        for li in range(n_lights):
            acc, hits = stages.nee_shade(acc, hits, scene, li, kp, cfg,
                                         u=u_all[:, next(draw)])

    return {"acc": acc, "key": state["key"], "passes": passes + 1}


def _xla_passes(scene: Scene, state: dict, cfg: RenderConfig,
                n_passes: int) -> dict:
    def body(_, st):
        return _render_pass(scene, st, cfg)
    return jax.lax.fori_loop(0, n_passes, body, state)


render_passes_xla = jax.jit(_xla_passes, static_argnames=("cfg", "n_passes"))


@partial(jax.custom_jvp, nondiff_argnums=(2, 3))
def _fused_passes(scene: Scene, state: dict, cfg: RenderConfig,
                  n_passes: int) -> dict:
    return fused_pass.render_passes(scene, state, cfg, n_passes)


@_fused_passes.defjvp
def _fused_passes_jvp(cfg, n_passes, primals, tangents):
    # The kernel is forward only. Differentiated, the whole call is the XLA
    # pipeline, value included, so value and gradient are one estimator.
    return jax.jvp(lambda sc, st: _xla_passes(sc, st, cfg, n_passes),
                   primals, tangents)


@partial(jax.jit, static_argnames=("cfg", "n_passes"))
def render_passes(scene: Scene, state: dict, cfg: RenderConfig,
                  n_passes: int) -> dict:
    """Run several progressive passes inside one jit — no host round-trip
    between passes (the reference pays ~15-40 kernel dispatches + a pixel
    readback per pass; we pay zero). The implementation is the one
    ``route.forward`` names for this platform and scene; derivatives of
    every route are those of the XLA pipeline."""
    if route.forward(scene, cfg) == route.TRITON:
        return _fused_passes(scene, state, cfg, n_passes)
    return _xla_passes(scene, state, cfg, n_passes)


def image(state: dict, cfg: RenderConfig) -> Array:
    """Current tonemapped image (H, W, 3) float in [0,1]."""
    return stages.copy_to_pixel(state["acc"],
                                jnp.maximum(state["passes"], 1), cfg)


def render(scene: Scene, cfg: RenderConfig, n_passes: int = 1) -> Array:
    """Convenience: init -> n passes -> image."""
    state = init_state(cfg)
    state = render_passes(scene, state, cfg, n_passes)
    return image(state, cfg)


# ---------------------------------------------------------------------------
# Checkpoint / resume (SURVEY §5)
# ---------------------------------------------------------------------------

def save_checkpoint(path: str, state: dict) -> None:
    """Host-gathered npz checkpoint (single-host; the reference analog is
    the resident (acu, seeds, passes) triple)."""
    import numpy as np
    np.savez(path, acc=np.asarray(state["acc"]),
             key=np.asarray(jax.random.key_data(state["key"])),
             passes=np.asarray(state["passes"]))


def load_checkpoint(path: str) -> dict:
    import numpy as np
    z = np.load(path)
    return {"acc": jnp.asarray(z["acc"]),
            "key": jax.random.wrap_key_data(jnp.asarray(z["key"])),
            "passes": jnp.int32(z["passes"])}


def _orbax():
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise ImportError(
            "sharded checkpoints need the orbax-checkpoint package; "
            "save_checkpoint/load_checkpoint need nothing beyond numpy"
        ) from e
    return ocp


def save_checkpoint_sharded(path: str, state: dict) -> None:
    """Orbax checkpoint that preserves shardings (multi-host/multi-chip:
    each host writes its shards — no gather)."""
    ocp = _orbax()
    flat = dict(state)
    flat["key"] = jax.random.key_data(flat["key"])
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, flat, force=True)
    ckptr.wait_until_finished()


def load_checkpoint_sharded(path: str, template: dict | None = None) -> dict:
    ocp = _orbax()
    ckptr = ocp.StandardCheckpointer()
    if template is not None:
        flat = dict(template)
        flat["key"] = jax.random.key_data(flat["key"])
        restored = ckptr.restore(path, flat)
    else:
        restored = ckptr.restore(path)
    restored["key"] = jax.random.wrap_key_data(jnp.asarray(restored["key"]))
    restored["passes"] = jnp.int32(restored["passes"])
    return restored
