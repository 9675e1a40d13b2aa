"""Wavefront pipeline stages — the Assign10 kernel set as pure JAX stage fns.

Reference kernels (Assign10-Path_Tracing/code.cl):
  * initTrace          458-543 -> render.camera.generate_primary_rays
  * sphere/triangle/meshTrace 675-1070 -> trace_all (champion merge)
  * lightRender        600-629 -> light_render
  * initShadowTrace    631-673 -> (inside) nee_shade
  * *ShadowTrace       1073-1321 -> occluded (any-hit over all geometry)
  * sceneRender        1323-1364 -> nee_shade
  * bouncePaths        581-598 -> bounce_paths
  * copyToPixel        1366-1386 -> copy_to_pixel

Deliberate fixes over the reference (all configurable, SURVEY §7 quirks):
  * bounce-ray origins are offset by ``cfg.shadow_eps`` along the normal
    (the reference uses the raw hit point, code.cl:592 — surface acne);
  * a bounce ray that escapes the scene invalidates its hit record; the
    reference leaves the stale POI in place and re-shades the same point on
    every remaining bounce (code.cl sphereTrace writes POI only on hit).
    Set ``replicate_stale_poi=True`` on the config for bug-compat.
  * occlusion is an explicit boolean, not the mint==maxt ray encoding
    (quirk 10).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import rng
from ..core.config import RenderConfig
from ..core.sampling import cosine_hemisphere, sample_disk_point
from ..core.types import Hits, Lights, Rays, Scene, replace, safe_normalize
from ..ops import intersect as I
from ..ops.closest_hit import (
    anyhit_spheres, anyhit_triangles,
    closest_hit_spheres, closest_hit_triangles,
    fetch_rows, sphere_hit_attrs, triangle_hit_attrs,
)

Array = jax.Array
INF = jnp.inf


# ---------------------------------------------------------------------------
# Closest-hit composition across geometry types
# ---------------------------------------------------------------------------

def _all_triangles(scene: Scene):
    """Scene triangles + every mesh instance folded into ONE batch for the
    brute-force path. The reference traces meshes separately only because
    each carries its own grid (meshTrace per mesh, code.js:1293-1303); with
    no grid the split just multiplies program size. Mesh mat_ids are
    already baked per-triangle at load. XLA CSEs the concat across the
    pass's trace/occlusion sites."""
    from ..core.types import Triangles
    parts = [scene.triangles] + [m.tris for m in scene.meshes]
    parts = [p for p in parts if p.count]
    if not parts:
        return scene.triangles
    if len(parts) == 1:
        return parts[0]
    return Triangles(v=jnp.concatenate([p.v for p in parts]),
                     vn=jnp.concatenate([p.vn for p in parts]),
                     mat_id=jnp.concatenate([p.mat_id for p in parts]),
                     mask=jnp.concatenate([p.mask for p in parts]))


def trace_all(rays: Rays, hits: Hits, scene: Scene, cfg: RenderConfig
              ) -> tuple[Rays, Hits]:
    """Run every geometry pass against the shared ray buffer and merge
    champions through the persistent-maxt composition of the reference
    (SURVEY §3.2: passes compose via shrinking ray.maxt + POI buffer).

    Returns (rays with maxt shrunk to champion t, merged hits).
    ``hits`` carries the incoming throughput and — when
    cfg.replicate_stale_poi — the previous bounce's POI for miss lanes."""
    if cfg.use_grid:
        from ..accel.traverse import grid_closest_spheres, grid_closest_triangles
    best_t = jnp.full((rays.n,), INF)
    best_p = jnp.zeros((rays.n, 3))
    best_n = jnp.zeros((rays.n, 3))
    best_mat = jnp.full((rays.n,), -1, jnp.int32)

    def merge(ch, p, n, mat, best):
        bt, bp, bn, bm = best
        better = ch.valid & (ch.t < bt)
        return (jnp.where(better, ch.t, bt),
                jnp.where(better[:, None], p, bp),
                jnp.where(better[:, None], n, bn),
                jnp.where(better, mat, bm))

    best = (best_t, best_p, best_n, best_mat)

    if scene.spheres.count:
        if cfg.use_grid and scene.sphere_grid is not None:
            ch = grid_closest_spheres(rays, scene.spheres, scene.sphere_grid)
        else:
            ch = closest_hit_spheres(rays, scene.spheres,
                                     obj_chunk=cfg.obj_chunk)
        p, n, mat = sphere_hit_attrs(rays, scene.spheres, ch)
        best = merge(ch, p, n, mat, best)

    if cfg.use_grid:
        # grid path keeps per-batch grids (scene grid + per-mesh nslabs)
        if scene.triangles.count:
            if scene.triangle_grid is not None:
                ch = grid_closest_triangles(rays, scene.triangles,
                                            scene.triangle_grid,
                                            two_sided=cfg.two_sided_triangles)
            else:
                ch = closest_hit_triangles(rays, scene.triangles,
                                           obj_chunk=cfg.obj_chunk,
                                           two_sided=cfg.two_sided_triangles)
            p, n, mat = triangle_hit_attrs(rays, scene.triangles, ch)
            best = merge(ch, p, n, mat, best)
        for mesh in scene.meshes:
            if mesh.grid is not None:
                ch = grid_closest_triangles(rays, mesh.tris, mesh.grid,
                                            two_sided=cfg.two_sided_triangles)
            else:
                ch = closest_hit_triangles(rays, mesh.tris,
                                           obj_chunk=cfg.obj_chunk,
                                           two_sided=cfg.two_sided_triangles)
            p, n, mat = triangle_hit_attrs(rays, mesh.tris, ch)
            best = merge(ch, p, n, mat, best)
    else:
        tris = _all_triangles(scene)
        if tris.count:
            ch = closest_hit_triangles(rays, tris,
                                       obj_chunk=cfg.obj_chunk,
                                       two_sided=cfg.two_sided_triangles)
            p, n, mat = triangle_hit_attrs(rays, tris, ch)
            best = merge(ch, p, n, mat, best)

    bt, bp, bn, bm = best
    found = bm >= 0
    new_rays = replace(rays, maxt=jnp.where(found, bt, rays.maxt))

    if cfg.replicate_stale_poi:
        # reference bug-compat: keep previous POI where this segment missed
        p = jnp.where(found[:, None], bp, hits.p)
        n = jnp.where(found[:, None], bn, hits.n)
        mat = jnp.where(found, bm, hits.mat_id)
        t = jnp.where(found, bt, hits.t)
    else:
        p, n, mat, t = bp, bn, bm, bt
    return new_rays, Hits(p=p, n=n, throughput=hits.throughput,
                          mat_id=mat, t=t)


def occluded_any(rays: Rays, scene: Scene, cfg: RenderConfig) -> Array:
    """Any-hit over every geometry type (the per-type *ShadowTrace kernels,
    ref code.cl:1073-1321, plus per-mesh reuse code.js:1522-1528)."""
    if cfg.use_grid:
        from ..accel.traverse import grid_closest_spheres, grid_closest_triangles
    occ = jnp.zeros((rays.n,), bool)
    if scene.spheres.count:
        if cfg.use_grid and scene.sphere_grid is not None:
            occ |= grid_closest_spheres(rays, scene.spheres,
                                        scene.sphere_grid).valid
        else:
            occ |= anyhit_spheres(rays, scene.spheres,
                                  obj_chunk=cfg.obj_chunk)
    if cfg.use_grid:
        if scene.triangles.count:
            if scene.triangle_grid is not None:
                occ |= grid_closest_triangles(
                    rays, scene.triangles, scene.triangle_grid,
                    two_sided=cfg.two_sided_triangles).valid
            else:
                occ |= anyhit_triangles(rays, scene.triangles,
                                        obj_chunk=cfg.obj_chunk,
                                        two_sided=cfg.two_sided_triangles)
        for mesh in scene.meshes:
            if mesh.grid is not None:
                occ |= grid_closest_triangles(
                    rays, mesh.tris, mesh.grid,
                    two_sided=cfg.two_sided_triangles).valid
            else:
                occ |= anyhit_triangles(rays, mesh.tris,
                                        obj_chunk=cfg.obj_chunk,
                                        two_sided=cfg.two_sided_triangles)
    else:
        tris = _all_triangles(scene)
        if tris.count:
            occ |= anyhit_triangles(rays, tris,
                                    obj_chunk=cfg.obj_chunk,
                                    two_sided=cfg.two_sided_triangles)
    return occ


# ---------------------------------------------------------------------------
# Emitter hits
# ---------------------------------------------------------------------------

def light_render(acc: Array, rays: Rays, hits: Hits, lights: Lights,
                 light_idx: int, cfg: RenderConfig
                 ) -> tuple[Array, Rays, Hits]:
    """Credit paths that see light ``light_idx`` directly and terminate them
    (ref lightRender code.cl:600-629): hit if the disk is closer than the
    geometry champion (t < maxt, strict); adds the (normalized!) irradiance —
    the normalize is a reference quirk kept behind cfg.normalize_emitter."""
    pos = lights.position[light_idx]
    nrm = lights.normal[light_idx]
    irr = lights.irradiance[light_idx]
    if cfg.normalize_emitter:
        irr = irr / jnp.maximum(jnp.linalg.norm(irr), 1e-20)
    t = I.light_disk_t(rays.o, rays.d, pos, nrm, lights.radius[light_idx])
    # deliberate fix: the reference accepts t < 0 here (lightRender checks
    # only t >= maxt, code.cl:622) — a light's mirror image through the eye
    # would ghost-credit backward-extended rays. Require t inside the ray
    # window.
    hit = rays.alive & jnp.isfinite(t) & (t >= rays.mint) & (t < rays.maxt)

    acc = acc + jnp.where(hit[:, None], irr[None, :], 0.0)
    dead = jnp.full((rays.n,), INF)
    rays = replace(rays,
                   mint=jnp.where(hit, dead, rays.mint),
                   maxt=jnp.where(hit, dead, rays.maxt))
    hits = replace(hits, mat_id=jnp.where(hit, -1, hits.mat_id))
    return acc, rays, hits


# ---------------------------------------------------------------------------
# Next-event estimation (shadow + shade)
# ---------------------------------------------------------------------------

def nee_shade(acc: Array, hits: Hits, scene: Scene, light_idx: int,
              key: Array, cfg: RenderConfig,
              u: Array | None = None) -> tuple[Array, Hits]:
    """One light's direct-lighting estimate for every valid hit:
      initShadowTrace (code.cl:631-673) -> any-hit occlusion ->
      sceneRender (code.cl:1323-1364).

    Matches the reference's quirks deliberately:
      * geometric term uses distance to the light CENTER, while the shadow
        direction points at the SAMPLED disk point (code.cl:1351-1356);
      * contribution uses the pre-update throughput, then throughput *= albedo
        — per light, i.e. L lights multiply albedo in L times per bounce
        (executeSceneRender is inside the light loop, code.js:1820-1846).
    """
    lights = scene.lights
    pos = lights.position[light_idx]
    nrm = lights.normal[light_idx]
    irr = lights.irradiance[light_idx]
    area = lights.area[light_idx]
    t_ax, b_ax = lights.frames()
    t_ax, b_ax = t_ax[light_idx], b_ax[light_idx]

    valid = hits.valid
    n_rays = hits.p.shape[0]

    # sample a point on the light disk (concentric map in the light frame).
    # ``u`` (R, 2) is normally sliced from the pass-wide random tensor
    # (pathtracer.pass_draw_count); key is the fallback.
    if u is None:
        u = rng.uniform2(key, n_rays)
    target = sample_disk_point(pos[None, :], t_ax[None, :], b_ax[None, :],
                               lights.radius[light_idx][None], u)

    origin = hits.p + cfg.shadow_eps * hits.n
    delta = target - origin
    d2 = jnp.sum(delta * delta, -1)
    dist = jnp.sqrt(jnp.where(d2 > 0.0, d2, 1.0))
    dist = jnp.where(d2 > 0.0, dist, 0.0)
    sdir = safe_normalize(delta)
    # invalid lanes get dead rays (ref code.cl:644-648)
    shadow = Rays(o=origin, d=sdir,
                  mint=jnp.where(valid, 0.0, INF),
                  maxt=jnp.where(valid, dist, INF))
    occ = occluded_any(shadow, scene, cfg)

    # sceneRender shading
    r2 = jnp.sum((hits.p - pos[None, :]) ** 2, -1)   # center distance (quirk)
    cosx = jnp.clip(jnp.sum(sdir * hits.n, -1), 0.0, 1.0)
    cosy = jnp.clip(jnp.sum(-sdir * nrm[None, :], -1), 0.0, 1.0)
    geom = area * cosx * cosy / jnp.maximum(r2, 1e-20)
    free = valid & ~occ
    shade = jnp.where(free[:, None], geom[:, None] * irr[None, :], 0.0)

    albedo = fetch_rows(scene.materials[:, :3], hits.mat_id)
    contrib = jnp.where(valid[:, None],
                        hits.throughput * albedo * shade, 0.0)
    acc = acc + contrib
    new_tp = jnp.where(valid[:, None], hits.throughput * albedo,
                       hits.throughput)
    return acc, replace(hits, throughput=new_tp)


# ---------------------------------------------------------------------------
# Path continuation
# ---------------------------------------------------------------------------

def bounce_paths(hits: Hits, key: Array, cfg: RenderConfig,
                 u: Array | None = None) -> Rays:
    """Cosine-hemisphere continuation rays from valid hits; dead rays
    elsewhere (ref bouncePaths code.cl:581-598). Origins are epsilon-offset
    (deliberate fix; set shadow_eps=0 for raw reference behavior)."""
    n = hits.p.shape[0]
    valid = hits.valid
    if u is None:
        u = rng.uniform2(key, n)
    safe_n = jnp.where(valid[:, None], hits.n, jnp.array([0.0, 0.0, 1.0]))
    d = cosine_hemisphere(safe_n, u)
    o = hits.p + cfg.shadow_eps * hits.n
    return Rays(o=o, d=d,
                mint=jnp.where(valid, 0.0, INF),
                maxt=jnp.where(valid, INF, INF))


def apply_russian_roulette(hits: Hits, key: Array, depth: int,
                           cfg: RenderConfig,
                           u: Array | None = None) -> Hits:
    """Optional RR termination (extension; BASELINE.json config 5): survive
    with p = max component of throughput, compensate by 1/p. ``u`` (R,) is
    normally a column of the pass-wide draw tensor (slot layout in
    pathtracer.pass_draw_count); key is the fallback."""
    if not cfg.russian_roulette or depth < cfg.rr_start_depth:
        return hits
    tp = hits.throughput
    p_survive = jnp.clip(jnp.maximum(tp[..., 0],
                                     jnp.maximum(tp[..., 1], tp[..., 2])),
                         0.05, 1.0)
    if u is None:
        u = jax.random.uniform(key, (hits.p.shape[0],))
    survive = u < p_survive
    tp = jnp.where(survive[:, None],
                   hits.throughput / p_survive[:, None], 0.0)
    mat = jnp.where(survive, hits.mat_id, -1)
    return replace(hits, throughput=tp, mat_id=mat)


# ---------------------------------------------------------------------------
# Accumulator -> image
# ---------------------------------------------------------------------------

def copy_to_pixel(acc: Array, passes: Array, cfg: RenderConfig) -> Array:
    """Mean over spp sub-rays and passes, x exposure, clamp to [0,1]
    (ref copyToPixel code.cl:1366-1386; divisor 1/(spp*passes)
    code.js:1410-1415). Returns float image (H, W, 3)."""
    img = acc.reshape(cfg.height, cfg.width, cfg.spp, 3).sum(2)
    img = img * (cfg.exposure / (cfg.spp * passes))
    return jnp.clip(img, 0.0, 1.0)
