"""Closest-hit and any-hit drivers over whole object batches.

The reference walks objects with per-work-item champion loops
(ref sphereTrace Assign10-Path_Tracing/code.cl:745-786; molTrace
Assign02 code.cl:205-215). Here the champion search is a chunked
``lax.scan`` over the object axis with an all-pairs **(O, R)** tile per
step: dense and branch-free, so XLA fuses each step's intersection math
into its min/argmin reduction. Any-hit skips argmin and attributes
entirely (dense OR-reduce). Champion attributes are fetched with row
gathers (``fetch_rows``): exact, and their VJP is a scatter-add.

Differentiability: the champion *search* runs under stop_gradient, then the
hit distance / normals are recomputed differentiably for the (R,)-sized
champions from the gathered object parameters. Gradients are exact
wherever the champion assignment is locally constant (a.e.).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.types import Rays, Spheres, Triangles
from . import intersect as I

Array = jax.Array
INF = jnp.inf


class Champion(NamedTuple):
    t: Array      # (R,) differentiable hit distance; INF = miss
    idx: Array    # (R,) int32 object index; -1 = miss
    valid: Array  # (R,) bool


def _pad_axis0(x: Array, to: int, fill=0):
    n = x.shape[0]
    if n == to:
        return x
    pad = jnp.full((to - n,) + x.shape[1:], fill, x.dtype)
    return jnp.concatenate([x, pad], axis=0)


def _chunk(x: Array, n_chunks: int, C: int, fill=0):
    return _pad_axis0(x, n_chunks * C, fill).reshape((n_chunks, C) + x.shape[1:])


def _champion_scan(ts_of_chunk, chunk_data, R: int):
    """Champion over chunked (C, R) t-matrices -> (best_t, best_idx)."""
    def body(carry, data):
        best_t, best_i, offset = carry
        ts = ts_of_chunk(data)                       # (C, R)
        cmin = ts.min(0)
        carg = jnp.argmin(ts, 0).astype(jnp.int32) + offset
        better = cmin < best_t
        best_t = jnp.where(better, cmin, best_t)
        best_i = jnp.where(better, carg, best_i)
        return (best_t, best_i, offset + ts.shape[0]), None

    init = (jnp.full((R,), INF), jnp.full((R,), -1, jnp.int32), jnp.int32(0))
    (best_t, best_i, _), _ = jax.lax.scan(body, init, chunk_data)
    return best_t, best_i


def _anyhit_scan(hit_of_chunk, chunk_data, R: int):
    def body(occ, data):
        return occ | hit_of_chunk(data), None
    occ, _ = jax.lax.scan(body, jnp.zeros((R,), bool), chunk_data)
    return occ


def fetch_rows(data: Array, idx: Array) -> Array:
    """Rows of ``data`` (O, k) at per-ray indices ``idx`` (R,) -> (R, k).
    ``idx`` < 0 or >= O yields zeros. A gather: exact in every dtype, and
    its VJP is a scatter-add."""
    ok = (idx >= 0) & (idx < data.shape[0])
    rows = jnp.take(data, jnp.where(ok, idx, 0), axis=0, mode="clip")
    return jnp.where(ok[:, None], rows, jnp.zeros((), data.dtype))


# ---------------------------------------------------------------------------
# Spheres
# ---------------------------------------------------------------------------

def closest_hit_spheres(rays: Rays, spheres: Spheres, *,
                        obj_chunk: int = 2048,
                        formulation: str = "matmul") -> Champion:
    """Closest valid sphere hit per ray (ref sphereTrace champion loop,
    code.cl:761-772, without the grid — the grid path lives in accel/)."""
    S = spheres.count
    R = rays.n
    if S == 0:
        return Champion(t=jnp.full((R,), INF),
                        idx=jnp.full((R,), -1, jnp.int32),
                        valid=jnp.zeros((R,), bool))
    C = min(obj_chunk, S)
    n_chunks = -(-S // C)

    def search(o, d, mint, maxt, center, radius, mask):
        cen = _chunk(center, n_chunks, C)
        rad = _chunk(radius, n_chunks, C)
        msk = _chunk(mask, n_chunks, C, False)

        if formulation == "matmul":
            def chunk_ts(data):
                c, r, m = data
                return I.sphere_ts_matmul(o, d, mint, maxt, c, r, m)
        else:
            def chunk_ts(data):
                c, r, m = data
                return I.sphere_ts_pairwise(o, d, mint, maxt, c, r, m).T

        return _champion_scan(chunk_ts, (cen, rad, msk), R)

    best_t, best_i = jax.lax.stop_gradient(
        search(rays.o, rays.d, rays.mint, rays.maxt,
               spheres.center, spheres.radius, spheres.mask))
    valid = jnp.isfinite(best_t) & rays.alive

    # differentiable recompute for champions — single-object quadratic,
    # (R,)-sized.  NaN-safety: non-champion lanes can produce dis<=0 / inf;
    # sanitize inputs before sqrt/where (double-where pattern).
    cr = fetch_rows(jnp.concatenate([spheres.center,
                                     spheres.radius[:, None]], -1),
                    jnp.where(valid, best_i, -1))
    c, r = cr[:, :3], cr[:, 3]
    omc = rays.o - c
    a = jnp.sum(rays.d * rays.d, -1)
    b = 2.0 * jnp.sum(omc * rays.d, -1)
    cq = jnp.sum(omc * omc, -1) - r * r
    dis = b * b - 4.0 * a * cq
    dis = jnp.where(valid & (dis > 0.0), dis, 1.0)
    sq = jnp.sqrt(dis)
    inv2a = 0.5 / a
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    finite_best = jnp.where(valid, best_t, 0.0)
    tt = jnp.where(jnp.abs(t0 - finite_best) <= jnp.abs(t1 - finite_best),
                   t0, t1)
    t = jnp.where(valid, tt, INF)
    return Champion(t=t, idx=jnp.where(valid, best_i, -1), valid=valid)


def sphere_hit_attrs(rays: Rays, spheres: Spheres, champ: Champion
                     ) -> tuple[Array, Array, Array]:
    """(p, normal, mat_id) at champion hits (ref code.cl:788-797).

    Invalid lanes get t substituted with 0 before evaluating o + t*d so that
    no inf/NaN enters the graph (their outputs are masked by mat_id = -1)."""
    t_safe = jnp.where(champ.valid, champ.t, 0.0)
    p = rays.at(t_safe)
    center = fetch_rows(spheres.center, champ.idx)
    mat = jnp.where(champ.valid,
                    fetch_rows(spheres.mat_id[:, None], champ.idx)[:, 0], -1)
    n = I.sphere_normal(jnp.where(champ.valid[:, None], p, p + 1.0), center)
    return p, n, mat


def anyhit_spheres(rays: Rays, spheres: Spheres, *, obj_chunk: int = 2048,
                   formulation: str = "matmul") -> Array:
    """Occlusion: any valid hit in the ray window (ref sphereShadowTrace,
    code.cl:1073-1193 — dense OR-reduce, no champion bookkeeping)."""
    S = spheres.count
    R = rays.n
    if S == 0:
        return jnp.zeros((R,), bool)
    C = min(obj_chunk, S)
    n_chunks = -(-S // C)
    cen = _chunk(spheres.center, n_chunks, C)
    rad = _chunk(spheres.radius, n_chunks, C)
    msk = _chunk(spheres.mask, n_chunks, C, False)

    def chunk_hit(data):
        c, r, m = data
        ts = I.sphere_ts_matmul(rays.o, rays.d, rays.mint, rays.maxt, c, r, m)
        return jnp.isfinite(ts).any(0)

    occ = _anyhit_scan(chunk_hit, (cen, rad, msk), R)
    return occ & rays.alive


# ---------------------------------------------------------------------------
# Triangles
# ---------------------------------------------------------------------------

def closest_hit_triangles(rays: Rays, tris: Triangles, *,
                          obj_chunk: int = 2048,
                          formulation: str = "matmul",
                          two_sided: bool = False) -> Champion:
    """Closest valid Möller–Trumbore hit per ray
    (ref triangleTrace, code.cl:802-935, sans grid)."""
    T = tris.count
    R = rays.n
    if T == 0:
        return Champion(t=jnp.full((R,), INF),
                        idx=jnp.full((R,), -1, jnp.int32),
                        valid=jnp.zeros((R,), bool))
    C = min(obj_chunk, T)
    n_chunks = -(-T // C)

    def search(o, d, mint, maxt, v, mask):
        vp = _chunk(v, n_chunks, C)
        mp = _chunk(mask, n_chunks, C, False)

        if formulation == "matmul":
            def chunk_ts(data):
                vc, mc = data
                tc = I.tri_constants(vc)
                return I.triangle_ts_matmul(o, d, mint, maxt, tc, mc,
                                            two_sided=two_sided)
        else:
            def chunk_ts(data):
                vc, mc = data
                return I.triangle_ts_pairwise(o, d, mint, maxt, vc, mc,
                                              two_sided=two_sided).T
        return _champion_scan(chunk_ts, (vp, mp), R)

    best_t, best_i = jax.lax.stop_gradient(
        search(rays.o, rays.d, rays.mint, rays.maxt, tris.v, tris.mask))
    valid = jnp.isfinite(best_t) & rays.alive

    # differentiable recompute for champions (NaN-safe)
    v = fetch_rows(tris.v.reshape(T, 9), jnp.where(valid, best_i, -1)
                   ).reshape(R, 3, 3)
    p0 = v[:, 0]
    e1 = v[:, 1] - p0
    e2 = v[:, 2] - p0
    n_geo = jnp.cross(e2, e1)
    div = jnp.sum(rays.d * n_geo, -1)
    safe_div = jnp.where(valid & (div != 0.0), div, 1.0)
    t = jnp.sum((p0 - rays.o) * n_geo, -1) / safe_div
    t = jnp.where(valid, t, INF)
    return Champion(t=t, idx=jnp.where(valid, best_i, -1), valid=valid)


def triangle_hit_attrs(rays: Rays, tris: Triangles, champ: Champion,
                       mat_id_override: Array | None = None
                       ) -> tuple[Array, Array, Array]:
    """(p, interpolated normal, mat_id) at champion hits
    (ref triangleTrace code.cl:920-931; meshTrace single-matId variant
    code.cl:937-1070 → pass ``mat_id_override``)."""
    T = tris.count
    R = rays.n
    t_safe = jnp.where(champ.valid, champ.t, 0.0)
    p = rays.at(t_safe)
    fetched = fetch_rows(jnp.concatenate([tris.v.reshape(T, 9),
                                          tris.vn.reshape(T, 9)], -1),
                         champ.idx)
    v = fetched[:, :9].reshape(R, 3, 3)
    vn = fetched[:, 9:].reshape(R, 3, 3)
    beta, gamma = I.triangle_barycentrics(rays.o, rays.d, v)
    # sanitize: invalid lanes have v == 0 -> div == 0 handled inside
    n = I.interpolate_normal(beta, gamma, vn)
    if mat_id_override is None:
        mat = fetch_rows(tris.mat_id[:, None], champ.idx)[:, 0]
    else:
        mat = jnp.broadcast_to(jnp.asarray(mat_id_override, jnp.int32),
                               champ.idx.shape)
    mat = jnp.where(champ.valid, mat, -1)
    return p, n, mat


def anyhit_triangles(rays: Rays, tris: Triangles, *, obj_chunk: int = 2048,
                     formulation: str = "matmul",
                     two_sided: bool = False) -> Array:
    T = tris.count
    R = rays.n
    if T == 0:
        return jnp.zeros((R,), bool)
    C = min(obj_chunk, T)
    n_chunks = -(-T // C)
    vp = _chunk(tris.v, n_chunks, C)
    mp = _chunk(tris.mask, n_chunks, C, False)

    def chunk_hit(data):
        vc, mc = data
        tc = I.tri_constants(vc)
        ts = I.triangle_ts_matmul(rays.o, rays.d, rays.mint, rays.maxt,
                                  tc, mc, two_sided=two_sided)
        return jnp.isfinite(ts).any(0)

    occ = _anyhit_scan(chunk_hit, (vp, mp), R)
    return occ & rays.alive
