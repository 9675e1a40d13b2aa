"""Differentiable intersection primitives.

Reference math (all from /root/reference/Assign10-Path_Tracing/code.cl):
  * interSphere       code.cl:199-242  (quadratic, nearest t in [mint,maxt])
  * interTriangle     code.cl:250-288  (Möller–Trumbore, single-sided div<=0 reject)
  * interTriangle2    code.cl:290-299  (two-sided variant)
  * interAABB         code.cl:335-389  (3-slab test)
  * interLight        code.cl:391-403  (ray ∩ light-disk plane + radius check)

All-pairs reformulation
-----------------------
The reference evaluates these per (work-item ray × object) with scalar loops.
Here the ray-batch × object-batch inner products are expressed over
*precomputed per-object constants*, so the O(R·O) work is a few dense
multiply-adds per pair that XLA fuses into the champion reduction:

  sphere:    b, c of the quadratic come from  d·c  and  o·c
  triangle:  every Möller–Trumbore determinant is trilinear in (o, d) and the
             triangle, and splits as  det[s,d,e] = (o×d)·e − d·(e×p0)  with
             s = o − p0  — i.e. inner products against per-triangle constant
             vectors give div, beta, gamma, t for ALL pairs; no (R,T,3)
             intermediate is ever materialized.

A `pairwise` formulation (broadcasted, numerically identical to the
reference's omc form) is kept for oracle testing and extreme-coordinate
scenes; the constant-vector ("matmul") form is the production path.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

Array = jax.Array
INF = jnp.inf


def _dot3(obj_vec: Array, rays_T: Array) -> Array:
    """(O, 3) x (3, R) -> (O, R) contraction as explicit broadcast FMAs.

    Elementwise, so it is exact float32 on every backend (a dot_general
    may run in reduced precision, e.g. TF32 on a GPU) and fuses into the
    consumer instead of becoming a K=3 matrix product."""
    return (obj_vec[:, 0:1] * rays_T[0][None, :]
            + obj_vec[:, 1:2] * rays_T[1][None, :]
            + obj_vec[:, 2:3] * rays_T[2][None, :])


# ---------------------------------------------------------------------------
# Spheres
# ---------------------------------------------------------------------------

def sphere_ts_matmul(o: Array, d: Array, mint: Array, maxt: Array,
                     center: Array, radius: Array, mask: Array) -> Array:
    """All-pairs nearest valid hit parameter t, **(S, R)**; INF where no hit.

    Layout note: the pair matrix is (objects, rays), so the champion
    reduction runs over the short leading axis and the ray axis stays
    contiguous.

    Quadratic per pair (ref interSphere code.cl:199-242):
      a = |d|^2,  b = 2 (o·d − d·c),  c = |o|^2 − 2 o·c + |c|^2 − r^2.
    The r^2 term mirrors the reference's radius-squared convention
    (host stores r^2: code.js:1601; kernel uses c = dot(omc,omc) − s.r)."""
    od = jnp.sum(o * d, -1)                      # (R,)
    oo = jnp.sum(o * o, -1)                      # (R,)
    a = jnp.sum(d * d, -1)                       # (R,)
    dT, oT = d.T, o.T                            # (3,R)
    dc = _dot3(center, dT)                       # (S,R)
    oc = _dot3(center, oT)                       # (S,R)
    cc = jnp.sum(center * center, -1) - radius * radius   # (S,)
    b = 2.0 * (od[None, :] - dc)
    c = oo[None, :] - 2.0 * oc + cc[:, None]
    return _sphere_select_t(a[None, :], b, c, mint[None, :], maxt[None, :],
                            mask[:, None])


def sphere_ts_pairwise(o: Array, d: Array, mint: Array, maxt: Array,
                       center: Array, radius: Array, mask: Array) -> Array:
    """Broadcasted (R, S, 3) formulation — bitwise faithful to the
    reference's omc form; used as oracle and for huge-coordinate scenes."""
    omc = o[:, None, :] - center[None, :, :]     # (R,S,3)
    a = jnp.sum(d * d, -1)[:, None]
    b = 2.0 * jnp.sum(omc * d[:, None, :], -1)
    c = jnp.sum(omc * omc, -1) - (radius * radius)[None, :]
    return _sphere_select_t(a, b, c, mint[:, None], maxt[:, None], mask[None, :])


def _sphere_select_t(a, b, c, mint, maxt, mask) -> Array:
    dis = b * b - 4.0 * a * c
    has_root = dis >= 0.0
    sq = jnp.sqrt(jnp.maximum(dis, 0.0))
    inv2a = 0.5 / a
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    tmin = jnp.minimum(t0, t1)
    tmax = jnp.maximum(t0, t1)
    # nearest valid root in window (ref code.cl:222-236)
    tmin_ok = (tmin >= mint) & (tmin <= maxt)
    tmax_ok = (tmax >= mint) & (tmax <= maxt)
    t = jnp.where(tmin_ok, tmin, jnp.where(tmax_ok, tmax, INF))
    return jnp.where(has_root & mask, t, INF)


def sphere_normal(p: Array, center: Array) -> Array:
    """Outward normal at hit point (ref sphereTrace: code.cl:793)."""
    from ..core.types import safe_normalize
    return safe_normalize(p - center)


# ---------------------------------------------------------------------------
# Triangles (Möller–Trumbore)
# ---------------------------------------------------------------------------

class TriConstants(NamedTuple):
    """Per-triangle constants for the matmul formulation. All (T, 3)/(T,)."""
    p0: Array
    e1: Array        # p1 - p0
    e2: Array        # p2 - p0
    n_geo: Array     # cross(e2, e1) — the reference's div normal orientation
    c1: Array        # cross(e1, p0)
    c2: Array        # cross(e2, p0)
    k: Array         # dot(p0, n_geo)


def tri_constants(v: Array) -> TriConstants:
    p0, p1, p2 = v[:, 0], v[:, 1], v[:, 2]
    e1 = p1 - p0
    e2 = p2 - p0
    n_geo = jnp.cross(e2, e1)
    return TriConstants(p0=p0, e1=e1, e2=e2, n_geo=n_geo,
                        c1=jnp.cross(e1, p0), c2=jnp.cross(e2, p0),
                        k=jnp.sum(p0 * n_geo, -1))


def triangle_ts_matmul(o: Array, d: Array, mint: Array, maxt: Array,
                       tc: TriConstants, mask: Array,
                       two_sided: bool = False) -> Array:
    """All-pairs Möller–Trumbore hit t, **(T, R)** (see layout note on
    sphere_ts_matmul); INF where no hit.

    Determinant split (s = o − p0):
      div   = d · n_geo                                   (ref code.cl:256)
      beta  = ((o×d)·e2 − d·(e2×p0)) / div                (ref code.cl:264)
      gamma = (d·(e1×p0) − (o×d)·e1) / div                (ref code.cl:271)
      t     = (k − o·n_geo) / div                         (ref code.cl:279)
    """
    oxd = jnp.cross(o, d)                        # (R,3)
    dT, oT, oxdT = d.T, o.T, oxd.T               # (3,R)
    div = _dot3(tc.n_geo, dT)                    # (T,R)
    o_ng = _dot3(tc.n_geo, oT)                   # (T,R)
    beta_num = _dot3(tc.e2, oxdT) - _dot3(tc.c2, dT)     # (T,R)
    gamma_num = _dot3(tc.c1, dT) - _dot3(tc.e1, oxdT)    # (T,R)

    if two_sided:
        side_ok = div != 0.0
    else:
        side_ok = div > 0.0                      # single-sided (ref code.cl:257)
    safe_div = jnp.where(div == 0.0, 1.0, div)
    idiv = 1.0 / safe_div
    beta = beta_num * idiv
    gamma = gamma_num * idiv
    t = (tc.k[:, None] - o_ng) * idiv

    bary_ok = (beta >= 0.0) & (beta <= 1.0) & (gamma >= 0.0) & \
              (beta + gamma <= 1.0)
    t_ok = (t >= mint[None, :]) & (t <= maxt[None, :])
    valid = side_ok & bary_ok & t_ok & mask[:, None]
    return jnp.where(valid, t, INF)


def triangle_ts_pairwise(o: Array, d: Array, mint: Array, maxt: Array,
                         v: Array, mask: Array, two_sided: bool = False) -> Array:
    """Broadcasted (R, T, 3) Möller–Trumbore, cross-product form faithful to
    the reference (oracle path)."""
    p0, p1, p2 = v[:, 0], v[:, 1], v[:, 2]
    e1 = (p1 - p0)[None]                          # (1,T,3)
    e2 = (p2 - p0)[None]
    dd = d[:, None, :]                            # (R,1,3)
    div = jnp.sum(jnp.cross(e2, e1) * dd, -1)     # (R,T)
    s = o[:, None, :] - p0[None]                  # (R,T,3)
    sxd = jnp.cross(s, dd)
    beta_num = jnp.sum(sxd * e2, -1)
    gamma_num = jnp.sum(jnp.cross(s, e1) * dd, -1)
    t_num = jnp.sum(jnp.cross(s, e2) * e1, -1)

    side_ok = (div != 0.0) if two_sided else (div > 0.0)
    safe_div = jnp.where(div == 0.0, 1.0, div)
    idiv = 1.0 / safe_div
    beta = beta_num * idiv
    gamma = gamma_num * idiv
    t = t_num * (-idiv)
    bary_ok = (beta >= 0.0) & (beta <= 1.0) & (gamma >= 0.0) & \
              (beta + gamma <= 1.0)
    t_ok = (t >= mint[:, None]) & (t <= maxt[:, None])
    return jnp.where(side_ok & bary_ok & t_ok & mask[None, :], t, INF)


def triangle_barycentrics(o: Array, d: Array, v: Array) -> tuple[Array, Array]:
    """(beta, gamma) of ray-plane intersection for *champion* triangles only:
    o,d (R,3) against per-ray triangle v (R,3,3). Cheap (R)-sized recompute so
    the all-pairs pass never has to carry barycentrics."""
    p0, p1, p2 = v[:, 0], v[:, 1], v[:, 2]
    e1 = p1 - p0
    e2 = p2 - p0
    div = jnp.sum(jnp.cross(e2, e1) * d, -1)
    safe_div = jnp.where(div == 0.0, 1.0, div)
    idiv = 1.0 / safe_div
    s = o - p0
    beta = jnp.sum(jnp.cross(s, d) * e2, -1) * idiv
    gamma = jnp.sum(jnp.cross(s, e1) * d, -1) * idiv
    return beta, gamma


def interpolate_normal(beta: Array, gamma: Array, vn: Array) -> Array:
    """Barycentric normal interpolation, normalized
    (ref interp code.cl:405-411; use in triangleTrace code.cl:927)."""
    from ..core.types import safe_normalize
    n = (1.0 - beta - gamma)[:, None] * vn[:, 0] \
        + beta[:, None] * vn[:, 1] + gamma[:, None] * vn[:, 2]
    return safe_normalize(n)


# ---------------------------------------------------------------------------
# AABB
# ---------------------------------------------------------------------------

def aabb_window(o: Array, d: Array, pmin: Array, pmax: Array
                ) -> tuple[Array, Array, Array]:
    """Slab test of a ray batch against ONE box.
    Returns (tmin, tmax, valid) with the reference's [0, INF) initial window
    (ref interAABB code.cl:335-389).

    o, d: (R, 3); pmin/pmax: (3,)."""
    safe_d = jnp.where(d == 0.0, 1e-30, d)
    t0 = (pmin[None, :] - o) / safe_d
    t1 = (pmax[None, :] - o) / safe_d
    near = jnp.minimum(t0, t1)
    far = jnp.maximum(t0, t1)
    tmin = jnp.maximum(near.max(-1), 0.0)
    tmax = jnp.minimum(far.min(-1), INF)
    return tmin, tmax, tmin <= tmax


# ---------------------------------------------------------------------------
# Disk lights
# ---------------------------------------------------------------------------

def light_disk_t(o: Array, d: Array, position: Array, normal: Array,
                 radius: Array) -> Array:
    """Ray ∩ one disk light: plane hit + radius check
    (ref interLight code.cl:391-403). Returns t, INF when missed.

    o,d: (R,3); position/normal: (3,), radius: ()."""
    den = jnp.sum(d * normal[None, :], -1)
    num = jnp.sum((position[None, :] - o) * normal[None, :], -1)
    safe_den = jnp.where(den == 0.0, 1.0, den)
    t = num / safe_den
    p = o + t[:, None] * d
    on_disk = jnp.sum((p - position[None, :]) ** 2, -1) <= radius * radius
    # reference also rejects num == 0 (ray origin on the plane)
    valid = (den != 0.0) & (num != 0.0) & on_disk
    return jnp.where(valid, t, INF)
