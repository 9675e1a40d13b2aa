"""3-axis DDA traversal of the uniform grid — device side.

Reproduces the reference's slab march (ref sphereTrace
Assign10-Path_Tracing/code.cl:675-800: per-axis init 696-733, march loop
745-786; triangleTrace 802-935), re-shaped for a vector machine:

  * all rays march in lockstep inside a ``lax.while_loop`` whose condition
    is "any ray still active" — per-ray divergence becomes masking;
  * per-cell object loops become fixed-K masked intersections against the
    padded (n_cells, K) table (accel/grid.py);
  * the early-exit ("champion found -> break", code.cl:775) becomes a
    per-ray deactivation once the champion is known final
    (best_t <= current cell entry t);
  * duplicated objects across cells are harmless (hits idempotent,
    SURVEY §7 quirk 9).

Differentiability mirrors ops/closest_hit.py: the search runs under
stop_gradient; champion t is recomputed differentiably from the winning
object's parameters.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.types import Rays, Spheres, Triangles
from ..ops.closest_hit import Champion, fetch_rows
from ..ops.intersect import aabb_window
from .grid import Grid

Array = jax.Array
INF = jnp.inf


def _init_dda(rays: Rays, grid: Grid):
    o, d = rays.o, rays.d
    tmin, tmax, ok = aabb_window(o, d, grid.pmin, grid.pmax)
    tmin = jnp.maximum(tmin, rays.mint)
    tmax_eff = jnp.minimum(tmax, rays.maxt)
    active = ok & rays.alive & (tmin <= tmax_eff)

    nv = jnp.asarray(grid.n, jnp.float32)          # (3,) per-axis resolution
    width = (grid.pmax - grid.pmin) / nv           # (3,)
    width = jnp.where(width <= 0.0, 1e-30, width)
    entry = o + tmin[:, None] * d                  # (R,3)
    cell = jnp.clip(jnp.floor((entry - grid.pmin[None, :]) / width[None, :]),
                    0, jnp.asarray(grid.n) - 1).astype(jnp.int32)  # (R,3)
    pos_dir = d >= 0.0
    step = jnp.where(pos_dir, 1, -1).astype(jnp.int32)
    safe_d = jnp.where(d == 0.0, 1e-30, d)
    t_delta = width[None, :] / jnp.abs(safe_d)
    nxt = grid.pmin[None, :] + (cell + pos_dir.astype(jnp.int32)) * width[None, :]
    t_next = (nxt - o) / safe_d
    t_next = jnp.where(d == 0.0, INF, t_next)
    return cell, step, t_delta, t_next, tmin, tmax_eff, active


def _march(rays: Rays, grid: Grid, cell_test, R: int):
    """Generic DDA march. ``cell_test(cell_id, window_lo, window_hi, active)
    -> (t (R,), idx (R,))`` returns the best hit among the cell's items in
    the given t-window (INF/-1 = none)."""
    cell, step, t_delta, t_next, t_cur, t_exit, active = _init_dda(rays, grid)
    nx, ny, nz = grid.n
    nv = jnp.asarray(grid.n, jnp.int32)
    max_steps = nx + ny + nz

    def cond(carry):
        s, _, _, _, active, _, _ = carry
        return (s < max_steps) & active.any()

    def body(carry):
        s, cell, t_next, t_cur, active, best_t, best_i = carry
        cell_id = cell[:, 2] * (ny * nx) + cell[:, 1] * nx + cell[:, 0]
        t, i = cell_test(cell_id, active)
        better = active & (t < best_t)
        best_t = jnp.where(better, t, best_t)
        best_i = jnp.where(better, i, best_i)

        # advance to next cell along the axis with smallest t_next
        # (ref code.cl:757-785)
        axis = jnp.argmin(t_next, axis=-1)               # (R,)
        t_step = t_next.min(-1)
        onehot = jax.lax.broadcasted_iota(jnp.int32, (R, 3), 1) == axis[:, None]
        cell = cell + jnp.where(onehot, step, 0)
        t_next = t_next + jnp.where(onehot, t_delta, 0.0)
        out = (cell < 0).any(-1) | (cell >= nv[None, :]).any(-1) \
            | (t_step > t_exit)
        # champion final once its t precedes the next cell's entry
        done = best_t <= t_step
        active = active & ~out & ~done
        return (s + 1, cell, t_next, t_step, active, best_t, best_i)

    init = (jnp.int32(0), cell, t_next, t_cur, active,
            jnp.full((R,), INF), jnp.full((R,), -1, jnp.int32))
    _, _, _, _, _, best_t, best_i = jax.lax.while_loop(cond, body, init)
    return best_t, best_i


# grids up to this many cells use the DENSE cell scan: a lax.scan over
# cells where each step dynamic-slices ONE row of the packed cell table
# (no (R, C) one-hot, no per-ray gather) and champions its items within
# the ray window. Identical results to the march/brute: the union of the
# binned items is the full object set and duplicated hits are idempotent
# (SURVEY §7 quirk 9), so no per-cell t-window is needed (a fp-exact
# window would drop hits landing exactly on cell-boundary planes). O(C*K
# duplicated items) per ray; below ~512 cells it avoids the march's
# per-step lockstep overhead.
DENSE_MAX_CELLS = 512


def _dense_cell_scan(rays: Rays, grid: Grid, cell_items_test, R: int):
    """Champion over cells via lax.scan. ``cell_items_test(c) ->
    (t (R,K), ids (R,K))`` evaluates cell c's padded items inside each
    ray's own t-window."""
    C = grid.items.shape[0]

    def body(carry, c):
        best_t, best_i = carry
        t, ids = cell_items_test(c)
        tb, kb = _best_of_cell(t, ids)
        better = tb < best_t
        return (jnp.where(better, tb, best_t),
                jnp.where(better, kb, best_i)), None

    init = (jnp.full((R,), INF), jnp.full((R,), -1, jnp.int32))
    (best_t, best_i), _ = jax.lax.scan(body, init,
                                       jnp.arange(C, dtype=jnp.int32))
    return best_t, best_i


def _best_of_cell(t: Array, ids: Array) -> tuple[Array, Array]:
    """(R, K) candidate ts + item ids -> per-ray (t, id). Fusable where/min
    instead of argmin + gather (ties between distinct objects at identical
    float t are resolved to the smaller id; the reference resolves to cell
    slot order — indistinguishable in practice)."""
    tb = t.min(-1)
    big = jnp.int32(2 ** 30)
    kb = jnp.where(t == tb[:, None], ids, big).min(-1)
    return tb, jnp.where(jnp.isfinite(tb), kb, -1)


# ---------------------------------------------------------------------------
# Spheres
# ---------------------------------------------------------------------------

def grid_closest_spheres(rays: Rays, spheres: Spheres, grid: Grid,
                         method: str = "auto") -> Champion:
    R = rays.n
    C, K = grid.items.shape
    use_dense = method == "dense" or (method == "auto"
                                      and C <= DENSE_MAX_CELLS)

    # Per-cell parameter table, built ONCE per trace (a tiny (C, K) gather
    # over the object arrays; XLA hoists it out of the march loop). Per DDA
    # step each ray gathers its cell's row. Item ids stay int32 in
    # grid.items, so they are exact at any object count.
    safe = jnp.maximum(grid.items, 0)
    valid_item = (grid.items >= 0) & spheres.mask[safe]          # (C, K)
    cell_tab = jnp.concatenate([
        spheres.center[safe],                                    # (C, K, 3)
        spheres.radius[safe][..., None],
        valid_item[..., None].astype(jnp.float32),
    ], axis=-1).reshape(C, K * 5)

    def _sphere_window_test(f, ids, lo, hi, active):
        """(R, K, 5) params + (R, K) item ids + per-ray window -> (t, ids)."""
        c = f[..., 0:3]
        r = f[..., 3]
        mask = (f[..., 4] > 0.0) & active[:, None]
        omc = rays.o[:, None, :] - c
        a = jnp.sum(rays.d * rays.d, -1)[:, None]
        b = 2.0 * jnp.sum(omc * rays.d[:, None, :], -1)
        cq = jnp.sum(omc * omc, -1) - r * r
        dis = b * b - 4.0 * a * cq
        has = dis >= 0.0
        sq = jnp.sqrt(jnp.maximum(dis, 0.0))
        inv2a = 0.5 / a
        t0 = (-b - sq) * inv2a
        t1 = (-b + sq) * inv2a
        tmn = jnp.minimum(t0, t1)
        tmx = jnp.maximum(t0, t1)
        t = jnp.where((tmn >= lo) & (tmn <= hi), tmn,
                      jnp.where((tmx >= lo) & (tmx <= hi), tmx, INF))
        t = jnp.where(has & mask, t, INF)
        return t, ids

    def cell_test(cell_id, active):
        # out-of-range cell ids gather zero rows -> mask 0 -> INF
        f = fetch_rows(cell_tab, cell_id).reshape(R, K, 5)
        ids = fetch_rows(grid.items, cell_id)
        return _best_of_cell(*_sphere_window_test(
            f, ids, rays.mint[:, None], rays.maxt[:, None], active))

    def cell_items_test(c):
        row = jax.lax.dynamic_slice_in_dim(cell_tab, c, 1, axis=0)
        f = jnp.broadcast_to(row.reshape(1, K, 5), (R, K, 5))
        ids = jnp.broadcast_to(
            jax.lax.dynamic_slice_in_dim(grid.items, c, 1, axis=0), (R, K))
        return _sphere_window_test(f, ids, rays.mint[:, None],
                                   rays.maxt[:, None], rays.alive)

    if use_dense:
        best_t, best_i = jax.lax.stop_gradient(
            _dense_cell_scan(rays, grid, cell_items_test, R))
    else:
        best_t, best_i = jax.lax.stop_gradient(
            _march(rays, grid, cell_test, R))
    valid = jnp.isfinite(best_t) & rays.alive

    # differentiable recompute (same pattern as ops.closest_hit)
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
    finite_best = jnp.where(valid, best_t, 0.0)
    t0 = (-b - sq) * (0.5 / a)
    t1 = (-b + sq) * (0.5 / a)
    tt = jnp.where(jnp.abs(t0 - finite_best) <= jnp.abs(t1 - finite_best),
                   t0, t1)
    t = jnp.where(valid, tt, INF)
    return Champion(t=t, idx=jnp.where(valid, best_i, -1), valid=valid)


# ---------------------------------------------------------------------------
# Triangles
# ---------------------------------------------------------------------------

def grid_closest_triangles(rays: Rays, tris: Triangles, grid: Grid,
                           two_sided: bool = False,
                           method: str = "auto") -> Champion:
    R = rays.n

    C, K = grid.items.shape
    use_dense = method == "dense" or (method == "auto"
                                      and C <= DENSE_MAX_CELLS)
    # per-cell Moller-Trumbore constants (same split as
    # ops.intersect.tri_constants), built once; item ids stay int32 in
    # grid.items (see grid_closest_spheres)
    from ..ops.intersect import tri_constants
    tc = tri_constants(tris.v)
    safe = jnp.maximum(grid.items, 0)
    valid_item = (grid.items >= 0) & tris.mask[safe]             # (C, K)
    cell_tab = jnp.concatenate([
        tc.n_geo[safe], tc.c1[safe], tc.c2[safe],
        tc.e1[safe], tc.e2[safe], tc.k[safe][..., None],
        valid_item[..., None].astype(jnp.float32),
    ], axis=-1).reshape(C, K * 17)

    oxd = jnp.cross(rays.o, rays.d)                              # (R, 3)

    def _tri_window_test(f, ids, lo, hi, active):
        n_geo = f[..., 0:3]
        c1 = f[..., 3:6]
        c2 = f[..., 6:9]
        e1 = f[..., 9:12]
        e2 = f[..., 12:15]
        kk = f[..., 15]
        mask = (f[..., 16] > 0.0) & active[:, None]
        dd = rays.d[:, None, :]
        oo = rays.o[:, None, :]
        xx = oxd[:, None, :]
        div = jnp.sum(n_geo * dd, -1)                            # (R, K)
        side_ok = (div != 0.0) if two_sided else (div > 0.0)
        idiv = 1.0 / jnp.where(div == 0.0, 1.0, div)
        beta = (jnp.sum(e2 * xx, -1) - jnp.sum(c2 * dd, -1)) * idiv
        gamma = (jnp.sum(c1 * dd, -1) - jnp.sum(e1 * xx, -1)) * idiv
        t = (kk - jnp.sum(n_geo * oo, -1)) * idiv
        ok = side_ok & (beta >= 0.0) & (beta <= 1.0) & (gamma >= 0.0) & \
            (beta + gamma <= 1.0) & (t >= lo) & (t <= hi) & mask
        t = jnp.where(ok, t, INF)
        return t, ids

    def cell_test(cell_id, active):
        f = fetch_rows(cell_tab, cell_id).reshape(R, K, 17)
        ids = fetch_rows(grid.items, cell_id)
        return _best_of_cell(*_tri_window_test(
            f, ids, rays.mint[:, None], rays.maxt[:, None], active))

    def cell_items_test(c):
        row = jax.lax.dynamic_slice_in_dim(cell_tab, c, 1, axis=0)
        f = jnp.broadcast_to(row.reshape(1, K, 17), (R, K, 17))
        ids = jnp.broadcast_to(
            jax.lax.dynamic_slice_in_dim(grid.items, c, 1, axis=0), (R, K))
        return _tri_window_test(f, ids, rays.mint[:, None],
                                rays.maxt[:, None], rays.alive)

    if use_dense:
        best_t, best_i = jax.lax.stop_gradient(
            _dense_cell_scan(rays, grid, cell_items_test, R))
    else:
        best_t, best_i = jax.lax.stop_gradient(
            _march(rays, grid, cell_test, R))
    valid = jnp.isfinite(best_t) & rays.alive

    T = tris.count
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
