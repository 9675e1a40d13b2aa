"""Pure-NumPy reference tracer used as test oracle (SURVEY §4 item 1).

Implements the reference's intersection and shading math with scalar loops in
float64 — slow, obviously-correct, and independent of the JAX code paths.
Semantics follow /root/reference/Assign10-Path_Tracing/code.cl.
"""
import numpy as np


def sphere_ts(o, d, mint, maxt, cen, rad):
    """(R, S) nearest valid hit t; inf = miss (ref interSphere code.cl:199-242)."""
    R, S = o.shape[0], cen.shape[0]
    ts = np.full((R, S), np.inf)
    for i in range(R):
        for j in range(S):
            omc = o[i] - cen[j]
            a = d[i] @ d[i]
            b = 2 * omc @ d[i]
            c = omc @ omc - rad[j] ** 2
            dis = b * b - 4 * a * c
            if dis < 0:
                continue
            sq = np.sqrt(dis)
            t0, t1 = (-b - sq) / (2 * a), (-b + sq) / (2 * a)
            tmn, tmx = min(t0, t1), max(t0, t1)
            if mint[i] <= tmn <= maxt[i]:
                ts[i, j] = tmn
            elif mint[i] <= tmx <= maxt[i]:
                ts[i, j] = tmx
    return ts


def triangle_ts(o, d, mint, maxt, v, two_sided=False):
    """(R, T) Möller–Trumbore hit t (ref interTriangle code.cl:250-288)."""
    R, T = o.shape[0], v.shape[0]
    ts = np.full((R, T), np.inf)
    for i in range(R):
        for j in range(T):
            for flip in ([False, True] if two_sided else [False]):
                p0, p1, p2 = v[j]
                if flip:
                    p0, p1 = p1, p0
                e1, e2 = p1 - p0, p2 - p0
                div = np.cross(e2, e1) @ d[i]
                if div <= 0:
                    continue
                idiv = 1 / div
                s = o[i] - p0
                beta = (np.cross(s, d[i]) @ e2) * idiv
                if beta < 0 or beta > 1:
                    continue
                gamma = (np.cross(s, e1) @ d[i]) * idiv
                if gamma < 0 or beta + gamma > 1:
                    continue
                t = (np.cross(s, e2) @ e1) * -idiv
                if mint[i] <= t <= maxt[i]:
                    ts[i, j] = min(ts[i, j], t)
    return ts


def aabb_window(o, d, pmin, pmax):
    """(tmin, tmax, valid) per ray (ref interAABB code.cl:335-389)."""
    R = o.shape[0]
    tmin = np.zeros(R)
    tmax = np.full(R, np.inf)
    ok = np.ones(R, bool)
    for i in range(R):
        lo, hi = 0.0, np.inf
        for ax in range(3):
            da = d[i, ax]
            if da == 0:
                da = 1e-30
            t0 = (pmin[ax] - o[i, ax]) / da
            t1 = (pmax[ax] - o[i, ax]) / da
            if t0 > t1:
                t0, t1 = t1, t0
            lo, hi = max(lo, t0), min(hi, t1)
        tmin[i], tmax[i], ok[i] = lo, hi, lo <= hi
    return tmin, tmax, ok


def pinhole_ray(eye, u, v, w, width, height, cols, rows, col, row):
    """(o, d) (ref getRay code.cl:108-119)."""
    cop = (-0.5 + (col + 0.5) / cols) * width * u + \
          (0.5 - (row + 0.5) / rows) * height * v - w
    d = cop / np.linalg.norm(cop)
    return eye.copy(), d


def fake_shade_image(o_eye, cam_w, cam, cen, rad, colors, cols, rows):
    """Assign02 monolithic raytrace kernel (Assign02 code.cl:158-232):
    champion sphere + fake shade dot(W, n), color*shade, black background.
    Returns float image (rows, cols, 3) in [0,1]-ish (pre-u8)."""
    img = np.zeros((rows, cols, 3))
    mint = np.zeros(1)
    maxt = np.full(1, np.inf)
    for r in range(rows):
        for c in range(cols):
            o, d = pinhole_ray(o_eye, cam[0], cam[1], cam[2], cam[3], cam[4],
                               cols, rows, c, r)
            ts = sphere_ts(o[None], d[None], mint, maxt, cen, rad)[0]
            j = np.argmin(ts)
            if np.isfinite(ts[j]):
                p = o + ts[j] * d
                n = (p - cen[j]) / np.linalg.norm(p - cen[j])
                shade = cam_w @ n
                img[r, c] = colors[j][:3] * shade
    return img


def sphere_ts_vec(o, d, mint, maxt, cen, rad):
    """Vectorized float64 ``sphere_ts`` for large ray batches (same math,
    NumPy broadcasting instead of loops)."""
    o, d, cen = (np.asarray(x, np.float64) for x in (o, d, cen))
    rad = np.asarray(rad, np.float64)
    omc = o[:, None, :] - cen[None]
    a = np.sum(d * d, -1)[:, None]
    b = 2 * np.sum(omc * d[:, None, :], -1)
    c = np.sum(omc * omc, -1) - rad[None] ** 2
    dis = b * b - 4 * a * c
    sq = np.sqrt(np.maximum(dis, 0))
    t0, t1 = (-b - sq) / (2 * a), (-b + sq) / (2 * a)
    tmn, tmx = np.minimum(t0, t1), np.maximum(t0, t1)
    lo, hi = np.asarray(mint)[:, None], np.asarray(maxt)[:, None]
    t = np.where((lo <= tmn) & (tmn <= hi), tmn,
                 np.where((lo <= tmx) & (tmx <= hi), tmx, np.inf))
    return np.where(dis >= 0, t, np.inf)


def triangle_ts_vec(o, d, mint, maxt, v, two_sided=False):
    """Vectorized float64 ``triangle_ts``."""
    o, d, v = (np.asarray(x, np.float64) for x in (o, d, v))
    out = np.full((o.shape[0], v.shape[0]), np.inf)
    for flip in ([False, True] if two_sided else [False]):
        p0, p1, p2 = v[:, 0], v[:, 1], v[:, 2]
        if flip:
            p0, p1 = p1, p0
        e1, e2 = (p1 - p0)[None], (p2 - p0)[None]
        dd = d[:, None, :]
        div = np.sum(np.cross(e2, e1) * dd, -1)
        with np.errstate(divide="ignore", invalid="ignore"):
            idiv = 1 / div
            s = o[:, None, :] - p0[None]
            beta = np.sum(np.cross(s, dd) * e2, -1) * idiv
            gamma = np.sum(np.cross(s, e1) * dd, -1) * idiv
            t = np.sum(np.cross(s, e2) * e1, -1) * -idiv
        ok = (div > 0) & (beta >= 0) & (beta <= 1) & (gamma >= 0) \
            & (beta + gamma <= 1) & (np.asarray(mint)[:, None] <= t) \
            & (t <= np.asarray(maxt)[:, None])
        out = np.minimum(out, np.where(ok, t, np.inf))
    return out
