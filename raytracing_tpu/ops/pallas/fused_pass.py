"""Fused per-ray path-tracing kernel for NVIDIA GPUs (Pallas, Triton route).

One program traces BLOCK rays through the whole pass schedule of
render/pathtracer.py (mode "path": primary trace, emitter credit, NEE,
``bounces`` x [RR] bounce + trace + NEE) or render/direct.py (mode
"direct": primary trace, shadowed ambient + cosine shade), K passes in a
loop with the accumulator in registers. The XLA stage pipeline writes
every intermediate (rays, hits, (objects x rays) tiles) to device memory
between its ~200 fusions; this kernel reads the scene tables (a few KB,
served by L1/L2 through scalar and gather loads) and reads and writes only
the accumulator.

Scope: brute force over the sphere and triangle tables, of any size;
objects are visited by ``lax.fori_loop`` with runtime trip counts. The
stale-POI bug-compat is not implemented; render/route.py decides when a
uniform grid in the XLA pipeline beats this brute force.

Draws: a counter-based integer hash keyed on (state key, pass, global ray
id, draw slot), in uint32 arithmetic. With ``u_planes`` (parity mode, one
pass) the kernel instead reads the XLA pipeline's own threefry draws in
the slot layout of ``pathtracer.pass_draw_count``, so both routes see the
same samples and their images can be compared pixel by pixel.

Forward only: gradients go through XLA's AD of the stage pipeline.
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ...core import rng
from ...core.config import RenderConfig
from ...core.types import Scene

Array = jax.Array
INF = float("inf")

BLOCK = 128           # rays per program: one ray per thread at 4 warps
NUM_WARPS = 4

SPH_W = 8             # cx cy cz r mat valid - -
TRI_W = 24            # p0 e1 e2 n_geo vn0 vn1 vn2 mat valid -
MAT_W = 4             # r g b a
LIG_W = 20            # pos nrm irr irr_emit radius area t_ax b_ax
PAR_W = 32            # eye U V W film_w film_h focal lens pmin pmax


def covers(scene: Scene, cfg: RenderConfig) -> bool:
    """Whether this kernel renders ``scene`` under ``cfg``."""
    return not cfg.replicate_stale_poi and cfg.total_rays < 2 ** 31


def _pow2(n: int, least: int = 8) -> int:
    return max(least, 1 << max(n - 1, 0).bit_length())


def _flat(rows: Array, width: int) -> Array:
    """(N, <=width) rows -> flat f32 table of power-of-two length."""
    rows = jnp.asarray(rows, jnp.float32)
    rows = jnp.pad(rows, ((0, 0), (0, width - rows.shape[1])))
    flat = rows.reshape(-1)
    return jnp.pad(flat, (0, _pow2(flat.shape[0]) - flat.shape[0]))


def scene_tables(scene: Scene, cfg: RenderConfig):
    """Pack the scene into the kernel's flat f32 tables."""
    from ...render.stages import _all_triangles
    cam = scene.camera
    par = jnp.concatenate([
        cam.eye, cam.u, cam.v, cam.w,
        jnp.stack([cam.width, cam.height, scene.focal_length,
                   scene.lens_radius]).astype(jnp.float32),
        scene.bounds_min, scene.bounds_max])
    par = jnp.pad(par.astype(jnp.float32), (0, PAR_W - par.shape[0]))

    sp = scene.spheres
    sph = _flat(jnp.concatenate([
        sp.center, sp.radius[:, None], sp.mat_id[:, None].astype(jnp.float32),
        sp.mask[:, None].astype(jnp.float32)], -1), SPH_W)

    tr = _all_triangles(scene)
    v = tr.v
    p0, e1, e2 = v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    tri = _flat(jnp.concatenate([
        p0, e1, e2, jnp.cross(e2, e1), tr.vn.reshape(-1, 9),
        tr.mat_id[:, None].astype(jnp.float32),
        tr.mask[:, None].astype(jnp.float32)], -1), TRI_W)

    mat = _flat(scene.materials, MAT_W)

    lg = scene.lights
    t_ax, b_ax = lg.frames()
    irr_emit = lg.irradiance
    if cfg.normalize_emitter:
        irr_emit = irr_emit / jnp.maximum(
            jnp.linalg.norm(irr_emit, axis=-1, keepdims=True), 1e-20)
    lig = _flat(jnp.concatenate([
        lg.position, lg.normal, lg.irradiance, irr_emit,
        lg.radius[:, None], lg.area[:, None], t_ax, b_ax], -1), LIG_W)
    return par, sph, tri, mat, lig


# ---------------------------------------------------------------------------
# per-ray math on (BLOCK,) lanes; vectors are 3-tuples of lanes
# ---------------------------------------------------------------------------

def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def _scale(a, s):
    return tuple(x * s for x in a)


def _where(c, a, b):
    return tuple(jnp.where(c, x, y) for x, y in zip(a, b))


def _normalize(v):
    """core.types.safe_normalize."""
    n2 = _dot(v, v)
    return _scale(v, jax.lax.rsqrt(jnp.where(n2 > 0.0, n2, 1.0)))


def _concentric(u0, u1):
    """core.sampling.concentric_disk."""
    a = 2.0 * u0 - 1.0
    b = 2.0 * u1 - 1.0
    top = a * a > b * b
    safe_a = jnp.where(a == 0.0, 1.0, a)
    safe_b = jnp.where(b == 0.0, 1.0, b)
    radius = jnp.where(top, a, b)
    phi = jnp.where(top, (math.pi / 4.0) * (b / safe_a),
                    (math.pi / 2.0) - (math.pi / 4.0) * (a / safe_b))
    zero = (u0 == 0.0) & (u1 == 0.0)
    return (jnp.where(zero, u0, jnp.cos(phi) * radius),
            jnp.where(zero, u1, jnp.sin(phi) * radius))


def _tangent_frame(n):
    """core.types.tangent_frame (first min-|component| axis -> 1)."""
    ax, ay, az = (jnp.abs(c) for c in n)
    m = jnp.minimum(ax, jnp.minimum(ay, az))
    xm = ax == m
    ym = (ay == m) & ~xm
    zm = (az == m) & ~xm & ~ym
    v = _normalize((jnp.where(xm, 1.0, n[0]), jnp.where(ym, 1.0, n[1]),
                    jnp.where(zm, 1.0, n[2])))
    t = _normalize(_cross(v, n))
    return t, _normalize(_cross(n, t))


def _mix(x):
    """32-bit avalanche (lowbias32); uint32 lanes."""
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    return x ^ (x >> 16)


def _mix_py(x: int) -> int:
    x &= 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    return x ^ (x >> 16)


def _uniform(h):
    return (h >> 8).astype(jnp.float32) * (1.0 / 16777216.0)


def _kernel(ipar_ref, par_ref, sph_ref, tri_ref, mat_ref, lig_ref,
            acc_r, acc_g, acc_b, *rest, c):
    """``c``: static config dict (see _call)."""
    u_ref = rest[0] if c["parity"] else None
    out_r, out_g, out_b = rest[-3:]
    n_l = c["n_l"]
    eps = c["shadow_eps"]
    # trip counts are runtime scalars: constant ones let the compiler
    # unroll every object loop at every trace site, which multiplied the
    # card's compile time without making the kernel faster
    n_s, n_t, bounces, n_passes = (ipar_ref[4], ipar_ref[5], ipar_ref[6],
                                   ipar_ref[7])

    lane = jax.lax.broadcasted_iota(jnp.int32, (BLOCK,), 0)
    rid = pl.program_id(0) * BLOCK + lane
    gid = rid + ipar_ref[2]
    k0 = ipar_ref[0].astype(jnp.uint32)
    k1 = ipar_ref[1].astype(jnp.uint32)
    pass0 = ipar_ref[3]

    # ---- scene queries ---------------------------------------------------

    def sphere_t(i, o, d, mint, maxt):
        """Nearest root of sphere i in [mint, maxt], INF on a miss
        (intersect.sphere_ts_pairwise)."""
        b = i * SPH_W
        omc = _sub(o, (sph_ref[b], sph_ref[b + 1], sph_ref[b + 2]))
        r = sph_ref[b + 3]
        a = _dot(d, d)
        bq = 2.0 * _dot(omc, d)
        dis = bq * bq - 4.0 * a * (_dot(omc, omc) - r * r)
        sq = jnp.sqrt(jnp.maximum(dis, 0.0))
        inv2a = 0.5 / a
        t0 = (-bq - sq) * inv2a
        t1 = (-bq + sq) * inv2a
        tmn = jnp.minimum(t0, t1)
        tmx = jnp.maximum(t0, t1)
        t = jnp.where((tmn >= mint) & (tmn <= maxt), tmn,
                      jnp.where((tmx >= mint) & (tmx <= maxt), tmx, INF))
        return jnp.where((dis >= 0.0) & (sph_ref[b + 5] > 0.0), t, INF)

    def tri_bary(b, o, d):
        """(t, beta, gamma, div) of the ray against triangle row b
        (intersect.triangle_ts_pairwise)."""
        p0 = (tri_ref[b], tri_ref[b + 1], tri_ref[b + 2])
        e1 = (tri_ref[b + 3], tri_ref[b + 4], tri_ref[b + 5])
        e2 = (tri_ref[b + 6], tri_ref[b + 7], tri_ref[b + 8])
        ng = (tri_ref[b + 9], tri_ref[b + 10], tri_ref[b + 11])
        div = _dot(ng, d)
        idiv = 1.0 / jnp.where(div == 0.0, 1.0, div)
        s = _sub(o, p0)
        return (-_dot(s, ng) * idiv, _dot(_cross(s, d), e2) * idiv,
                _dot(_cross(s, e1), d) * idiv, div)

    def tri_t(i, o, d, mint, maxt):
        """Hit distance of triangle i in [mint, maxt], INF on a miss."""
        b = i * TRI_W
        t, beta, gamma, div = tri_bary(b, o, d)
        side = (div != 0.0) if c["two_sided"] else (div > 0.0)
        hit = side & (tri_ref[b + 22] > 0.0) & (beta >= 0.0) \
            & (beta <= 1.0) & (gamma >= 0.0) & (beta + gamma <= 1.0) \
            & (t >= mint) & (t <= maxt)
        return jnp.where(hit, t, INF)

    def trace(o, d, mint, maxt, alive):
        """Closest hit: (t, valid, p, n, mat)."""
        def champion(hit_t):
            def body(i, carry):
                bt, bi = carry
                t = hit_t(i, o, d, mint, maxt)
                better = t < bt
                return jnp.where(better, t, bt), jnp.where(better, i, bi)
            return body

        none = jnp.full((BLOCK,), -1, jnp.int32)
        ts, si = jax.lax.fori_loop(0, n_s, champion(sphere_t),
                                   (jnp.full((BLOCK,), INF), none))
        tt, ti = jax.lax.fori_loop(0, n_t, champion(tri_t),
                                   (jnp.full((BLOCK,), INF), none))
        is_tri = tt < ts
        t = jnp.where(is_tri, tt, ts)
        valid = (t < INF) & alive
        p = _add(o, _scale(d, jnp.where(valid, t, 0.0)))

        sb = jnp.maximum(si, 0) * SPH_W
        cen = (sph_ref[sb], sph_ref[sb + 1], sph_ref[sb + 2])
        n_sph = _normalize(_sub(p, cen))
        m_sph = sph_ref[sb + 4]

        tb = jnp.maximum(ti, 0) * TRI_W
        _, beta, gamma, _ = tri_bary(tb, o, d)
        w0 = 1.0 - beta - gamma
        vn = [(tri_ref[tb + 12 + 3 * k], tri_ref[tb + 13 + 3 * k],
               tri_ref[tb + 14 + 3 * k]) for k in range(3)]
        n_tri = _normalize(_add(_add(_scale(vn[0], w0), _scale(vn[1], beta)),
                                _scale(vn[2], gamma)))
        m_tri = tri_ref[tb + 21]

        n = _where(valid, _where(is_tri, n_tri, n_sph), (0.0, 0.0, 0.0))
        p = _where(valid, p, (0.0, 0.0, 0.0))
        mat = jnp.where(valid, jnp.where(is_tri, m_tri, m_sph), -1.0)
        mat = mat.astype(jnp.int32)
        return t, mat >= 0, p, n, mat

    def occluded(o, d, mint, maxt, alive):
        """Any hit in [mint, maxt]."""
        def any_hit(hit_t):
            return lambda i, occ: occ | (hit_t(i, o, d, mint, maxt) < INF)

        occ = jnp.zeros((BLOCK,), jnp.bool_)
        occ = jax.lax.fori_loop(0, n_s, any_hit(sphere_t), occ)
        occ = jax.lax.fori_loop(0, n_t, any_hit(tri_t), occ)
        return occ & alive

    def albedo(mat):
        mb = jnp.maximum(mat, 0) * MAT_W
        ok = mat >= 0
        return tuple(jnp.where(ok, mat_ref[mb + k], 0.0) for k in range(3))

    def light(li):
        b = li * LIG_W
        g = lambda k: (lig_ref[b + k], lig_ref[b + k + 1],  # noqa: E731
                       lig_ref[b + k + 2])
        return dict(pos=g(0), nrm=g(3), irr=g(6), irr_emit=g(9),
                    radius=lig_ref[b + 12], area=lig_ref[b + 13],
                    t_ax=g(14), b_ax=g(17))

    # ---- one pass ---------------------------------------------------------

    def shadow(L, u0, u1, valid, p, n):
        """Sample light ``L``'s disk; (direction, occluded) of the shadow
        ray from p (stages.nee_shade / direct._direct_pass_acc)."""
        x, y = _concentric(u0, u1)
        x, y = x * L["radius"], y * L["radius"]
        target = _add(L["pos"], _add(_scale(L["t_ax"], x),
                                     _scale(L["b_ax"], y)))
        origin = _add(p, _scale(n, eps))
        delta = _sub(target, origin)
        d2 = _dot(delta, delta)
        dist = jnp.where(d2 > 0.0, jnp.sqrt(jnp.where(d2 > 0.0, d2, 1.0)),
                         0.0)
        sdir = _normalize(delta)
        smin = jnp.where(valid, 0.0, INF)
        smax = jnp.where(valid, dist, INF)
        return sdir, occluded(origin, sdir, smin, smax, smin != smax)

    def one_pass(p_idx, acc):
        if c["parity"]:
            def draw(slot):
                return u_ref[2 * slot, :], u_ref[2 * slot + 1, :]
        else:
            base = _mix(_mix(_mix(k0 + (pass0 + p_idx).astype(jnp.uint32)
                                  * jnp.uint32(0x9E3779B9)) ^ k1)
                        ^ gid.astype(jnp.uint32))

            def draw(slot):
                salt = 2 * jnp.asarray(slot, jnp.int32).astype(jnp.uint32)
                return (_uniform(_mix(base ^ _mix(salt + jnp.uint32(1)))),
                        _uniform(_mix(base ^ _mix(salt + jnp.uint32(2)))))

        spp, W = c["spp"], c["width"]
        pix = gid // spp
        row = (pix // W).astype(jnp.float32)
        col = (pix % W).astype(jnp.float32)
        eye = (par_ref[0], par_ref[1], par_ref[2])
        U = (par_ref[3], par_ref[4], par_ref[5])
        V = (par_ref[6], par_ref[7], par_ref[8])
        Wv = (par_ref[9], par_ref[10], par_ref[11])
        film_w, film_h = par_ref[12], par_ref[13]
        focal, lens_r = par_ref[14], par_ref[15]
        pmin = (par_ref[16], par_ref[17], par_ref[18])
        pmax = (par_ref[19], par_ref[20], par_ref[21])

        # primary ray (render/camera.generate_primary_rays)
        su = (-0.5 + (col + 0.5) / W) * film_w
        sv = (0.5 - (row + 0.5) / c["height"]) * film_h
        d0 = _normalize(_sub(_add(_scale(U, su), _scale(V, sv)), Wv))
        pip = _sub(eye, _scale(Wv, focal))
        dplane = -_dot(pip, Wv)
        tf = -(_dot(eye, Wv) + dplane) / _dot(d0, Wv)
        fp = _add(eye, _scale(d0, tf))
        if spp > 1:
            k = int(round(spp ** 0.5))
            s_ = gid % spp
            lu = ((s_ % k).astype(jnp.float32) + 0.5) * (1.0 / k)
            lv = ((s_ // k).astype(jnp.float32) + 0.5) * (1.0 / k)
        else:
            lu, lv = draw(0)
        dx, dy = _concentric(lu, lv)
        o = _add(eye, _add(_scale(U, dx * lens_r), _scale(V, dy * lens_r)))
        d = _normalize(_sub(fp, o))
        # clip to the scene bounds (aabb_window)
        tn, tx = jnp.zeros((BLOCK,)), jnp.full((BLOCK,), INF)
        for ax in range(3):
            sd = jnp.where(d[ax] == 0.0, 1e-30, d[ax])
            t0 = (pmin[ax] - o[ax]) / sd
            t1 = (pmax[ax] - o[ax]) / sd
            tn = jnp.maximum(tn, jnp.minimum(t0, t1))
            tx = jnp.minimum(tx, jnp.maximum(t0, t1))
        ok = tn <= tx
        mint = jnp.where(ok, tn, INF)
        maxt = jnp.where(ok, tx, INF)
        alive = mint != maxt

        t, valid, p, n, mat = trace(o, d, mint, maxt, alive)
        maxt = jnp.where(valid, t, maxt)

        if c["mode"] == "direct":
            alb = albedo(mat)
            for li in range(n_l):
                sdir, occ = shadow(light(li), *draw(1 + li), valid, p, n)
                cosx = jnp.clip(_dot(sdir, n), 0.0, 1.0)
                sh = jnp.clip(c["ambient"] + jnp.where(occ, 0.0, cosx),
                              0.0, 1.0)
                acc = tuple(a + jnp.where(valid, al * sh, 0.0)
                            for a, al in zip(acc, alb))
            return acc

        # emitter credit, primary segment only (stages.light_render)
        for li in range(n_l):
            L = light(li)
            den = _dot(d, L["nrm"])
            num = _dot(_sub(L["pos"], o), L["nrm"])
            tl = num / jnp.where(den == 0.0, 1.0, den)
            q = _sub(_add(o, _scale(d, tl)), L["pos"])
            on = _dot(q, q) <= L["radius"] * L["radius"]
            tl = jnp.where((den != 0.0) & (num != 0.0) & on, tl, INF)
            hit = alive & (tl < INF) & (tl >= mint) & (tl < maxt)
            acc = tuple(a + jnp.where(hit, e, 0.0)
                        for a, e in zip(acc, L["irr_emit"]))
            valid = valid & ~hit
            mat = jnp.where(hit, -1, mat)

        def nee(acc, tp, slot, valid, p, n, mat):
            """stages.nee_shade for every light: pre-update throughput,
            then throughput *= albedo per light."""
            alb = albedo(mat)
            for li in range(n_l):
                L = light(li)
                sdir, occ = shadow(L, *draw(slot + li), valid, p, n)
                pc = _sub(p, L["pos"])
                r2 = _dot(pc, pc)
                cosx = jnp.clip(_dot(sdir, n), 0.0, 1.0)
                cosy = jnp.clip(-_dot(sdir, L["nrm"]), 0.0, 1.0)
                geom = L["area"] * cosx * cosy / jnp.maximum(r2, 1e-20)
                free = valid & ~occ
                acc = tuple(
                    a + jnp.where(free, t_ * al * geom * ir, 0.0)
                    for a, t_, al, ir in zip(acc, tp, alb, L["irr"]))
                tp = tuple(jnp.where(valid, t_ * al, t_)
                           for t_, al in zip(tp, alb))
            return acc, tp

        tp = (jnp.ones((BLOCK,)),) * 3
        acc, tp = nee(acc, tp, 1, valid, p, n, mat)
        per_depth = (1 if c["rr"] else 0) + 1 + n_l

        def bounce(depth, carry):
            """[RR], bounce ray, trace, NEE (pathtracer._render_pass)."""
            acc, tp, valid, p, n, mat = carry
            slot = 1 + n_l + (depth - 1) * per_depth
            if c["rr"]:
                u0, _ = draw(slot)
                ps = jnp.clip(jnp.maximum(tp[0], jnp.maximum(tp[1], tp[2])),
                              0.05, 1.0)
                apply = depth - 1 >= c["rr_start"]
                live = ~apply | (u0 < ps)
                tp = tuple(jnp.where(apply, jnp.where(live, t_ / ps, 0.0), t_)
                           for t_ in tp)
                valid = valid & live
                mat = jnp.where(live, mat, -1)
                slot = slot + 1
            u0, u1 = draw(slot)
            sn = _where(valid, n, (0.0, 0.0, 1.0))
            ta, ba = _tangent_frame(sn)
            x, y = _concentric(u0, u1)
            z = jnp.sqrt(jnp.maximum(0.0, 1.0 - x * x - y * y))
            d = _normalize(_add(_add(_scale(ta, x), _scale(ba, y)),
                                _scale(sn, z)))
            o = _add(p, _scale(n, eps))
            mint = jnp.where(valid, 0.0, INF)
            maxt = jnp.full((BLOCK,), INF)
            _, valid, p, n, mat = trace(o, d, mint, maxt, mint != maxt)
            acc, tp = nee(acc, tp, slot + 1, valid, p, n, mat)
            return acc, tp, valid, p, n, mat

        acc = jax.lax.fori_loop(1, bounces + 1, bounce,
                                (acc, tp, valid, p, n, mat))[0]
        return acc

    acc = (acc_r[...], acc_g[...], acc_b[...])
    acc = jax.lax.fori_loop(0, n_passes, one_pass, acc)
    out_r[...] = acc[0]
    out_g[...] = acc[1]
    out_b[...] = acc[2]


def _call(scene: Scene, cfg: RenderConfig, acc: Array, key_words: Array,
          pass0, n_passes: int, mode: str, u_planes: Array | None,
          ray_offset, interpret: bool) -> Array:
    """Run the kernel over ``acc`` (R, 3); returns the new (R, 3)."""
    assert covers(scene, cfg), "fused kernel: scene outside its scope"
    assert u_planes is None or n_passes == 1
    from ...render.stages import _all_triangles
    R = acc.shape[0]
    R_pad = -(-R // BLOCK) * BLOCK
    par, sph, tri, mat, lig = scene_tables(scene, cfg)
    i32 = partial(jnp.asarray, dtype=jnp.int32)
    ipar = jnp.stack([
        key_words[0].astype(jnp.int32), key_words[1].astype(jnp.int32),
        i32(ray_offset), i32(pass0), i32(scene.spheres.count),
        i32(_all_triangles(scene).count), i32(cfg.bounces), i32(n_passes)])
    planes = [jnp.pad(acc[:, k], (0, R_pad - R)) for k in range(3)]
    c = dict(n_l=scene.lights.count, spp=cfg.spp, width=cfg.width,
             height=cfg.height, mode=mode,
             shadow_eps=float(cfg.shadow_eps), ambient=float(cfg.ambient),
             rr=bool(cfg.russian_roulette), rr_start=cfg.rr_start_depth,
             two_sided=bool(cfg.two_sided_triangles),
             parity=u_planes is not None)

    def full(x):
        return pl.BlockSpec(x.shape, lambda i: (0,) * x.ndim)

    ray_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    ins = [ipar, par, sph, tri, mat, lig] + planes
    specs = [full(x) for x in ins[:6]] + [ray_spec] * 3
    if u_planes is not None:
        rows = _pow2(u_planes.shape[0], least=2)
        up = jnp.pad(u_planes.astype(jnp.float32),
                     ((0, rows - u_planes.shape[0]), (0, R_pad - R)))
        ins.append(up)
        specs.append(pl.BlockSpec((rows, BLOCK), lambda i: (0, i)))
    out = pl.pallas_call(
        partial(_kernel, c=c),
        out_shape=[jax.ShapeDtypeStruct((R_pad,), jnp.float32)] * 3,
        grid=(R_pad // BLOCK,),
        in_specs=specs,
        out_specs=[ray_spec] * 3,
        input_output_aliases={6: 0, 7: 1, 8: 2},
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name=f"fused_{mode}_pass",
    )(*ins)
    return jnp.stack(out, -1)[:R]


def render_passes(scene: Scene, state: dict, cfg: RenderConfig,
                  n_passes: int, u_planes: Array | None = None,
                  ray_offset=0, interpret: bool = False) -> dict:
    """Progressive path-tracing passes; same state contract as
    pathtracer.render_passes. Under shard_map, ``state['acc']`` is the
    local slice and ``ray_offset`` its first global ray id."""
    acc = _call(scene, cfg, state["acc"], jax.random.key_data(state["key"]),
                state["passes"], n_passes, "path", u_planes, ray_offset,
                interpret)
    return {"acc": acc, "key": state["key"],
            "passes": state["passes"] + n_passes}


def render_direct(scene: Scene, cfg: RenderConfig, key=None,
                  n_passes: int = 1, u_planes: Array | None = None,
                  interpret: bool = False) -> Array:
    """Direct-lighting image (render/direct.py semantics)."""
    if key is None:
        key = rng.base_key(cfg.seed)
    acc = _call(scene, cfg, jnp.zeros((cfg.total_rays, 3), jnp.float32),
                jax.random.key_data(key), 0, n_passes, "direct", u_planes,
                0, interpret)
    n_lights = max(scene.lights.count, 1)
    img = acc.reshape(cfg.height, cfg.width, cfg.spp, 3).mean(2) \
        / (n_lights * n_passes)
    return jnp.clip(img, 0.0, 1.0)


def u_planes_for_pass(key: Array, passes: Array, cfg: RenderConfig,
                      n_lights: int) -> Array:
    """The XLA pipeline's pass-wide draws (pathtracer._render_pass) in the
    kernel's (2 * n_draws, R) plane layout."""
    from ...render.pathtracer import pass_draw_count
    n_draws = pass_draw_count(cfg, n_lights)
    u_all = jax.random.uniform(rng.pass_key(key, passes),
                               (cfg.total_rays, n_draws, 2))
    return u_all.transpose(1, 2, 0).reshape(n_draws * 2, cfg.total_rays)


def u_planes_for_direct(key: Array, cfg: RenderConfig,
                        n_lights: int) -> Array:
    """render/direct.py's draws for one pass with ``key``: the lens pair
    (spp 1), then one pair per light."""
    R = cfg.total_rays
    lens = jax.random.uniform(rng.draw_key(key, rng.LENS), (R, 2)) \
        if cfg.spp == 1 else jnp.zeros((R, 2))
    rows = [lens[:, 0], lens[:, 1]]
    for li in range(n_lights):
        u = rng.uniform2(rng.draw_key(key, rng.LIGHT, 0, li), R)
        rows += [u[:, 0], u[:, 1]]
    return jnp.stack(rows)
