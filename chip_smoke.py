#!/usr/bin/env python3
"""Smoke test of the path tracer on a GPU: the main path at full size,
every route it takes, and each compared with its reference.

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # the sharded path on four cards

One process. Exits non-zero, and prints no result, when JAX finds no GPU
or any phase fails. Earlier lines report compile and steady seconds per
phase, segments/s, parity numbers and peak memory; the last line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
tests/test_chip_smoke.py runs the same phases at toy sizes on the CPU.

Parity tolerances (their reasons are in PERF.md):
  * the fused kernel against the XLA pipeline on the card, same threefry
    draws: path 1024^2 b5 (spp 1, spp 4, RR) and direct (spp 1, spp 4);
  * gradients through the routed entry against the XLA entry's, 256^2 b5;
  * XLA route, GPU against CPU, same program and threefry draws:
    direct 1024^2 pixelwise, path 256^2 b5 mean and pixelwise, train-step
    gradients in relative L2;
  * primary hits against the float64 NumPy oracle (tests/oracle.py).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# GPU against CPU, XLA route (see PERF.md "Parity tolerances")
DIRECT_PIX_TOL = 1e-3       # a pixel "differs" past this
DIRECT_FRAC_MAX = 1e-3      # share of direct pixels allowed to differ
PATH_MEAN_REL_MAX = 5e-3    # path image mean, relative
PATH_FRAC_MAX = 2e-2        # share of path pixels allowed to differ
GRAD_REL_L2_MAX = 1e-2      # train-step gradients, per parameter group
# routed entry (fused on the card) against the XLA entry, differentiated
ROUTE_GRAD_REL_L2_MAX = 1e-3
# primary hits against the float64 oracle
ORACLE_ID_MISMATCH_MAX = 1e-4   # share of rays whose champion differs
ORACLE_T_REL_MAX = 1e-4         # |t - t64| / t64, 99.9th percentile
# four cards against one
SHARD_ACC_TOL = 1e-5        # accumulator, relative to its max
SHARD_GRAD_REL_L2_MAX = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip()


def timed(fn, *args, reps: int = 5):
    """(last output, first-call seconds incl. compile, median seconds)."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return out, first, times[len(times) // 2]


def segs_per_pass(cfg, n_lights: int) -> int:
    return cfg.total_rays * (1 + n_lights + cfg.bounces * (1 + n_lights))


def rel_l2(a, b) -> float:
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def peak_memory(dev) -> str:
    stats = dev.memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    return "not reported" if peak is None else f"{peak / 2**30:.3f} GiB"


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_forward(S, n_passes):
    """Progressive forward, cornell 1024^2 spp1 b5, n passes per call,
    through the routed entry point and through the XLA pipeline, timed in
    turns (routed, XLA, XLA, routed)."""
    import numpy as np
    from raytracing_tpu import RenderConfig
    from raytracing_tpu.models.scenes import cornell_box
    from raytracing_tpu.render import pathtracer, route

    cfg = RenderConfig(width=S, height=S, spp=1, bounces=5)
    scene = cornell_box(cols=S, rows=S)
    segs = segs_per_pass(cfg, scene.lights.count) * n_passes
    fns = {route.forward(scene, cfg): pathtracer.render_passes,
           route.XLA: pathtracer.render_passes_xla}
    names = list(fns)
    order = names + names[::-1] if len(names) == 2 else names
    meds = {k: [] for k in names}
    means = {}
    for name in order:
        state = {"s": pathtracer.init_state(cfg)}

        def call(fn=fns[name]):
            state["s"] = fn(scene, state["s"], cfg, n_passes)
            return state["s"]

        out, first, med = timed(call)
        img = np.asarray(pathtracer.image(out, cfg))
        check(img.shape == (S, S, 3) and np.isfinite(img).all(),
              f"forward {name} image not finite")
        check(0.02 < img.mean() < 0.98, f"forward {name} mean {img.mean()}")
        check(int(out["passes"]) == 6 * n_passes, "pass counter")
        meds[name].append(med)
        means[name] = float(img.mean())
        log(f"[forward] {name} {S}^2 b5 {n_passes} passes/call: first call "
            f"{first:.2f} s, median {med * 1e3:.3f} ms/call "
            f"({med / n_passes * 1e3:.4f} ms/pass), {segs / med:.4e} "
            f"segments/s, image mean {img.mean():.5f}")
    if len(names) == 2:
        fused, xla = (min(meds[k]) for k in names)
        mrel = abs(means[names[0]] - means[route.XLA]) / means[route.XLA]
        log(f"[forward] {names[0]} / xla time ratio {fused / xla:.4f}; "
            f"image means (hash vs threefry draws, {6 * n_passes} passes) "
            f"rel diff {mrel:.3e} (max {PATH_MEAN_REL_MAX:g})")
        check(mrel <= PATH_MEAN_REL_MAX, "fused/XLA image mean")


def phase_cli(S, n_passes):
    """The CLI in-process, writing a PNG."""
    from raytracing_tpu.cli import main
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cornell.png")
        t0 = time.perf_counter()
        rc = main(["--scene", "cornell", "--width", str(S), "--height",
                   str(S), "--passes", str(n_passes), "--chunk-passes",
                   str(n_passes), "-o", out])
        dt = time.perf_counter() - t0
        check(rc == 0, f"cli rc {rc}")
        with open(out, "rb") as f:
            head = f.read(8)
        check(head == b"\x89PNG\r\n\x1a\n", "cli png header")
        size = os.path.getsize(out)
    log(f"\n[cli] {S}^2 {n_passes} passes -> PNG {size} bytes in "
        f"{dt:.2f} s (compile included)")


def phase_direct(S, n_passes):
    """Direct lighting spp1, and thin lens spp4 (lens_radius > 0)."""
    import numpy as np
    from raytracing_tpu import RenderConfig
    from raytracing_tpu.models.scenes import cornell_box
    from raytracing_tpu.render import route
    from raytracing_tpu.render.direct import render_direct

    for spp, lens in ((1, 0.0), (4, 0.25)):
        cfg = RenderConfig(width=S, height=S, spp=spp, bounces=0)
        scene = cornell_box(cols=S, rows=S, lens_diameter=lens)
        img, first, med = timed(
            lambda: render_direct(scene, cfg, n_passes=n_passes))
        img = np.asarray(img)
        check(np.isfinite(img).all() and 0.02 < img.mean() < 0.98,
              f"direct spp{spp} image mean {img.mean()}")
        rate = cfg.total_rays * (1 + scene.lights.count) * n_passes / med
        log(f"[direct] route={route.forward(scene, cfg)} {S}^2 spp{spp} "
            f"lens_diameter={lens} {n_passes} passes: first call "
            f"{first:.2f} s, median {med * 1e3:.2f} ms, {rate:.4e} "
            f"segments/s, mean {img.mean():.5f}")


def _train_setup(S, mesh):
    import jax.numpy as jnp
    from raytracing_tpu import RenderConfig
    from raytracing_tpu.models.scenes import cornell_box
    from raytracing_tpu.parallel import mesh as pm
    from raytracing_tpu.render import pathtracer

    cfg = RenderConfig(width=S, height=S, spp=1, bounces=5)
    scene = pm.replicate_scene(cornell_box(cols=S, rows=S), mesh)
    params = {"center": scene.spheres.center + 0.02,
              "radius": scene.spheres.radius,
              "materials": scene.materials}
    target = jnp.full((S, S, 3), 0.25)
    state = pm.shard_state(pathtracer.init_state(cfg), mesh)
    return cfg, scene, params, target, state, pm.make_train_step(mesh, cfg)


def phase_train(S, steps=3):
    """make_train_step on make_mesh(1): 3 SGD steps, grads wrt center,
    radius and materials."""
    import jax
    import numpy as np
    from raytracing_tpu.parallel import mesh as pm

    cfg, scene, params, target, state, step = _train_setup(S, pm.make_mesh(1))
    times = []
    for i in range(steps):
        t0 = time.perf_counter()
        (loss, state), grads = jax.block_until_ready(
            step(params, scene, state, target))
        times.append(time.perf_counter() - t0)
        for k, g in grads.items():
            check(np.isfinite(np.asarray(g)).all(), f"grad {k} not finite")
        gc = float(np.abs(np.asarray(grads["center"])).sum())
        check(gc > 0, "|grad center| is 0")
        check(np.isfinite(float(loss)), "loss not finite")
        params = jax.tree.map(lambda p, g: p - 1e-3 * g, params, grads)
        log(f"[train] step {i}: loss {float(loss):.6f} |grad center| "
            f"{gc:.6e} |grad materials| "
            f"{float(np.abs(np.asarray(grads['materials'])).sum()):.6e} "
            f"({times[-1]:.3f} s{', compile included' if i == 0 else ''})")
    rate = segs_per_pass(cfg, scene.lights.count) / min(times[1:])
    log(f"[train] {S}^2 b5 fwd+bwd: {min(times[1:]) * 1e3:.2f} ms/step, "
        f"{rate:.4e} segments/s")


def phase_grad_route(S, bounces=5):
    """jax.value_and_grad through the routed entry point (the fused kernel
    on the card) against the same through the XLA pipeline: the routed
    call's derivative is the XLA pipeline's, value included."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    import numpy as np
    from raytracing_tpu import RenderConfig
    from raytracing_tpu.models.scenes import cornell_box
    from raytracing_tpu.render import pathtracer, route

    cfg = RenderConfig(width=S, height=S, spp=1, bounces=bounces)
    scene = cornell_box(cols=S, rows=S)
    st = pathtracer.init_state(cfg)

    def loss(passes):
        def f(center, materials):
            sp = dataclasses.replace(scene.spheres, center=center)
            sc = dataclasses.replace(scene, spheres=sp, materials=materials)
            img = pathtracer.image(passes(sc, st, cfg, 2), cfg)
            return jnp.mean((img - 0.25) ** 2)
        return jax.jit(jax.value_and_grad(f, argnums=(0, 1)))

    args = (scene.spheres.center, scene.materials)
    (v_r, g_r), (v_x, g_x) = (
        jax.tree.map(np.asarray, loss(fn)(*args))
        for fn in (pathtracer.render_passes, pathtracer.render_passes_xla))
    errs = [rel_l2(a, b) for a, b in zip(g_r, g_x)]
    vrel = abs(float(v_r) - float(v_x)) / abs(float(v_x))
    log(f"[grad route] route={route.forward(scene, cfg)} {S}^2 "
        f"b{bounces}: loss rel diff {vrel:.3e}; grads rel L2 center "
        f"{errs[0]:.3e}, materials {errs[1]:.3e} "
        f"(max {ROUTE_GRAD_REL_L2_MAX:g})")
    check(all(np.isfinite(g).all() for g in g_r), "routed grads not finite")
    check(float(np.abs(g_r[0]).sum()) > 0, "routed |grad center| is 0")
    check(vrel <= ROUTE_GRAD_REL_L2_MAX
          and max(errs) <= ROUTE_GRAD_REL_L2_MAX, "routed grad parity")


def phase_parity_fused(S, interpret=False):
    """The fused kernel as compiled for the card against the XLA pipeline
    on the same card, fed identical threefry draws (u_planes).
    ``interpret`` is for the tests' toy-size run on the CPU."""
    import jax
    import numpy as np
    from raytracing_tpu import RenderConfig
    from raytracing_tpu.models.scenes import cornell_box
    from raytracing_tpu.ops.pallas import fused_pass
    from raytracing_tpu.render import pathtracer
    from raytracing_tpu.render.direct import render_direct_xla

    def compare(what, a, b, pix_frac_max):
        d = np.abs(a - b).max(-1)
        frac = float((d > DIRECT_PIX_TOL).mean())
        mrel = abs(float(a.mean()) - float(b.mean())) / float(b.mean())
        log(f"[parity fused] {what}: share of pixels off by > "
            f"{DIRECT_PIX_TOL:g}: {frac:.3e} (max {pix_frac_max:g}), mean "
            f"rel diff {mrel:.3e} (max {PATH_MEAN_REL_MAX:g})")
        check(frac <= pix_frac_max and mrel <= PATH_MEAN_REL_MAX,
              f"fused/XLA parity: {what}")

    for spp, rr in ((1, False), (4, False), (1, True)):
        cfg = RenderConfig(width=S, height=S, spp=spp, bounces=5,
                           russian_roulette=rr)
        scene = cornell_box(cols=S, rows=S,
                            lens_diameter=0.25 if spp > 1 else 0.0)
        st = pathtracer.init_state(cfg)
        u = fused_pass.u_planes_for_pass(st["key"], st["passes"], cfg,
                                         scene.lights.count)
        f = jax.jit(lambda sc, st, u: fused_pass.render_passes(
            sc, st, cfg, 1, u_planes=u, interpret=interpret)["acc"])
        a = np.asarray(f(scene, st, u))
        b = np.asarray(pathtracer.render_passes_xla(scene, st, cfg, 1)["acc"])
        compare(f"path {S}^2 b5 spp{spp}{' rr' if rr else ''}",
                a, b, PATH_FRAC_MAX)
    for spp in (1, 4):
        cfg = RenderConfig(width=S, height=S, spp=spp, bounces=0)
        scene = cornell_box(cols=S, rows=S,
                            lens_diameter=0.25 if spp > 1 else 0.0)
        key = jax.random.PRNGKey(cfg.seed)
        u = fused_pass.u_planes_for_direct(key, cfg, scene.lights.count)
        f = jax.jit(lambda sc, k, u: fused_pass.render_direct(
            sc, cfg, k, 1, u_planes=u, interpret=interpret))
        a = np.asarray(f(scene, key, u))
        b = np.asarray(render_direct_xla(scene, cfg, key, 1))
        compare(f"direct {S}^2 spp{spp}", a, b, DIRECT_FRAC_MAX)


def phase_parity_cpu(S_direct, S_path, S_train):
    """XLA route, same jitted programs on the CPU and on the GPU."""
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from raytracing_tpu import RenderConfig
    from raytracing_tpu.models.scenes import cornell_box
    from raytracing_tpu.parallel import mesh as pm
    from raytracing_tpu.render import pathtracer
    from raytracing_tpu.render.direct import render_direct_xla

    cpu = jax.devices("cpu")[0]
    gpu = jax.devices()[0]

    def on(dev, fn, *args):
        with jax.default_device(dev):
            return np.asarray(fn(*jax.device_put(args, dev)))

    cfg = RenderConfig(width=S_direct, height=S_direct, spp=1, bounces=0)
    scene = cornell_box(cols=S_direct, rows=S_direct)
    a = on(gpu, lambda s: render_direct_xla(s, cfg, None, 1), scene)
    b = on(cpu, lambda s: render_direct_xla(s, cfg, None, 1), scene)
    d = np.abs(a - b).max(-1)
    frac = float((d > DIRECT_PIX_TOL).mean())
    log(f"[parity cpu] direct {S_direct}^2: share of pixels off by > "
        f"{DIRECT_PIX_TOL:g}: {frac:.3e} (max {DIRECT_FRAC_MAX:g}), mean "
        f"|diff| {float(d.mean()):.3e}")
    check(frac <= DIRECT_FRAC_MAX, "direct GPU/CPU parity")

    cfg = RenderConfig(width=S_path, height=S_path, spp=1, bounces=5)
    scene = cornell_box(cols=S_path, rows=S_path)

    def path_img(s):
        st = pathtracer.render_passes_xla(s, pathtracer.init_state(cfg),
                                          cfg, 1)
        return pathtracer.image(st, cfg)

    a, b = on(gpu, path_img, scene), on(cpu, path_img, scene)
    d = np.abs(a - b).max(-1)
    frac = float((d > DIRECT_PIX_TOL).mean())
    mrel = abs(float(a.mean()) - float(b.mean())) / float(b.mean())
    log(f"[parity cpu] path {S_path}^2 b5: mean rel diff {mrel:.3e} (max "
        f"{PATH_MEAN_REL_MAX:g}), share of pixels off by > "
        f"{DIRECT_PIX_TOL:g}: {frac:.3e} (max {PATH_FRAC_MAX:g})")
    check(mrel <= PATH_MEAN_REL_MAX and frac <= PATH_FRAC_MAX,
          "path GPU/CPU parity")

    grads = {}
    for name, dev in (("gpu", gpu), ("cpu", cpu)):
        mesh = Mesh(np.asarray([dev]), ("rays",))
        _, scene, params, target, state, step = _train_setup(S_train, mesh)
        with jax.default_device(dev):
            (_, _), g = step(params, scene, state, target)
        grads[name] = jax.tree.map(np.asarray, g)
    errs = {k: rel_l2(grads["gpu"][k], grads["cpu"][k]) for k in grads["cpu"]}
    log(f"[parity cpu] train {S_train}^2 b5 grads rel L2: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (max {GRAD_REL_L2_MAX:g})")
    check(max(errs.values()) <= GRAD_REL_L2_MAX, "train GPU/CPU parity")


def phase_oracle(S):
    """Primary-hit champion ids and t through the gathers, against the
    float64 NumPy oracle."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import oracle
    from raytracing_tpu import RenderConfig, replace
    from raytracing_tpu.core import rng
    from raytracing_tpu.models.scenes import cornell_box
    from raytracing_tpu.ops.closest_hit import (closest_hit_spheres,
                                                closest_hit_triangles)
    from raytracing_tpu.render.camera import generate_primary_rays
    from raytracing_tpu.render.stages import _all_triangles

    cfg = RenderConfig(width=S, height=S)
    scene = cornell_box(cols=S, rows=S)

    @jax.jit
    def primary(scene):
        cam = replace(scene.camera, cols=S, rows=S)
        rays = generate_primary_rays(cam, scene.bounds, scene.focal_length,
                                     scene.lens_radius, 1,
                                     rng.draw_key(rng.base_key(7), rng.LENS))
        cs = closest_hit_spheres(rays, scene.spheres)
        ct = closest_hit_triangles(rays, _all_triangles(scene))
        tri = ct.valid & (ct.t < cs.t)
        idx = jnp.where(tri, scene.spheres.count + ct.idx, cs.idx)
        return rays, jnp.where(tri, ct.t, cs.t), idx

    rays, t, idx = jax.tree.map(np.asarray, primary(scene))
    tris = _all_triangles(scene)
    o, d = rays.o.astype(np.float64), rays.d.astype(np.float64)
    n = o.shape[0]
    t64 = np.empty(n)
    id64 = np.empty(n, np.int64)
    for a in range(0, n, 1 << 16):
        sl = slice(a, a + (1 << 16))
        ts = np.concatenate([
            oracle.sphere_ts_vec(o[sl], d[sl], rays.mint[sl], rays.maxt[sl],
                                 np.asarray(scene.spheres.center),
                                 np.asarray(scene.spheres.radius)),
            oracle.triangle_ts_vec(o[sl], d[sl], rays.mint[sl],
                                   rays.maxt[sl], np.asarray(tris.v))], 1)
        t64[sl] = ts.min(1)
        id64[sl] = np.where(np.isfinite(ts.min(1)), ts.argmin(1), -1)
    mism = float((id64 != idx).mean())
    both = (id64 == idx) & (id64 >= 0)
    trel = np.abs(t[both] - t64[both]) / t64[both]
    p999 = float(np.quantile(trel, 0.999))
    log(f"[oracle] primary hits {S}^2: champion mismatch share {mism:.3e} "
        f"(max {ORACLE_ID_MISMATCH_MAX:g}), t rel err median "
        f"{float(np.median(trel)):.3e} p99.9 {p999:.3e} (max "
        f"{ORACLE_T_REL_MAX:g}), {int(both.sum())} hits")
    check(both.mean() > 0.5, "too few primary hits")
    check(mism <= ORACLE_ID_MISMATCH_MAX, "oracle champion ids")
    check(p999 <= ORACLE_T_REL_MAX, "oracle hit distances")


def phase_four_cards(S, n_passes):
    """Sharded render and train step on a 4-card mesh against one card."""
    import jax
    import numpy as np
    from raytracing_tpu import RenderConfig
    from raytracing_tpu.models.scenes import cornell_box
    from raytracing_tpu.parallel import mesh as pm
    from raytracing_tpu.render import pathtracer

    m4 = pm.make_mesh(4)
    devs = list(m4.devices.flat)
    check(len({dv.id for dv in devs}) == 4, "mesh devices not distinct")
    check(len(jax.devices()) >= 4, "need four devices")

    cfg = RenderConfig(width=S, height=S, spp=1, bounces=5)
    scene = cornell_box(cols=S, rows=S)
    one = jax.block_until_ready(pathtracer.render_passes(
        scene, pathtracer.init_state(cfg), cfg, n_passes))
    render = pm.sharded_render_passes(m4, cfg, n_passes)
    sscene = pm.replicate_scene(scene, m4)
    st = {"s": pm.shard_state(pathtracer.init_state(cfg), m4)}

    def call():
        return render(sscene, st["s"])

    four, first, med = timed(call)
    shard_devs = {s.device.id for s in four["acc"].addressable_shards}
    check(shard_devs == {dv.id for dv in devs}, "acc not on 4 cards")
    a, b = np.asarray(four["acc"]), np.asarray(one["acc"])
    err = float(np.abs(a - b).max() / np.abs(b).max())
    rate = segs_per_pass(cfg, scene.lights.count) * n_passes / med
    log(f"[4 cards] sharded render {S}^2 b5 {n_passes} passes: shards on "
        f"devices {sorted(shard_devs)}; first call {first:.2f} s, median "
        f"{med * 1e3:.2f} ms, {rate:.4e} segments/s; max |acc4 - acc1| / "
        f"max|acc1| = {err:.3e} (max {SHARD_ACC_TOL:g})")
    check(err <= SHARD_ACC_TOL, "4-card render parity")

    out = {}
    for name, mesh in (("1", pm.make_mesh(1)), ("4", m4)):
        _, sc, params, target, state, step = _train_setup(S, mesh)
        jax.block_until_ready(step(params, sc, state, target))
        t0 = time.perf_counter()
        (loss, _), g = jax.block_until_ready(step(params, sc, state, target))
        dt = time.perf_counter() - t0
        out[name] = (float(loss), jax.tree.map(np.asarray, g), dt)
    errs = {k: rel_l2(out["4"][1][k], out["1"][1][k]) for k in out["1"][1]}
    lrel = abs(out["4"][0] - out["1"][0]) / abs(out["1"][0])
    log(f"[4 cards] train step {S}^2 b5: {out['4'][2] * 1e3:.2f} ms on 4 vs "
        f"{out['1'][2] * 1e3:.2f} ms on 1; loss rel diff {lrel:.3e}; grads "
        f"rel L2 " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (max {SHARD_GRAD_REL_L2_MAX:g})")
    check(lrel <= SHARD_GRAD_REL_L2_MAX
          and max(errs.values()) <= SHARD_GRAD_REL_L2_MAX,
          "4-card train parity")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded path and its "
                         "1-card comparison")
    args = ap.parse_args()

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {dev.platform})",
              file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from raytracing_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    log(f"card: {card_line()}")
    log(f"jax {jax.__version__}: {dev.platform} {dev.device_kind} "
        f"x{len(jax.devices())}")

    big, mid, passes = 1024, 256, 16
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards(big, passes)
    else:
        phase_forward(big, passes)
        phase_cli(big, passes)
        phase_direct(big, passes)
        phase_train(big)
        phase_grad_route(mid)
        phase_parity_fused(big)
        phase_parity_cpu(big, mid, mid)
        phase_oracle(big)
    log(f"peak memory on {dev.device_kind}: {peak_memory(dev)}; all phases "
        f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
