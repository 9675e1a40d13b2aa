"""Benchmark: rays/s on the flagship progressive path tracer.

Prints the device on an earlier line, then ONE JSON line: {"metric",
"value", "unit", "device"}.

Metric definition: traced ray *segments* per second per device on the
Assign10-analog cornell scene. Segments/pass = primary + per-light
(emitter test is free) shadow + bounces * (1 closest + n_lights shadow),
matching how the reference's wavefront issues work (SURVEY §3.4). Under
Russian roulette the count is nominal (issued segments).

Names the device it ran on before the results and in every result.

Env knobs: BENCH_WIDTH/HEIGHT/PASSES/REPS/BOUNCES/SCENE, BENCH_MODE=train
(fwd+bwd through XLA's AD of the stage pipeline), BENCH_RR=1 (Russian
roulette termination), BENCH_FULL=1 (config 5 EXACTLY as BASELINE.json
specifies: 1024 progressive samples/pixel with RR, one number for the whole
render; combine with BENCH_MODE=train for the full spec INCLUDING the
backward pass every progressive step), BENCH_CONFIG=1..5 (the five
BASELINE.json configs: 1 fake-shade sphere, 2 direct lighting + shadows,
3 mesh+grid, 4 thin lens spp4, 5 path tracing — default), BENCH_GRID=1 and
BENCH_NSLABS (uniform grids for the main scene), BENCH_NSPHERES
(molecule-scale sphere count for BENCH_SCENE=spheres)."""
from __future__ import annotations

import json
import os
import subprocess
import time


def _device() -> dict:
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _print_device() -> None:
    dev = _device()
    card = "not an NVIDIA GPU"
    if dev["platform"] == "gpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {dev['platform']} {dev['kind']} x{dev['count']}; "
          f"card: {card}", flush=True)


def _result(metric: str, value: float) -> None:
    print(json.dumps({"metric": metric, "value": value,
                      "unit": "ray_segments/s/device",
                      "device": _device()}))


def main() -> None:
    import jax

    from raytracing_tpu import RenderConfig
    from raytracing_tpu.models.scenes import cornell_box, sphere_field
    from raytracing_tpu.render import pathtracer
    from raytracing_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    _print_device()

    width = int(os.environ.get("BENCH_WIDTH", "1024"))
    height = int(os.environ.get("BENCH_HEIGHT", "1024"))
    # 16 passes per jit call = steady-state progressive throughput
    passes = int(os.environ.get("BENCH_PASSES", "16"))
    mode = os.environ.get("BENCH_MODE", "forward")   # forward | train
    scene_name = os.environ.get("BENCH_SCENE", "cornell")
    bounces = int(os.environ.get("BENCH_BOUNCES", "5"))
    rr = os.environ.get("BENCH_RR", "0") == "1" \
        or os.environ.get("BENCH_FULL", "0") == "1"
    use_grid = os.environ.get("BENCH_GRID", "0") == "1"
    cfg = RenderConfig(width=width, height=height, spp=1, bounces=bounces,
                       russian_roulette=rr, rr_start_depth=2,
                       use_grid=use_grid)
    if scene_name == "spheres":
        scene = sphere_field(int(os.environ.get("BENCH_NSPHERES", "1024")),
                             cols=width, rows=height)
    elif scene_name in ("house", "teapot"):
        from raytracing_tpu.models.scenes import big_mesh_scene
        scene = big_mesh_scene(
            "teapot.json" if scene_name == "teapot" else
            "house_of_parliament.json", cols=width, rows=height)
    else:
        scene = cornell_box(cols=width, rows=height)
    if use_grid:
        from raytracing_tpu.accel import prepare_grids
        ns = os.environ.get("BENCH_NSLABS", "auto")
        scene = prepare_grids(scene, ns if ns == "auto" else int(ns),
                              mesh_slabs="auto")

    bench_config = int(os.environ.get("BENCH_CONFIG", "5"))
    if bench_config != 5:
        _config_bench(jax, bench_config, width, height)
        return

    if os.environ.get("BENCH_FULL", "0") == "1" and mode == "train":
        _full_train_bench(jax, scene, cfg)
        return

    if os.environ.get("BENCH_FULL", "0") == "1":
        _full_render_bench(jax, scene, cfg)
        return

    if mode == "train":
        _train_bench(jax, scene, cfg, passes)
        return

    state = pathtracer.init_state(cfg)
    # warm-up / compile the SAME n_passes program (n_passes is static)
    state = jax.block_until_ready(
        pathtracer.render_passes(scene, state, cfg, passes))

    t0 = time.perf_counter()
    reps = int(os.environ.get("BENCH_REPS", "5"))
    for _ in range(reps):
        state = pathtracer.render_passes(scene, state, cfg, passes)
    jax.block_until_ready(state)
    dt = time.perf_counter() - t0

    n_lights = scene.lights.count
    rays_per_pass = cfg.total_rays * (1 + n_lights + bounces * (1 + n_lights))
    _result("pathtrace_rays_per_s", rays_per_pass * passes * reps / dt)


def _config_bench(jax, config: int, width: int, height: int) -> None:
    """BASELINE.json configs 1-4 (config 5, path tracing, is the default
    main() path). Metric: primary rays/s for single-dispatch pipelines."""
    from raytracing_tpu import RenderConfig
    from raytracing_tpu.models import assignments as A

    kw = {}
    if config == 1:
        # steady state = the reference's rotate ANIMATION (Assign02
        # code.js:55-98): a full orbit as one jitted lax.scan — a single
        # frame is one sub-ms dispatch and measures only launch overhead
        from raytracing_tpu.render.simple import render_fake_shade_orbit
        _, (cam, spheres, colors), cfg = A.assign01(width, height)
        frames = int(os.environ.get("BENCH_PASSES", "16"))
        bounds = spheres.bounds()

        def render(cam, spheres, colors):
            return render_fake_shade_orbit(cam, spheres, colors, bounds,
                                           n_frames=frames)

        args = (cam, spheres, colors)
        name, work = "fake_shade_sphere", width * height * frames
    elif config == 2:
        render, args, cfg = A.assign08(width, height)
        # primary + per-light shadow segment; progressive accumulation
        # (fresh light-disk samples per pass -> converging soft shadows)
        # inside one jit call = steady-state, like config 5
        kw["n_passes"] = int(os.environ.get("BENCH_PASSES", "16"))
        name, work = "direct_lighting", None
    elif config == 3:
        # the reference's flagship grid workload: cornell walls + 992-tri
        # teapot mesh instance (uniform grid); steady-state progressive
        # accumulation like config 2 (all passes in one jit call)
        xml = os.path.join(A.REF_ROOT,
                           "Assign10-Path_Tracing/scenes/cornell_teapot.xml")
        if not os.path.exists(xml):
            raise SystemExit(
                f"BENCH_CONFIG=3 needs the reference's cornell_teapot.xml "
                f"at {xml} (set RT_REFERENCE_DIR)")
        render, args, cfg = A.assign07(
            width, height, n_slabs=int(os.environ.get("BENCH_NSLABS", "3")),
            scene_xml=xml, mesh_slabs="auto")
        kw["n_passes"] = int(os.environ.get("BENCH_PASSES", "16"))
        name, work = "mesh_grid_dda", None
    elif config == 4:
        render, args, cfg = A.assign09(width, height, spp=4)
        kw["n_passes"] = int(os.environ.get("BENCH_PASSES", "16"))
        name, work = "thin_lens_spp4", None
    else:
        raise SystemExit(f"BENCH_CONFIG must be 1..5, got {config}")
    if work is None:
        scene = args[0]
        work = cfg.total_rays * (1 + scene.lights.count) \
            * kw.get("n_passes", 1)

    jax.block_until_ready(render(*args, **kw))
    reps = int(os.environ.get("BENCH_REPS", "10"))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = render(*args, **kw)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    _result(f"config{config}_{name}_rays_per_s", work / dt)


def _full_render_bench(jax, scene, cfg) -> None:
    """BASELINE.json config 5 EXACTLY as written: 1024x1024, 1024
    progressive samples/pixel (1024 passes at spp=1), Russian roulette
    termination. One JSON line for the complete converged render. Segment
    accounting is nominal (issued wavefront segments; RR kills make real
    work smaller)."""
    from raytracing_tpu.render import pathtracer

    spp_total = int(os.environ.get("BENCH_SPP_TOTAL", "1024"))
    chunk = int(os.environ.get("BENCH_PASSES", "64"))
    state = pathtracer.init_state(cfg)
    # compile once at the steady chunk size
    jax.block_until_ready(pathtracer.render_passes(scene, state, cfg, chunk))
    state = pathtracer.init_state(cfg)
    done = 0
    t0 = time.perf_counter()
    while done < spp_total:
        n = min(chunk, spp_total - done)
        state = pathtracer.render_passes(scene, state, cfg,
                                         chunk if n == chunk else n)
        done += n
    jax.block_until_ready(state)
    dt = time.perf_counter() - t0
    n_lights = scene.lights.count
    segs = cfg.total_rays * (1 + n_lights + cfg.bounces * (1 + n_lights))
    _result("config5_full_1024spp_rr_rays_per_s", segs * spp_total / dt)


def _full_train_bench(jax, scene, cfg) -> None:
    """BASELINE.json config 5 WITH TRAINING, exactly as specified: 1024
    progressive samples/pixel, Russian roulette termination, forward +
    backward (grads wrt sphere geometry + materials) EVERY pass,
    progressive state threaded between steps. One JSON line for the whole
    run; asserts the final grads are finite and nonzero.
    (BENCH_MODE=train BENCH_FULL=1.)"""
    import dataclasses

    import jax.numpy as jnp

    from raytracing_tpu.render import pathtracer

    spp_total = int(os.environ.get("BENCH_SPP_TOTAL", "1024"))

    def loss(params, state):
        spheres = dataclasses.replace(scene.spheres,
                                      center=params["center"],
                                      radius=params["radius"])
        sc = dataclasses.replace(scene, spheres=spheres,
                                 materials=params["materials"])
        st = pathtracer._render_pass(sc, state, cfg)
        img = pathtracer.image(st, cfg)
        return jnp.mean(img ** 2), st

    step = jax.jit(jax.value_and_grad(loss, has_aux=True))
    params = {"center": scene.spheres.center, "radius": scene.spheres.radius,
              "materials": scene.materials}
    state = pathtracer.init_state(cfg)
    jax.block_until_ready(step(params, state))          # compile
    t0 = time.perf_counter()
    for _ in range(spp_total):
        (l, state), grads = step(params, state)
    jax.block_until_ready((state, grads))
    dt = time.perf_counter() - t0
    g0 = float(abs(grads["center"]).sum()) + float(abs(grads["materials"]).sum())
    assert g0 > 0 and jax.numpy.isfinite(l), "full-train grads degenerate"
    n_lights = scene.lights.count
    segs = cfg.total_rays * (1 + n_lights + cfg.bounces * (1 + n_lights))
    _result("config5_full_train_1024spp_rr_rays_per_s", segs * spp_total / dt)


def _train_bench(jax, scene, cfg, iters: int) -> None:
    """Forward + backward rays/s: the BASELINE.json metric. One progressive
    pass + L2 image loss + grads wrt sphere geometry and materials."""
    import dataclasses

    import jax.numpy as jnp

    from raytracing_tpu.render import pathtracer

    def loss(params, state):
        spheres = dataclasses.replace(scene.spheres,
                                      center=params["center"],
                                      radius=params["radius"])
        sc = dataclasses.replace(scene, spheres=spheres,
                                 materials=params["materials"])
        st = pathtracer._render_pass(sc, state, cfg)
        img = pathtracer.image(st, cfg)
        return jnp.mean(img ** 2), st

    step = jax.jit(jax.value_and_grad(loss, has_aux=True))
    params = {"center": scene.spheres.center, "radius": scene.spheres.radius,
              "materials": scene.materials}
    state = pathtracer.init_state(cfg)
    (_, state), grads = jax.block_until_ready(step(params, state))
    t0 = time.perf_counter()
    for _ in range(iters):
        (_, state), grads = step(params, state)
    jax.block_until_ready(grads)
    dt = time.perf_counter() - t0

    n_lights = scene.lights.count
    rays = cfg.total_rays * (1 + n_lights + cfg.bounces * (1 + n_lights))
    _result("pathtrace_fwd_bwd_rays_per_s", rays * iters / dt)


if __name__ == "__main__":
    main()
