#!/usr/bin/env python3
"""Time the fused kernel against the XLA pipeline across scene sizes, the
measurement behind render/route.py's choice for large tables.

    python scripts/route_sweep.py [--size 1024] [--passes 2]
                                  [--spheres 64,128,512,2048] [--grid 16]

GPU only. Each ``sphere_field(n)`` scene renders at size², spp 1, 5
bounces, through the fused kernel and the XLA brute-force pipeline, in
turns (fused, XLA, XLA, fused); with ``--grid N`` the XLA pipeline over an
N³ uniform grid runs too. Prints the card, then per scene the median ms/pass of each
implementation (median of 5 calls after a compile call) and their image
means.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def median_call(fn, reps=5):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return out, first, sorted(times)[reps // 2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--spheres", default="64,128,512,2048")
    ap.add_argument("--grid", type=int, default=16)
    args = ap.parse_args()

    import jax
    import numpy as np
    if jax.devices()[0].platform != "gpu":
        print("route_sweep: needs a GPU", file=sys.stderr)
        return 2
    from raytracing_tpu import RenderConfig
    from raytracing_tpu.accel import prepare_grids
    from raytracing_tpu.models.scenes import sphere_field
    from raytracing_tpu.ops.pallas import fused_pass
    from raytracing_tpu.render import pathtracer
    from raytracing_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)

    S, K = args.size, args.passes
    sizes = [int(x) for x in args.spheres.split(",")]
    cfg = RenderConfig(width=S, height=S, spp=1, bounces=5)
    fused = jax.jit(lambda sc, st: fused_pass.render_passes(sc, st, cfg, K))
    for n in sizes:
        scene = sphere_field(n, cols=S, rows=S)
        runs = {
            "fused": lambda sc=scene: fused(sc, pathtracer.init_state(cfg)),
            "xla": lambda sc=scene: pathtracer.render_passes_xla(
                sc, pathtracer.init_state(cfg), cfg, K),
        }
        order = ["fused", "xla", "xla", "fused"]
        if args.grid:
            gcfg = dataclasses.replace(cfg, use_grid=True,
                                       n_slabs=args.grid)
            gscene = prepare_grids(scene, args.grid)
            runs["xla_grid"] = lambda: pathtracer.render_passes_xla(
                gscene, pathtracer.init_state(gcfg), gcfg, K)
            order.append("xla_grid")
        best, means, firsts = {}, {}, {}
        for name in order:
            out, first, med = median_call(runs[name])
            best[name] = min(best.get(name, med), med)
            firsts.setdefault(name, first)
            means[name] = float(np.asarray(pathtracer.image(out, cfg)).mean())
        print(f"[sweep] sphere_field({n}) {S}^2 b5: " + "; ".join(
            f"{k} {best[k] / K * 1e3:.4f} ms/pass (first call "
            f"{firsts[k]:.2f} s, image mean {means[k]:.5f})" for k in best)
            + f"; fused / xla {best['fused'] / best['xla']:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
