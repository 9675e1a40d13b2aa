"""Scaling-efficiency harness (BASELINE.json: rays/s at 1 chip / 1 host /
N hosts, target >=90% to 2 hosts).

On real multi-device hardware this measures true scaling; on the virtual
CPU mesh it validates the *methodology* (weak/strong scaling bookkeeping,
sharding correctness) — virtual-device timings share one physical CPU so
the efficiency numbers are not meaningful there.
"""
from __future__ import annotations

import time

import jax

from ..core.config import RenderConfig
from ..core.types import Scene
from ..render import pathtracer
from . import mesh as pm


def measure_rays_per_s(scene: Scene, cfg: RenderConfig, n_devices: int,
                       n_passes: int = 4, reps: int = 3) -> float:
    m = pm.make_mesh(n_devices)
    sscene = pm.replicate_scene(scene, m)
    state = pm.shard_state(pathtracer.init_state(cfg), m)
    render = pm.sharded_render_passes(m, cfg, n_passes)
    state = render(sscene, state)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    for _ in range(reps):
        state = render(sscene, state)
    jax.block_until_ready(state)
    dt = time.perf_counter() - t0
    n_lights = scene.lights.count
    segs = cfg.total_rays * (1 + n_lights + cfg.bounces * (1 + n_lights))
    return segs * n_passes * reps / dt


def scaling_report(scene_fn, width: int, height: int,
                   device_counts=(1, 2, 4, 8), bounces: int = 3,
                   weak: bool = True) -> list[dict]:
    """Weak scaling: rays per device held constant (width scales with N).
    Strong scaling (weak=False): fixed total work."""
    rows = []
    base = None
    for n in device_counts:
        if n > len(jax.devices()):
            break
        w = width * n if weak else width
        cfg = RenderConfig(width=w, height=height, spp=1, bounces=bounces)
        scene = scene_fn(w, height)
        rps = measure_rays_per_s(scene, cfg, n)
        per_dev = rps / n
        if base is None:
            base = per_dev
        rows.append({"devices": n, "rays_per_s": rps,
                     "rays_per_s_per_device": per_dev,
                     "efficiency": per_dev / base})
    return rows


def main():
    from ..models.scenes import cornell_box
    rows = scaling_report(lambda w, h: cornell_box(cols=w, rows=h), 64, 64)
    for r in rows:
        print(f"devices={r['devices']}  rays/s={r['rays_per_s']:.3e}  "
              f"per-dev={r['rays_per_s_per_device']:.3e}  "
              f"eff={r['efficiency']:.2f}")


if __name__ == "__main__":
    main()
