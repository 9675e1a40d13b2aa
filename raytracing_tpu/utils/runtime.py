"""Runtime / observability utilities (L2 analog).

The reference's runtime layer does device discovery, resource tracking and
an ABI struct-size negotiation (SURVEY §2.2: findWebCLDevices
code.js:466-505, cl_resources code.js:1539-1552, getStructSize
code.js:1064-1076). The JAX runtime replaces all of that; what remains
useful is surfaced here: device info, scene statistics/validation (the ABI
check analog — shape/dtype invariants), a timing harness and a profiler
trace context.
"""
from __future__ import annotations

import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import Scene


def device_info() -> list[dict]:
    return [{"id": d.id, "platform": d.platform, "kind": d.device_kind}
            for d in jax.devices()]


def scene_stats(scene: Scene) -> dict:
    """Scene census (the reference logs these at load, code.js:749-811)."""
    return {
        "spheres": scene.spheres.count,
        "triangles": scene.triangles.count,
        "meshes": len(scene.meshes),
        "mesh_triangles": sum(m.tris.count for m in scene.meshes),
        "lights": scene.lights.count,
        "materials": int(scene.materials.shape[0]),
    }


def validate_scene(scene: Scene) -> list[str]:
    """Shape/dtype invariants — the analog of the reference's struct-size
    ABI negotiation (layout errors fail loudly at build time, not render
    time). Returns a list of problems (empty = valid)."""
    issues = []

    def chk(cond, msg):
        if not cond:
            issues.append(msg)

    sp, tr = scene.spheres, scene.triangles
    chk(sp.center.shape == (sp.count, 3), "spheres.center shape")
    chk(sp.radius.shape == (sp.count,), "spheres.radius shape")
    chk(sp.mat_id.dtype == jnp.int32, "spheres.mat_id dtype")
    chk(tr.v.shape == (tr.count, 3, 3), "triangles.v shape")
    chk(tr.vn.shape == (tr.count, 3, 3), "triangles.vn shape")
    chk(scene.materials.ndim == 2 and scene.materials.shape[1] == 4,
        "materials must be (M, 4) rgba")
    n_mat = scene.materials.shape[0]
    for name, ids in (("spheres", sp.mat_id), ("triangles", tr.mat_id)):
        if ids.shape[0]:
            mx = int(jnp.max(ids))
            chk(mx < n_mat, f"{name} mat_id {mx} out of range (<{n_mat})")
    lg = scene.lights
    chk(lg.position.shape == (lg.count, 3), "lights.position shape")
    if lg.count:
        norms = np.linalg.norm(np.asarray(lg.normal), axis=-1)
        chk(bool(np.allclose(norms, 1.0, atol=1e-4)),
            "light normals must be unit length")
    for i, m in enumerate(scene.meshes):
        chk(m.tris.v.shape == (m.tris.count, 3, 3), f"mesh{i} tris shape")
    return issues


def timeit(fn: Callable, *args, iters: int = 5, warmup: int = 1) -> float:
    """Median-of-iters wall time in seconds; each call ends in
    ``jax.block_until_ready``."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def profile_trace(log_dir: str):
    """XLA profiler trace of the enclosed work (view with TensorBoard /
    xprof, or read with ``jax.profiler.ProfileData``). A profiler that
    cannot start or stop raises."""
    return jax.profiler.trace(log_dir)


class StageTimer:
    """Per-stage timing harness (SURVEY §5 tracing: the reference has only
    a live pass counter; this gives named stage timings + rays/s)."""

    def __init__(self):
        self.records: dict[str, list[float]] = {}

    def run(self, name: str, fn: Callable, *args):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        self.records.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    def summary(self) -> dict[str, float]:
        return {k: sorted(v)[len(v) // 2] for k, v in self.records.items()}
