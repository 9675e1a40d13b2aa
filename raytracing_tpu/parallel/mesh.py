"""Multi-chip sharding: ray-axis data parallelism + object-axis
"tensor parallelism" over a jax.sharding.Mesh.

The reference's only parallel axis is the NDRange over rays on one OpenCL
device (SURVEY §2.4). The scaling design (new, per BASELINE.json):

  * 'rays' axis  — shard the wavefront ray/accumulator buffers across
                   devices (the NDRange analog). Scene read-only state is
                   replicated, so the forward pass needs NO communication.
                   The mesh is 1-D: every device reaches every other at the
                   same rate, so it follows the algorithm alone.
  * 'obj' axis   — optionally shard the *object* axis: each device
                   intersects its object shard and champions are combined
                   with an all-gather + min-reduce (the ray-tracing analog
                   of TP).
  * gradients    — parameters (geometry/materials/camera) are replicated;
                   jit-with-shardings inserts the psum over 'rays' in the
                   backward pass automatically, overlapped by XLA's
                   latency-hiding scheduler.

Multi-host: call init_distributed() (jax.distributed.initialize) first; the
same code then spans hosts.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.config import RenderConfig
from ..core.types import Scene
from ..ops.pallas import fused_pass
from ..render import pathtracer, route

Array = jax.Array


def init_distributed(**kw) -> None:
    """Multi-host entry (no-op if single-process). NOTE: must run before
    anything initializes the XLA backend — so the no-kwargs probe must not
    itself touch jax.process_count() until after the decision."""
    if not kw:
        if jax.process_count() == 1:
            return
    jax.distributed.initialize(**kw)


def make_mesh(n_devices: int | None = None, obj_parallel: int = 1) -> Mesh:
    """1-D or 2-D device mesh: ('rays',) or ('rays', 'obj')."""
    devs = jax.devices()
    n = n_devices or len(devs)
    devs = np.asarray(devs[:n])
    if obj_parallel > 1:
        assert n % obj_parallel == 0
        grid = devs.reshape(n // obj_parallel, obj_parallel)
        return Mesh(grid, ("rays", "obj"))
    return Mesh(devs.reshape(n), ("rays",))


def _state_sharding(mesh: Mesh) -> dict:
    ray_axes = "rays"
    return {
        "acc": NamedSharding(mesh, P(ray_axes, None)),
        "key": NamedSharding(mesh, P()),
        "passes": NamedSharding(mesh, P()),
    }


def shard_state(state: dict, mesh: Mesh) -> dict:
    sh = _state_sharding(mesh)
    out = {}
    for k, v in state.items():
        try:
            out[k] = jax.device_put(v, sh[k])
        except ValueError:
            # ray count not divisible by the shard count: device_put
            # refuses uneven shardings — leave the entry unplaced; GSPMD
            # partitions it unevenly on entry to the render fns
            out[k] = v
    return out


def replicate_scene(scene: Scene, mesh: Mesh) -> Scene:
    rep = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, rep), scene)


def sharded_render_passes(mesh: Mesh, cfg: RenderConfig, n_passes: int):
    """Compile a render-passes fn whose ray-indexed state is sharded over the
    'rays' mesh axis. Scene is replicated; forward needs no collectives.

    On the fused-kernel route each device runs the kernel on its own ray
    slice under shard_map (GSPMD cannot partition a pallas_call), with its
    global ray offset for pixel decode and draws; the XLA route is
    partitioned by GSPMD."""
    sh = _state_sharding(mesh)
    n_shards = mesh.shape["rays"]
    local = cfg.total_rays // n_shards
    spec = {"acc": P("rays", None), "key": P(), "passes": P()}

    def local_passes(scene, state):
        off = jax.lax.axis_index("rays") * local
        return fused_pass.render_passes(scene, state, cfg, n_passes,
                                        ray_offset=off)

    def render(scene, state):
        on = mesh.devices.flat[0].platform      # the devices that run it
        if (route.forward(scene, cfg, on=on) == route.TRITON
                and cfg.total_rays % n_shards == 0):
            return jax.shard_map(local_passes, mesh=mesh,
                                 in_specs=(P(), spec), out_specs=spec,
                                 check_vma=False)(scene, state)
        return pathtracer.render_passes_xla(scene, state, cfg, n_passes)

    # scene keeps its (replicated) placement
    return jax.jit(render, in_shardings=(None, sh), out_shardings=sh)


# ---------------------------------------------------------------------------
# Differentiable training step (the BASELINE.json fwd+bwd metric)
# ---------------------------------------------------------------------------

def apply_default_params(scene: Scene, params: dict) -> Scene:
    """Default parameterization: {center, radius, materials} (any subset)
    over the scene's spheres/materials — the BASELINE.json geometry+albedo
    set. Any other inverse-rendering parameterization (triangle vertices,
    camera, lights — all supported by the VJPs) is a custom
    ``apply_params``."""
    import dataclasses
    spheres = scene.spheres
    if "center" in params or "radius" in params:
        spheres = dataclasses.replace(
            spheres,
            center=params.get("center", spheres.center),
            radius=params.get("radius", spheres.radius))
        scene = dataclasses.replace(scene, spheres=spheres)
    if "materials" in params:
        scene = dataclasses.replace(scene, materials=params["materials"])
    return scene


def make_train_step(mesh: Mesh, cfg: RenderConfig, *,
                    loss_fn=None, apply_params=None):
    """Inverse-rendering step over the device mesh.

    ``apply_params(scene, params) -> Scene`` maps an arbitrary parameter
    pytree onto the scene (default: {center, radius, materials});
    ``loss_fn(img, target) -> scalar`` is the image loss (default: L2).
    Rays are sharded over the mesh, params replicated. The pass is the
    XLA stage pipeline under GSPMD; jit-with-shardings inserts the psum of
    the parameter gradients over 'rays'.
    """
    sh = _state_sharding(mesh)
    rep = NamedSharding(mesh, P())
    if loss_fn is None:
        loss_fn = lambda img, target: jnp.mean((img - target) ** 2)  # noqa: E731
    if apply_params is None:
        apply_params = apply_default_params

    def loss(params, scene: Scene, state: dict, target: Array):
        sc = apply_params(scene, params)
        new_state = pathtracer._render_pass(sc, state, cfg)
        img = pathtracer.image(new_state, cfg)
        return loss_fn(img, target), new_state

    grad_fn = jax.value_and_grad(loss, has_aux=True)

    @partial(jax.jit,
             in_shardings=(rep, None, sh, rep),
             out_shardings=((rep, sh), rep))
    def step(params, scene, state, target):
        return grad_fn(params, scene, state, target)

    return step
