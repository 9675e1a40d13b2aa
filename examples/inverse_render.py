"""Inverse rendering demo: recover scene parameters from a target image by
gradient descent through the renderer.

This is the end-to-end differentiability showcase (BASELINE.json north
star): pixel gradients flow to sphere centers/radii and material albedo
through the full path-tracing pipeline. Run from the repository root on
the default accelerator, or on the CPU with --cpu:

    PYTHONPATH=. python examples/inverse_render.py [--cpu]
"""
import sys
import time

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import dataclasses

import jax.numpy as jnp
import numpy as np

from raytracing_tpu import RenderConfig, replace
from raytracing_tpu.models.scenes import cornell_box
from raytracing_tpu.render import pathtracer


def main():
    small = "--cpu" in sys.argv
    W, H = (48, 36) if small else (128, 96)
    cfg = RenderConfig(width=W, height=H, spp=1, bounces=2, seed=7)

    # ground truth scene: sphere at its true position with true albedo
    true_scene = cornell_box(cols=W, rows=H)

    def render(scene, n_passes=2, passes=pathtracer.render_passes):
        st = pathtracer.init_state(cfg)
        st = passes(scene, st, cfg, n_passes)
        return pathtracer.image(st, cfg)

    # Differentiated, render_passes is the XLA pipeline on every platform.
    # The target comes from that pipeline too, with the same seed: the loss
    # then shares its draws (common random numbers) and can fall below the
    # Monte Carlo noise of two passes.
    target = render(true_scene, 4, pathtracer.render_passes_xla)

    # start from perturbed parameters
    params = {
        "center": true_scene.spheres.center + jnp.array([[0.25, 0.1, -0.15],
                                                         [-0.2, 0.15, 0.1]]),
        "radius": true_scene.spheres.radius * jnp.array([0.8, 1.25]),
        "materials": jnp.clip(true_scene.materials
                              + 0.25 * jax.random.normal(
                                  jax.random.PRNGKey(0),
                                  true_scene.materials.shape), 0.05, 1.0),
    }

    def loss_fn(params):
        spheres = dataclasses.replace(true_scene.spheres,
                                      center=params["center"],
                                      radius=params["radius"])
        scene = replace(true_scene, spheres=spheres,
                        materials=params["materials"])
        img = render(scene)
        return jnp.mean((img - target) ** 2)

    step = jax.jit(jax.value_and_grad(loss_fn))

    lr = {"center": 2.0, "radius": 1.0, "materials": 3.0}
    t0 = time.time()
    loss0 = None
    for it in range(40):
        loss, grads = step(params)
        if loss0 is None:
            loss0 = float(loss)
        params = {k: params[k] - lr[k] * grads[k] for k in params}
        params["radius"] = jnp.clip(params["radius"], 0.05, 0.9)
        params["materials"] = jnp.clip(params["materials"], 0.0, 1.0)
        if it % 10 == 0 or it == 39:
            err_c = float(jnp.abs(params["center"]
                                  - true_scene.spheres.center).mean())
            print(f"it {it:3d}  loss {float(loss):.6f}  "
                  f"center err {err_c:.4f}", flush=True)

    print(f"\n{time.time() - t0:.1f}s; loss {loss0:.6f} -> {float(loss):.6f}")
    final_err = float(jnp.abs(params['center']
                              - true_scene.spheres.center).mean())
    init_err = 0.175  # mean |perturbation|
    print(f"center error: {init_err:.3f} -> {final_err:.3f}")
    assert float(loss) < 0.5 * loss0, "optimization failed to reduce loss"
    print("OK: gradients through the path tracer recover scene parameters")


if __name__ == "__main__":
    main()
