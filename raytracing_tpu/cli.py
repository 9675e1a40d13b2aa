"""Command-line renderer — the framework's presentation layer (L5).

The reference's UI (Assign10-Path_Tracing/index.html:25-48) exposes: compute
device select, scene select, rays/pixel, focal length, lens diameter, and
Start/Stop progressive rendering with a live pass counter
(code.js:1861-1894). The CLI maps those one-to-one:

  python -m raytracing_tpu.cli --list-devices
  python -m raytracing_tpu.cli --scene cornell --passes 64 -o out.png
  python -m raytracing_tpu.cli --scene path/to/scene.xml --spp 4 \\
      --focal-length 2.0 --lens-diameter 0.05 --width 640 --height 480

Progressive state is checkpointed on Ctrl-C (Stop) and can be resumed with
--resume (the reference's (acu, seeds, passes) triple, SURVEY §5).
"""
from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raytracing_tpu",
        description="differentiable path tracer")
    p.add_argument("--scene", default="cornell",
                   help="builtin scene name (cornell, spheres) or XML path")
    p.add_argument("--renderer", default="path",
                   choices=["path", "direct", "fake"],
                   help="pipeline: path (Assign10), direct (Assign08/09), "
                        "fake (Assign01/02)")
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--spp", type=int, default=1,
                   help="rays per pixel per pass (perfect square)")
    p.add_argument("--passes", type=int, default=16)
    p.add_argument("--bounces", type=int, default=5)
    p.add_argument("--focal-length", type=float, default=None)
    p.add_argument("--lens-diameter", type=float, default=None)
    p.add_argument("--exposure", type=float, default=1.8)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--grid", type=int, default=0, metavar="N",
                   help="use N^3 uniform-grid acceleration (0 = brute "
                        "force); mesh instances get their own grids at "
                        "their XML nslabs")
    p.add_argument("--mesh-slabs", default="auto", metavar="N|xml|auto",
                   help="per-mesh grid resolution: 'auto' (default) picks "
                        "from the measured cost model, 'xml' honors each "
                        "mesh's nslabs (reference-parity fidelity), an int "
                        "overrides all meshes")
    p.add_argument("--chunk-passes", type=int, default=8,
                   help="passes per jit call (progress granularity)")
    p.add_argument("-o", "--output", default="render.png")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint path (default <output>.ckpt.npz)")
    p.add_argument("--resume", action="store_true",
                   help="resume from checkpoint")
    p.add_argument("--orbit", type=int, default=0, metavar="N",
                   help="render N frames orbiting the scene (Assign02 "
                        "rotate-camera animation); output becomes a "
                        "frame_%%03d.png sequence")
    p.add_argument("--list-devices", action="store_true")
    p.add_argument("--cpu", action="store_true", help="force CPU backend")
    return p


def load_named_scene(name: str, width: int, height: int):
    if name.endswith(".xml"):
        from .io.scene_xml import load_scene
        return load_scene(name, width, height)
    from .models.scenes import cornell_box, sphere_field
    if name == "cornell":
        return cornell_box(cols=width, rows=height)
    if name == "spheres":
        return sphere_field(512, cols=width, rows=height)
    raise SystemExit(f"unknown scene {name!r} (builtin: cornell, spheres)")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from .utils.cache import enable_compilation_cache
    enable_compilation_cache()

    if args.list_devices:
        # device discovery (analog of findWebCLDevices, ref code.js:466-505)
        for d in jax.devices():
            print(f"[{d.id}] {d.platform}: {d.device_kind}")
        return 0

    import numpy as np

    from . import RenderConfig, replace
    from .io.png import write_png
    from .render import pathtracer
    from .utils.runtime import scene_stats

    scene = load_named_scene(args.scene, args.width, args.height)
    if args.focal_length is not None:
        scene = replace(scene,
                        focal_length=jax.numpy.float32(args.focal_length))
    if args.lens_diameter is not None:
        scene = replace(scene,
                        lens_radius=jax.numpy.float32(args.lens_diameter / 2))

    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       bounces=args.bounces, exposure=args.exposure,
                       seed=args.seed, use_grid=args.grid > 0,
                       n_slabs=max(args.grid, 1))
    if args.grid > 0:
        from .accel import prepare_grids
        ms = args.mesh_slabs
        if ms not in ("xml", "auto"):
            ms = int(ms)
        scene = prepare_grids(scene, args.grid, mesh_slabs=ms)

    from .render import route
    print(f"device: {jax.devices()[0].platform} "
          f"({jax.devices()[0].device_kind}), "
          f"route: {route.forward(scene, cfg)}")
    for k, v in scene_stats(scene).items():
        print(f"  {k}: {v}")

    if args.orbit:
        # Assign02 rotate animation (ref Camera.rotate, code.js:221-248):
        # orbit the eye around the scene bounds, one render per frame
        import os

        from .render import pathtracer as pt

        base, ext = os.path.splitext(args.output)
        for f in range(args.orbit):
            angle = 360.0 * f / args.orbit
            cam = scene.camera.orbit(scene.bounds, angle)
            fscene = replace(scene, camera=cam)
            state = pt.init_state(cfg)
            state = pt.render_passes(fscene, state, cfg, args.passes)
            img = np.array(pt.image(state, cfg))
            frame = f"{base}_frame{f:03d}{ext}"
            write_png(frame, img)
            print(f"frame {f + 1}/{args.orbit}: {frame}")
        return 0

    if args.renderer == "fake":
        from .render.simple import render_fake_shade
        import jax.numpy as jnp
        cam = replace(scene.camera, cols=args.width, rows=args.height)
        colors = jnp.asarray(np.asarray(scene.materials))
        sp = scene.spheres
        mats = colors[np.maximum(np.asarray(sp.mat_id), 0)]
        img = np.array(render_fake_shade(cam, sp, jnp.asarray(mats)))
        write_png(args.output, img)
        print(f"wrote {args.output}")
        return 0

    if args.renderer == "direct":
        from .render.direct import render_direct
        # --passes: progressive accumulation of independent estimates
        # (soft shadows / DoF converge) in one jitted program
        img = np.array(render_direct(scene, cfg, n_passes=args.passes))
        write_png(args.output, img)
        print(f"wrote {args.output} ({args.passes} passes)")
        return 0

    ckpt = args.checkpoint or (args.output + ".ckpt.npz")
    if args.resume:
        state = pathtracer.load_checkpoint(ckpt)
        print(f"resumed at pass {int(state['passes'])}")
    else:
        state = pathtracer.init_state(cfg)

    done = int(state["passes"])
    target = done + args.passes
    t0 = time.time()
    try:
        while done < target:
            n = min(args.chunk_passes, target - done)
            state = jax.block_until_ready(
                pathtracer.render_passes(scene, state, cfg, n))
            done = int(state["passes"])
            # crash-safe: persist progressive state every chunk (failure
            # recovery = restart with --resume; SURVEY §5)
            pathtracer.save_checkpoint(ckpt, state)
            rays = cfg.total_rays * (1 + scene.lights.count
                                     + cfg.bounces * (1 + scene.lights.count))
            dt = time.time() - t0
            print(f"\rRendering... Pass: {done}  "
                  f"({done * rays / max(dt, 1e-9) / 1e6:.1f} M segs/s)",
                  end="", flush=True)
    except KeyboardInterrupt:
        print("\nStopped; checkpointing.")
    finally:
        pathtracer.save_checkpoint(ckpt, state)
        img = np.array(pathtracer.image(state, cfg))
        write_png(args.output, img)
        print(f"\nwrote {args.output} ({int(state['passes'])} passes), "
              f"checkpoint {ckpt}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
