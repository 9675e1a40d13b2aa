"""Single-pass fake-shade sphere renderer — Assign01/02 analog.

Reproduces the monolithic ``raytrace`` kernel semantics
(ref Assign02-Multi_Sphere_Ray_Tracing/code.cl:158-232):
  pinhole ray per pixel -> champion sphere -> fake shade dot(W, n)
  -> color = sphere_color * shade; black background.
Assign01 (one hard-coded sphere, Assign01 code.cl:116-147) is the S=1 case.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.types import Camera, Spheres
from ..ops.closest_hit import closest_hit_spheres, fetch_rows, \
    sphere_hit_attrs
from .camera import pinhole_rays, pixel_grid

Array = jax.Array


@partial(jax.jit, static_argnames=("obj_chunk",))
def render_fake_shade(cam: Camera, spheres: Spheres, colors: Array,
                      obj_chunk: int = 512) -> Array:
    """(rows, cols, 3) float image; colors: (S, 4) per-sphere rgba.

    The reference's color table is per-unique-element (via atomData ids,
    ref Assign02 code.js:486-499); pass colors already gathered per sphere."""
    col, row = pixel_grid(cam)
    rays = pinhole_rays(cam, col, row)
    ch = closest_hit_spheres(rays, spheres, obj_chunk=obj_chunk)
    _, n, _ = sphere_hit_attrs(rays, spheres, ch)
    shade = jnp.sum(cam.w[None, :] * n, -1)
    rgb = fetch_rows(colors[:, :3], ch.idx) * shade[:, None]
    img = jnp.where(ch.valid[:, None], rgb, 0.0)
    return img.reshape(cam.rows, cam.cols, 3)


@partial(jax.jit, static_argnames=("n_frames", "obj_chunk"))
def render_fake_shade_orbit(cam: Camera, spheres: Spheres, colors: Array,
                            bounds, n_frames: int = 16,
                            obj_chunk: int = 512) -> Array:
    """(n_frames, rows, cols, 3): one full eye orbit around the scene —
    the reference's rotate animation (Assign02 code.js:55-98 ``rotate``
    driven per frame) as ONE jitted lax.scan, zero host dispatches
    between frames. This is the steady-state form of the Assign01/02
    pipeline (the single-frame render is one small dispatch and bound by
    launch overhead)."""
    def frame(_, angle):
        c = cam.orbit(bounds, angle)
        return None, render_fake_shade(c, spheres, colors, obj_chunk)

    angles = jnp.linspace(0.0, 360.0, n_frames, endpoint=False)
    _, frames = jax.lax.scan(frame, None, angles)
    return frames
