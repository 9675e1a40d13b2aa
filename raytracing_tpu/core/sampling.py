"""Samplers: concentric disk map, stratified lens grid, cosine hemisphere.

Reference semantics (Assign10-Path_Tracing/code.cl):
  * ``distort``              code.cl:132-137
  * ``concentric_distort``   code.cl:143-172 (Shirley–Chiu square->disk)
  * stratified lens grid     code.cl:482-509 (initTrace, spp > 1)
  * ``getHemisphereRay``     code.cl:545-579 (TBN + cosine-weighted dir)

All functions are shape-polymorphic over leading batch dims and branch-free
(jnp.where instead of the reference's if/else) so they vectorize.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .types import safe_normalize, tangent_frame

Array = jax.Array


def distort(u: Array) -> Array:
    """[0,1]^2 -> [-1,1]^2 with (0,0) pinned (ref code.cl:132-137)."""
    out = u * 2.0 - 1.0
    zero = jnp.all(u == 0.0, axis=-1, keepdims=True)
    return jnp.where(zero, 0.0, out)


def concentric_disk(u: Array) -> Array:
    """Shirley–Chiu concentric square->unit-disk map (ref code.cl:143-172).

    u: (..., 2) in [0,1]^2 -> (..., 2) on the unit disk."""
    a = 2.0 * u[..., 0] - 1.0
    b = 2.0 * u[..., 1] - 1.0
    top = a * a > b * b
    safe_a = jnp.where(a == 0.0, 1.0, a)
    safe_b = jnp.where(b == 0.0, 1.0, b)
    radius = jnp.where(top, a, b)
    phi = jnp.where(top,
                    (jnp.pi / 4.0) * (b / safe_a),
                    (jnp.pi / 2.0) - (jnp.pi / 4.0) * (a / safe_b))
    x = jnp.cos(phi) * radius
    y = jnp.sin(phi) * radius
    out = jnp.stack([x, y], axis=-1)
    zero = (u[..., 0] == 0.0) & (u[..., 1] == 0.0)
    return jnp.where(zero[..., None], u, out)


def stratified_lens_coords(spp: int, dtype=jnp.float32) -> Array:
    """(spp, 2) stratified cell-center coordinates on [0,1]^2 for spp = k^2
    sub-rays per pixel. Sample j varies fastest in x (inner loop), i in y —
    matching the ray->slot order rays[i*k+j] of the reference
    (ref initTrace, code.cl:482-509)."""
    k = int(round(spp ** 0.5))
    if k * k != spp:
        raise ValueError(f"spp must be a perfect square, got {spp}")
    delta = 1.0 / k
    centers = (jnp.arange(k, dtype=dtype) + 0.5) * delta
    xy = jnp.stack(jnp.meshgrid(centers, centers, indexing="xy"), axis=-1)
    # row i -> y, col j -> x ; flatten i-major
    return xy.reshape(spp, 2)


def cosine_hemisphere(normal: Array, u: Array) -> Array:
    """Cosine-weighted hemisphere direction about ``normal``.

    Builds the TBN frame with the reference's min-component trick and maps a
    concentric-disk sample up with z = sqrt(1 - x^2 - y^2)
    (ref getHemisphereRay, code.cl:545-579).

    normal: (..., 3); u: (..., 2) uniforms -> (..., 3) unit direction."""
    t, b = tangent_frame(normal)
    xy = concentric_disk(u)
    x = xy[..., 0]
    y = xy[..., 1]
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - x * x - y * y))
    d = x[..., None] * t + y[..., None] * b + z[..., None] * normal
    return safe_normalize(d)


def sample_disk_point(center: Array, t_axis: Array, b_axis: Array,
                      radius: Array, u: Array) -> Array:
    """Uniform point on a disk light: center + r*concentric(u) in (T,B)
    (ref initShadowTrace, code.cl:662-666)."""
    xy = concentric_disk(u) * radius[..., None]
    return center + xy[..., 0:1] * t_axis + xy[..., 1:2] * b_axis
