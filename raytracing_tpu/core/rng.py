"""Counter-based RNG for the renderer.

The reference keeps one persistent Park–Miller LCG seed per ray slot, indexed
by ``get_global_id(0)`` (Assign10-Path_Tracing/code.cl:420-434) — a layout
that changes meaning between 1-D and 2-D kernels (SURVEY §5 hazard note).
This design replaces it with JAX's counter-based threefry: every
random draw is keyed on *logical* identity (render seed, pass index, purpose,
depth), so results are reproducible under any sharding / batching layout.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array

# Purpose tags (stable integers — do not renumber, checkpoints depend on them)
LENS = 0
LIGHT = 1
BOUNCE = 2
INIT = 3


def base_key(seed: int | Array) -> Array:
    return jax.random.PRNGKey(seed)


def pass_key(key: Array, pass_idx: Array) -> Array:
    """Key for one progressive pass (the analog of the per-pass seed
    evolution of the reference's persistent seed buffer)."""
    return jax.random.fold_in(key, pass_idx)


def draw_key(key: Array, purpose: int, depth: int | Array = 0,
             light: int | Array = 0) -> Array:
    k = jax.random.fold_in(key, purpose)
    k = jax.random.fold_in(k, depth)
    return jax.random.fold_in(k, light)


def uniform2(key: Array, n: int, dtype=jnp.float32) -> Array:
    """(n, 2) uniforms in [0, 1)."""
    return jax.random.uniform(key, (n, 2), dtype)
