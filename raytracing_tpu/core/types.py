"""Core geometric / renderer state types.

All types are SoA (structure-of-arrays) pytree dataclasses over jnp arrays — the
analog of the reference's flat ``__global`` SoA buffers
(ref: Assign10-Path_Tracing/code.cl:11-68 struct definitions, and the host-side
buffer layouts at Assign10-Path_Tracing/code.js:1078-1234).

Design notes (not a port):
  * A *batch* of rays is a single pytree of dense arrays ``(N, 3)`` / ``(N,)``
    — the analog of the persistent ray buffer of the wavefront pipeline
    (ref: Assign03 onward). There is no per-ray object.
  * Validity is expressed with masks / sentinel values (``mat_id < 0``,
    ``mint == maxt``), exactly like the reference's conventions, so pipelines
    are fully branch-free under ``jit``.
  * Static quantities (image dims, object counts) live as aux (non-pytree)
    fields so shapes stay static under tracing.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

INF = jnp.inf


def _pytree_dataclass(cls):
    """Register a frozen dataclass as a jax pytree (data = array fields,
    meta = fields annotated with ``static=True`` metadata)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data_fields = [f.name for f in dataclasses.fields(cls)
                   if not f.metadata.get("static", False)]
    meta_fields = [f.name for f in dataclasses.fields(cls)
                   if f.metadata.get("static", False)]
    jax.tree_util.register_dataclass(cls, data_fields, meta_fields)
    return cls


def static_field(**kw):
    return dataclasses.field(metadata={"static": True}, **kw)


def replace(obj, **kw):
    return dataclasses.replace(obj, **kw)


def safe_normalize(v: "Array", axis: int = -1) -> "Array":
    """Normalize with a NaN-free backward pass at ``v = 0``.

    ``v / max(norm(v), eps)`` still NaNs in reverse mode: d‖v‖/dv = v/‖v‖ is
    0/0 at the origin and the max guards only the division. Guarding the
    *squared* norm before rsqrt keeps both primal and cotangent finite
    (masked lanes then see a constant, zero-gradient scale)."""
    norm2 = jnp.sum(v * v, axis=axis, keepdims=True)
    safe = jnp.where(norm2 > 0.0, norm2, 1.0)
    return v * jax.lax.rsqrt(safe)


# ---------------------------------------------------------------------------
# Rays
# ---------------------------------------------------------------------------

@_pytree_dataclass
class Rays:
    """A dense batch of rays. ref struct: Assign10-Path_Tracing/code.cl:28-32.

    ``mint == maxt`` marks a dead/degenerate ray (reference convention,
    e.g. code.cl:499-501)."""
    o: Array      # (N, 3) origins
    d: Array      # (N, 3) directions (normalized)
    mint: Array   # (N,)
    maxt: Array   # (N,)

    @property
    def n(self) -> int:
        return self.o.shape[0]

    @property
    def alive(self) -> Array:
        return self.mint != self.maxt

    def at(self, t: Array) -> Array:
        """Point along ray: o + t*d (ref getPoint, code.cl:86-88)."""
        return self.o + t[..., None] * self.d

    @staticmethod
    def dead(n: int, dtype=jnp.float32) -> "Rays":
        z3 = jnp.zeros((n, 3), dtype)
        inf = jnp.full((n,), INF, dtype)
        return Rays(o=z3, d=z3, mint=inf, maxt=inf)


def make_segment_rays(origin: Array, dst: Array) -> Rays:
    """Segment rays origin->dst with maxt = |dst-origin| (shadow rays).
    ref makeRay: Assign10-Path_Tracing/code.cl:121-129."""
    delta = dst - origin
    dist = jnp.sqrt(jnp.where((delta != 0.0).any(-1),
                              jnp.sum(delta * delta, -1), 1.0))
    dist = jnp.where((delta != 0.0).any(-1), dist, 0.0)
    d = safe_normalize(delta)
    return Rays(o=origin, d=d, mint=jnp.zeros_like(dist), maxt=dist)


# ---------------------------------------------------------------------------
# Hits (the reference's "Poi" = point of intersection)
# ---------------------------------------------------------------------------

@_pytree_dataclass
class Hits:
    """Per-ray hit record + path throughput.
    ref struct Poi: Assign10-Path_Tracing/code.cl:57-62 (p, normal, atte, matId).

    ``mat_id < 0`` marks "no intersection" (reference convention)."""
    p: Array           # (N, 3) point of intersection
    n: Array           # (N, 3) shading normal
    throughput: Array  # (N, 3) path throughput ("atte" in the reference)
    mat_id: Array      # (N,) int32, -1 = invalid
    t: Array           # (N,) hit distance (extension over reference; used by tests)

    @property
    def valid(self) -> Array:
        return self.mat_id >= 0

    @staticmethod
    def none(n: int, dtype=jnp.float32) -> "Hits":
        """All-invalid hits with unit throughput
        (ref initTrace POI reset: code.cl:538-542)."""
        z3 = jnp.zeros((n, 3), dtype)
        return Hits(p=z3, n=z3, throughput=jnp.ones((n, 3), dtype),
                    mat_id=jnp.full((n,), -1, jnp.int32),
                    t=jnp.full((n,), INF, dtype))


# ---------------------------------------------------------------------------
# AABB
# ---------------------------------------------------------------------------

@_pytree_dataclass
class AABB:
    """Axis-aligned bounding box (ref struct: code.cl:23-26; host Bounds:
    lib/utilities.js:389-422)."""
    pmin: Array  # (3,)
    pmax: Array  # (3,)

    @staticmethod
    def empty() -> "AABB":
        return AABB(pmin=jnp.full((3,), INF), pmax=jnp.full((3,), -INF))

    @staticmethod
    def of(points: Array) -> "AABB":
        return AABB(pmin=points.reshape(-1, 3).min(0), pmax=points.reshape(-1, 3).max(0))

    def merge(self, other: "AABB") -> "AABB":
        return AABB(pmin=jnp.minimum(self.pmin, other.pmin),
                    pmax=jnp.maximum(self.pmax, other.pmax))

    @property
    def center(self) -> Array:
        return 0.5 * (self.pmin + self.pmax)

    @property
    def diagonal(self) -> Array:
        """Length of the diagonal (ref Bounds.diagonal, lib/utilities.js)."""
        return jnp.linalg.norm(self.pmax - self.pmin)

    def inflate_degenerate(self, eps: float = 0.1) -> "AABB":
        """Inflate zero-extent axes (axis-aligned wall fix,
        ref Assign10-Path_Tracing/code.js:837-842)."""
        degen = self.pmin == self.pmax
        return AABB(pmin=jnp.where(degen, self.pmin - eps, self.pmin),
                    pmax=jnp.where(degen, self.pmax + eps, self.pmax))


# ---------------------------------------------------------------------------
# Geometry batches (SoA)
# ---------------------------------------------------------------------------

@_pytree_dataclass
class Spheres:
    """Sphere batch. Device layout analog: float4 (center, radius) buffer with
    **radius stored plainly here**; the squared-radius hot-path convention of
    the reference (Assign10 code.js:1601 stores r^2; code.cl:205 uses it) is
    applied inside the intersection op, not in the data model."""
    center: Array  # (S, 3)
    radius: Array  # (S,)
    mat_id: Array  # (S,) int32
    mask: Array    # (S,) bool — False entries are padding

    @property
    def count(self) -> int:
        return self.center.shape[0]

    def bounds(self) -> AABB:
        r = self.radius[:, None]
        lo = jnp.where(self.mask[:, None], self.center - r, INF).min(0)
        hi = jnp.where(self.mask[:, None], self.center + r, -INF).max(0)
        return AABB(pmin=lo, pmax=hi)

    @staticmethod
    def empty() -> "Spheres":
        return Spheres(center=jnp.zeros((0, 3)), radius=jnp.zeros((0,)),
                       mat_id=jnp.zeros((0,), jnp.int32),
                       mask=jnp.zeros((0,), bool))


@_pytree_dataclass
class Triangles:
    """Triangle batch with per-vertex normals.

    ``v`` is (T, 3, 3): vertex index x xyz.  ``vn`` likewise. Precomputed
    intersection constants (see ops/intersect.py) are derived lazily —
    the data model stays minimal and differentiable."""
    v: Array       # (T, 3, 3) vertices p0,p1,p2
    vn: Array      # (T, 3, 3) vertex normals n0,n1,n2
    mat_id: Array  # (T,) int32
    mask: Array    # (T,) bool

    @property
    def count(self) -> int:
        return self.v.shape[0]

    def bounds(self) -> AABB:
        lo = jnp.where(self.mask[:, None, None], self.v, INF).reshape(-1, 3).min(0)
        hi = jnp.where(self.mask[:, None, None], self.v, -INF).reshape(-1, 3).max(0)
        return AABB(pmin=lo, pmax=hi)

    @staticmethod
    def empty() -> "Triangles":
        return Triangles(v=jnp.zeros((0, 3, 3)), vn=jnp.zeros((0, 3, 3)),
                         mat_id=jnp.zeros((0,), jnp.int32),
                         mask=jnp.zeros((0,), bool))


# ---------------------------------------------------------------------------
# Lights (disk area lights)
# ---------------------------------------------------------------------------

def tangent_frame(normal: Array) -> tuple[Array, Array]:
    """Build (T, B) tangent/bitangent for a normal using the reference's
    min-magnitude-component trick (ref Light.calculateTBN,
    Assign10-Path_Tracing/code.js:301-320; getHemisphereRay code.cl:547-562).

    Works on (..., 3)."""
    n = normal
    an = jnp.abs(n)
    # one-hot of the min-|component| axis
    minmag = jnp.min(an, axis=-1, keepdims=True)
    is_min = an == minmag
    # break ties toward x like sequential if/else if
    cum = jnp.cumsum(is_min.astype(jnp.int32), axis=-1)
    first_min = is_min & (cum == 1)
    v = jnp.where(first_min, 1.0, n)
    v = safe_normalize(v)
    t = safe_normalize(jnp.cross(v, n))
    b = safe_normalize(jnp.cross(n, t))
    return t, b


@_pytree_dataclass
class Lights:
    """Disk area lights (SoA).
    ref Light: Assign10-Path_Tracing/code.js:279-353 (position, normal,
    irradiance, radius; area = pi r^2; TBN frame for disk sampling)."""
    position: Array    # (L, 3)
    normal: Array      # (L, 3) normalized
    irradiance: Array  # (L, 3)
    radius: Array      # (L,)

    @property
    def count(self) -> int:
        return self.position.shape[0]

    @property
    def area(self) -> Array:
        return jnp.pi * self.radius ** 2

    def frames(self) -> tuple[Array, Array]:
        return tangent_frame(self.normal)

    @staticmethod
    def make(position, normal, irradiance, radius) -> "Lights":
        position = jnp.asarray(position, jnp.float32).reshape(-1, 3)
        normal = jnp.asarray(normal, jnp.float32).reshape(-1, 3)
        normal = normal / jnp.linalg.norm(normal, axis=-1, keepdims=True)
        irradiance = jnp.asarray(irradiance, jnp.float32).reshape(-1, 3)
        radius = jnp.asarray(radius, jnp.float32).reshape(-1)
        return Lights(position, normal, irradiance, radius)

    @staticmethod
    def empty() -> "Lights":
        z = jnp.zeros((0, 3))
        return Lights(position=z, normal=z, irradiance=z, radius=jnp.zeros((0,)))


# ---------------------------------------------------------------------------
# Camera
# ---------------------------------------------------------------------------

@_pytree_dataclass
class Camera:
    """Pinhole / thin-lens camera with (U, V, W) basis.
    ref struct: code.cl:44-49; host object: Assign10-Path_Tracing/code.js:175-277.

    W points *backwards* (eye - lookAt), the film plane sits at -W
    (ref getRay, code.cl:108-119)."""
    eye: Array     # (3,)
    u: Array       # (3,)
    v: Array       # (3,)
    w: Array       # (3,)
    width: Array   # () film width in scene units
    height: Array  # () film height in scene units
    cols: int = static_field(default=320)
    rows: int = static_field(default=240)

    @staticmethod
    def look_at(eye, lookat, vup, fov_deg, cols: int, rows: int) -> "Camera":
        """ref Camera.lookAt: Assign10-Path_Tracing/code.js:205-219.
        height = 2 tan(fov/2); width = height * aspect."""
        eye = jnp.asarray(eye, jnp.float32)
        lookat = jnp.asarray(lookat, jnp.float32)
        vup = jnp.asarray(vup, jnp.float32)
        aspect = cols / rows
        height = 2.0 * jnp.tan(0.5 * jnp.deg2rad(jnp.asarray(fov_deg, jnp.float32)))
        width = height * aspect
        w = eye - lookat
        w = w / jnp.linalg.norm(w)
        u = jnp.cross(vup, w)
        u = u / jnp.linalg.norm(u)
        v = jnp.cross(w, u)
        return Camera(eye=eye, u=u, v=v, w=w, width=width, height=height,
                      cols=cols, rows=rows)

    @staticmethod
    def auto_frame(bounds: AABB, cols: int, rows: int, fov_deg: float = 60.0) -> "Camera":
        """Auto-frame from scene bounds: eye on +z at distance = diagonal,
        axis-aligned basis (ref Camera.set: Assign10 code.js:185-203 — note the
        reference leaves U,V,W at defaults there; defaults are set by
        defaultInit / Assign02 usage: U=x, V=y, W=z)."""
        center = bounds.center
        diag = bounds.diagonal
        eye = center + jnp.array([0.0, 0.0, 1.0]) * diag
        aspect = cols / rows
        height = 2.0 * jnp.tan(0.5 * jnp.deg2rad(jnp.asarray(fov_deg, jnp.float32)))
        width = height * aspect
        return Camera(eye=eye,
                      u=jnp.array([1.0, 0.0, 0.0]),
                      v=jnp.array([0.0, 1.0, 0.0]),
                      w=jnp.array([0.0, 0.0, 1.0]),
                      width=width, height=height, cols=cols, rows=rows)

    def orbit(self, bounds: AABB, angle_deg) -> "Camera":
        """Orbit eye around bounds center in the xz plane
        (ref Camera.rotate: Assign10 code.js:221-248)."""
        center = bounds.center
        diag = bounds.diagonal
        rad = jnp.deg2rad(jnp.asarray(angle_deg, jnp.float32))
        eye = center + diag * jnp.array([jnp.sin(rad), 0.0, jnp.cos(rad)])
        w = eye - center
        w = w / jnp.linalg.norm(w)
        u = jnp.cross(self.v, w)
        u = u / jnp.linalg.norm(u)
        return replace(self, eye=eye, w=w, u=u)


# ---------------------------------------------------------------------------
# Mesh instance (own grid resolution + single material)
# ---------------------------------------------------------------------------

@_pytree_dataclass
class MeshInstance:
    """An instanced triangle mesh with its own acceleration-grid resolution.
    ref Mesh: Assign10-Path_Tracing/code.js:94-170 (loadFromJSON/normalize/
    scale/translate, per-mesh nslabs + matId)."""
    tris: Triangles
    bounds_min: Array
    bounds_max: Array
    grid: Any = None           # accel.grid.Grid, built by prepare_grids
    nslabs: int = static_field(default=1)

    @property
    def bounds(self) -> AABB:
        return AABB(pmin=self.bounds_min, pmax=self.bounds_max)


# ---------------------------------------------------------------------------
# Scene
# ---------------------------------------------------------------------------

@_pytree_dataclass
class Scene:
    """Full scene: geometry + lights + materials + camera + bounds.
    ref loadScene return value: Assign10-Path_Tracing/code.js:877-897."""
    camera: Camera
    spheres: Spheres
    triangles: Triangles
    meshes: tuple            # tuple[MeshInstance, ...] (tuple => pytree)
    lights: Lights
    materials: Array         # (M, 4) rgba diffuse albedo
    bounds_min: Array        # (3,) merged scene bounds
    bounds_max: Array
    sphere_bounds_min: Array
    sphere_bounds_max: Array
    triangle_bounds_min: Array
    triangle_bounds_max: Array
    focal_length: Array      # ()
    lens_radius: Array       # () lens_diameter / 2
    sphere_grid: Any = None    # accel.grid.Grid, built by prepare_grids
    triangle_grid: Any = None

    @property
    def bounds(self) -> AABB:
        return AABB(pmin=self.bounds_min, pmax=self.bounds_max)

    @property
    def sphere_bounds(self) -> AABB:
        return AABB(pmin=self.sphere_bounds_min, pmax=self.sphere_bounds_max)

    @property
    def triangle_bounds(self) -> AABB:
        return AABB(pmin=self.triangle_bounds_min, pmax=self.triangle_bounds_max)


def build_scene(camera: Camera,
                spheres: Spheres | None = None,
                triangles: Triangles | None = None,
                meshes: tuple = (),
                lights: Lights | None = None,
                materials: Any = None,
                focal_length: float = 1.0,
                lens_diameter: float = 0.0) -> Scene:
    """Assemble a Scene, computing merged bounds the way loadScene does
    (ref Assign10-Path_Tracing/code.js:869-875), including the degenerate
    triangle-AABB inflation (code.js:837-842)."""
    spheres = spheres if spheres is not None else Spheres.empty()
    triangles = triangles if triangles is not None else Triangles.empty()
    lights = lights if lights is not None else Lights.empty()
    if materials is None:
        materials = jnp.ones((1, 4), jnp.float32)
    materials = jnp.asarray(materials, jnp.float32).reshape(-1, 4)

    sb = spheres.bounds() if spheres.count else AABB.empty()
    tb = triangles.bounds() if triangles.count else AABB.empty()
    if triangles.count:
        tb = tb.inflate_degenerate(0.1)

    merged = sb.merge(tb)
    for m in meshes:
        merged = merged.merge(m.bounds)

    return Scene(camera=camera, spheres=spheres, triangles=triangles,
                 meshes=tuple(meshes), lights=lights, materials=materials,
                 bounds_min=merged.pmin, bounds_max=merged.pmax,
                 sphere_bounds_min=sb.pmin, sphere_bounds_max=sb.pmax,
                 triangle_bounds_min=tb.pmin, triangle_bounds_max=tb.pmax,
                 focal_length=jnp.asarray(focal_length, jnp.float32),
                 lens_radius=jnp.asarray(lens_diameter, jnp.float32) / 2.0)


def make_spheres(centers, radii, mat_ids=None, pad_to: int | None = None) -> Spheres:
    centers = jnp.asarray(centers, jnp.float32).reshape(-1, 3)
    radii = jnp.asarray(radii, jnp.float32).reshape(-1)
    n = centers.shape[0]
    if mat_ids is None:
        mat_ids = jnp.zeros((n,), jnp.int32)
    else:
        mat_ids = jnp.asarray(mat_ids, jnp.int32).reshape(-1)
    mask = jnp.ones((n,), bool)
    if pad_to is not None and pad_to > n:
        p = pad_to - n
        centers = jnp.concatenate([centers, jnp.zeros((p, 3))])
        radii = jnp.concatenate([radii, jnp.zeros((p,))])
        mat_ids = jnp.concatenate([mat_ids, jnp.full((p,), -1, jnp.int32)])
        mask = jnp.concatenate([mask, jnp.zeros((p,), bool)])
    return Spheres(center=centers, radius=radii, mat_id=mat_ids, mask=mask)


def make_triangles(vertices, normals=None, mat_ids=None, pad_to: int | None = None) -> Triangles:
    v = jnp.asarray(vertices, jnp.float32).reshape(-1, 3, 3)
    n = v.shape[0]
    if normals is None:
        # geometric normal replicated to vertices; orientation matches the
        # single-sided test (div > 0 accepts): n_geo = normalize(e1 x e2)
        e1 = v[:, 1] - v[:, 0]
        e2 = v[:, 2] - v[:, 0]
        gn = jnp.cross(e1, e2)
        gn = gn / jnp.maximum(jnp.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
        normals = jnp.broadcast_to(gn[:, None, :], v.shape)
    vn = jnp.asarray(normals, jnp.float32).reshape(-1, 3, 3)
    if mat_ids is None:
        mat_ids = jnp.zeros((n,), jnp.int32)
    else:
        mat_ids = jnp.asarray(mat_ids, jnp.int32).reshape(-1)
    mask = jnp.ones((n,), bool)
    if pad_to is not None and pad_to > n:
        p = pad_to - n
        v = jnp.concatenate([v, jnp.zeros((p, 3, 3))])
        vn = jnp.concatenate([vn, jnp.zeros((p, 3, 3))])
        mat_ids = jnp.concatenate([mat_ids, jnp.full((p,), -1, jnp.int32)])
        mask = jnp.concatenate([mask, jnp.zeros((p,), bool)])
    return Triangles(v=v, vn=vn, mat_id=mat_ids, mask=mask)
