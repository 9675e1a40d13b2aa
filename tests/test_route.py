"""Route choice, gathers, the compile cache and the multi-device dry run:
the platform-facing plumbing that decides what runs where."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import oracle
from raytracing_tpu import RenderConfig
from raytracing_tpu.core.types import Rays, make_spheres, make_triangles
from raytracing_tpu.models.scenes import cornell_box, sphere_field
from raytracing_tpu.ops.closest_hit import (
    closest_hit_spheres, closest_hit_triangles, fetch_rows,
    sphere_hit_attrs, triangle_hit_attrs,
)
from raytracing_tpu.render import route


# ---------------------------------------------------------------------------
# route.forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("platform", ["cpu", "gpu"])
@pytest.mark.parametrize("scene_name", ["cornell", "spheres4096"])
def test_route_forward_per_platform_and_size(platform, scene_name):
    scene = cornell_box(cols=8, rows=8) if scene_name == "cornell" \
        else sphere_field(4096, cols=8, rows=8)
    cfg = RenderConfig(width=8, height=8)
    fused = platform == "gpu"        # brute force at any table size
    assert route.forward(scene, cfg, on=platform) == \
        (route.TRITON if fused else route.XLA)


def test_route_fused_scope():
    """The fused kernel takes brute-force tables of any size, and grid
    configs up to GRID_OBJECTS objects; larger grid configs and stale-POI
    bug-compat take the XLA pipeline."""
    import dataclasses
    cfg = RenderConfig(width=8, height=8)
    for n in (2, 65, 2048, 8192):
        assert route.forward(sphere_field(n, cols=8, rows=8), cfg, "gpu") \
            == route.TRITON
    grid = dataclasses.replace(cfg, use_grid=True, n_slabs=4)
    n = route.GRID_OBJECTS
    for scene in (cornell_box(cols=8, rows=8), sphere_field(n, 8, 8)):
        assert route.forward(scene, grid, "gpu") == route.TRITON
    assert route.forward(sphere_field(n + 1, 8, 8), grid, "gpu") == route.XLA
    stale = dataclasses.replace(cfg, replicate_stale_poi=True)
    assert route.forward(cornell_box(cols=8, rows=8), stale, "gpu") \
        == route.XLA


def test_route_platform_follows_default_device():
    assert route.platform() == "cpu"
    with jax.default_device(jax.devices("cpu")[0]):
        assert route.platform() == "cpu"
    with jax.default_device("cpu"):
        assert route.platform() == "cpu"


# ---------------------------------------------------------------------------
# fetch_rows: the gather that replaced one-hot contractions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("n_rows", [1, 7, 5000])
def test_fetch_rows_exact_and_grad(n_rows, dtype):
    rng = np.random.default_rng(n_rows)
    data = rng.normal(size=(n_rows, 9)).astype(np.float32) * 1e3
    if dtype == "int32":
        data = rng.integers(0, 1 << 30, (n_rows, 9)).astype(np.int32)
    idx = rng.integers(-3, n_rows + 3, 513).astype(np.int32)
    got = np.asarray(fetch_rows(jnp.asarray(data), jnp.asarray(idx)))
    ok = (idx >= 0) & (idx < n_rows)
    want = np.where(ok[:, None], data[np.clip(idx, 0, n_rows - 1)], 0)
    assert got.dtype == data.dtype
    np.testing.assert_array_equal(got, want)     # bit-exact
    if dtype == "float32":
        w = rng.normal(size=(513, 9)).astype(np.float32)
        g = jax.grad(lambda x: jnp.sum(fetch_rows(x, jnp.asarray(idx)) * w))(
            jnp.asarray(data))
        want_g = np.zeros_like(data)
        np.add.at(want_g, idx[ok], w[ok])        # scatter-add
        np.testing.assert_allclose(np.asarray(g), want_g, rtol=1e-6,
                                   atol=1e-6)


def _rays(rng, n):
    o = rng.normal(size=(n, 3)).astype(np.float32) * 0.2 + [0, 0, 4]
    d = rng.normal(size=(n, 3)) * 0.25 + [0, 0, -1]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o.astype(np.float32), d


@pytest.mark.parametrize("kind", ["spheres", "triangles"])
def test_champion_attrs_match_oracle(kind):
    """Champion ids, t and hit attributes fetched through the gathers
    match the float64 NumPy oracle."""
    rng = np.random.default_rng(300)
    R = 300
    o, d = _rays(rng, R)
    rays = Rays(o=jnp.asarray(o), d=jnp.asarray(d), mint=jnp.zeros(R),
                maxt=jnp.full(R, jnp.inf))
    if kind == "spheres":
        cen = rng.uniform(-1.5, 1.5, (40, 3)).astype(np.float32)
        rad = rng.uniform(0.1, 0.4, 40).astype(np.float32)
        sp = make_spheres(cen, rad, np.arange(40) % 5)
        ch = closest_hit_spheres(rays, sp)
        p, n, mat = sphere_hit_attrs(rays, sp, ch)
        ts = oracle.sphere_ts(o.astype(np.float64), d, np.zeros(R),
                              np.full(R, np.inf), cen, rad)
        mats = np.arange(40) % 5
    else:
        v = rng.uniform(-1.5, 1.5, (40, 3, 3)).astype(np.float32)
        tr = make_triangles(v, mat_ids=np.arange(40) % 5)
        ch = closest_hit_triangles(rays, tr, two_sided=True)
        p, n, mat = triangle_hit_attrs(rays, tr, ch)
        ts = oracle.triangle_ts(o.astype(np.float64), d, np.zeros(R),
                                np.full(R, np.inf), v, two_sided=True)
        mats = np.arange(40) % 5
    best = ts.argmin(1)
    hit = np.isfinite(ts.min(1))
    assert hit.sum() > 20
    np.testing.assert_array_equal(np.asarray(ch.valid), hit)
    np.testing.assert_array_equal(np.asarray(ch.idx)[hit], best[hit])
    np.testing.assert_allclose(np.asarray(ch.t)[hit], ts.min(1)[hit],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(mat)[hit], mats[best[hit]])
    np.testing.assert_array_equal(np.asarray(mat)[~hit], -1)
    # float32 hit points: grazing hits lose digits in the division
    np.testing.assert_allclose(
        np.asarray(p)[hit], o[hit] + ts.min(1)[hit, None] * d[hit],
        rtol=1e-3, atol=1e-3)
    assert np.isfinite(np.asarray(n)).all()


# ---------------------------------------------------------------------------
# compile cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env_set", [True, False])
def test_compilation_cache_dir(tmp_path, monkeypatch, env_set):
    from raytracing_tpu.utils import cache
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_entry_size_bytes",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    if env_set:
        monkeypatch.setenv(cache.ENV, str(tmp_path / "cc"))
        want = str(tmp_path / "cc")
    else:
        monkeypatch.delenv(cache.ENV, raising=False)
        want = cache.CHECKOUT_DIR
    try:
        assert cache.cache_dir() == want
        assert cache.enable_compilation_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
        assert os.path.isdir(want)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.CHECKOUT_DIR == os.path.join(root, ".jax_cache")
    assert ".jax_cache/" in open(os.path.join(root, ".gitignore")).read()


# ---------------------------------------------------------------------------
# __graft_entry__
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cpu", [False, True])
def test_graft_entry_refuses_silent_cpu_fallback(cpu, monkeypatch):
    """Too few devices raise instead of switching to a virtual CPU mesh;
    with cpu=True the backend already holds 8 devices, so 16 still
    raise rather than re-initialize behind the caller's back."""
    import __graft_entry__ as g
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    n = len(jax.devices()) * 2
    with pytest.raises(RuntimeError, match=f"need {n}"):
        g.dryrun_multichip(n, cpu=cpu)


@pytest.mark.parametrize("two_sided", [False, True])
@pytest.mark.parametrize("kind", ["spheres", "triangles"])
def test_vectorized_oracle_matches_loop_oracle(kind, two_sided):
    """The vectorized float64 oracle (used at full image size on the card)
    equals the scalar-loop oracle."""
    rng = np.random.default_rng(64)
    R = 64
    o, d = (x.astype(np.float64) for x in _rays(rng, R))
    mint, maxt = np.zeros(R), np.full(R, np.inf)
    maxt[::5] = 3.0
    if kind == "spheres":
        cen = rng.uniform(-1.5, 1.5, (12, 3))
        rad = rng.uniform(0.1, 0.5, 12)
        a = oracle.sphere_ts(o, d, mint, maxt, cen, rad)
        b = oracle.sphere_ts_vec(o, d, mint, maxt, cen, rad)
    else:
        v = rng.uniform(-1.5, 1.5, (12, 3, 3))
        a = oracle.triangle_ts(o, d, mint, maxt, v, two_sided)
        b = oracle.triangle_ts_vec(o, d, mint, maxt, v, two_sided)
    assert np.isfinite(a).sum() > 5
    np.testing.assert_allclose(a, b, rtol=1e-9)
