"""Runtime utilities: validation, stats, timing, CLI entry."""
import numpy as np
import jax.numpy as jnp

from raytracing_tpu import RenderConfig, replace
from raytracing_tpu.models.scenes import cornell_box, sphere_field
from raytracing_tpu.render import pathtracer
from raytracing_tpu.utils.runtime import (
    StageTimer, device_info, scene_stats, timeit, validate_scene,
)


def test_scene_stats_and_validate():
    scene = cornell_box(cols=16, rows=12)
    stats = scene_stats(scene)
    assert stats["spheres"] == 2 and stats["triangles"] == 10
    assert stats["lights"] == 1 and stats["materials"] == 5
    assert validate_scene(scene) == []


def test_validate_catches_bad_mat_id():
    scene = cornell_box(cols=16, rows=12)
    import dataclasses
    bad = dataclasses.replace(scene.spheres,
                              mat_id=jnp.array([99, 0], jnp.int32))
    scene = replace(scene, spheres=bad)
    issues = validate_scene(scene)
    assert any("out of range" in i for i in issues)


def test_device_info_and_fence():
    info = device_info()
    assert len(info) >= 1
    assert info[0]["platform"] == "cpu" and info[0]["kind"]
    # timing fences with block_until_ready on every leaf of a pytree
    assert timeit(lambda x: {"a": x + 1, "b": [x * 2]}, jnp.ones(4),
                  iters=1) >= 0


def test_timeit_and_stage_timer():
    f = lambda x: x * 2 + 1
    dt = timeit(f, jnp.ones(128), iters=3)
    assert dt >= 0
    st = StageTimer()
    st.run("double", f, jnp.ones(64))
    st.run("double", f, jnp.ones(64))
    assert "double" in st.summary()


def test_sphere_field_scene_renders():
    scene = sphere_field(64, cols=24, rows=18)
    cfg = RenderConfig(width=24, height=18, spp=1, bounces=1, seed=9)
    st = pathtracer.render_passes(scene, pathtracer.init_state(cfg), cfg, 2)
    img = np.array(pathtracer.image(st, cfg))
    assert np.isfinite(img).all() and img.max() > 0


def test_cli_main_renders(tmp_path):
    from raytracing_tpu.cli import main
    out = str(tmp_path / "r.png")
    rc = main(["--cpu", "--scene", "cornell", "--width", "24", "--height",
               "18", "--passes", "2", "--bounces", "1",
               "--chunk-passes", "2", "-o", out])
    assert rc == 0
    data = open(out, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"


def test_cli_list_devices(capsys):
    from raytracing_tpu.cli import main
    assert main(["--list-devices", "--cpu"]) == 0
    assert "cpu" in capsys.readouterr().out


def test_orbax_sharded_checkpoint(tmp_path):
    from raytracing_tpu.render.pathtracer import (
        init_state, load_checkpoint_sharded, render_passes,
        save_checkpoint_sharded,
    )
    scene = cornell_box(cols=16, rows=12)
    cfg = RenderConfig(width=16, height=12, spp=1, bounces=1, seed=5)
    st = render_passes(scene, init_state(cfg), cfg, 2)
    path = str(tmp_path / "ckpt_orbax")
    try:
        save_checkpoint_sharded(path, st)
        st2 = load_checkpoint_sharded(path, template=st)
    except ImportError:
        import pytest
        pytest.skip("orbax unavailable")
    np.testing.assert_allclose(np.asarray(st2["acc"]), np.asarray(st["acc"]))
    assert int(st2["passes"]) == 2
    a = render_passes(scene, st, cfg, 1)
    b = render_passes(scene, st2, cfg, 1)
    np.testing.assert_allclose(np.asarray(a["acc"]), np.asarray(b["acc"]),
                               atol=1e-6)


def test_profile_trace_noop(tmp_path):
    from raytracing_tpu.utils.runtime import profile_trace
    with profile_trace(str(tmp_path / "trace")):
        _ = jnp.ones(8) * 2
