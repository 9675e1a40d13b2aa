"""Test harness: force the CPU platform with an 8-device virtual mesh.

jax.config is updated before any backend is initialized, so the tests run
on the CPU whatever JAX_PLATFORMS says (RT_TEST_PLATFORMS overrides). 8
virtual CPU devices is the standard way to test N-device sharding without
the devices (SURVEY §4).
Tests that need a GPU take the ``gpu`` fixture and carry the ``gpu``
marker; without a card they skip.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

# XLA's CPU compiler recurses deeply on the big grad graphs (grid-pipeline
# backward, zoo scenes); against the default 8 MB stack it segfaults
# (SIGSEGV inside backend_compile_and_load — reproduced, and cured by
# `ulimit -s unlimited`). The main thread's stack can only grow until it
# hits a neighboring mmap, so a runtime setrlimit is NOT reliable (the
# crash moved around between runs). Each test body therefore runs on a
# worker thread with an explicitly large stack — deterministic, and
# compiles triggered by the test recurse on that thread.
import threading

threading.stack_size(256 << 20)

import jax  # noqa: E402

jax.config.update("jax_platforms",
                  os.environ.get("RT_TEST_PLATFORMS", "cpu"))
jax.config.update("jax_enable_x64", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(20150415)


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_between_modules():
    """Drop compiled executables between test modules. A full front-to-
    back suite run compiles ~200 XLA programs in one process; the
    accumulated RSS moves mmaps up against the compile threads' stacks
    and the CPU compiler's deep recursion then segfaults (the documented
    crash class this file's big-stack workers mitigate). Per-module cache
    clearing keeps the process footprint flat; per-module compile reuse
    is preserved."""
    yield
    import gc
    jax.clear_caches()
    gc.collect()


@pytest.fixture
def gpu():
    """A GPU device, or a skip. Decided when the test runs, never at
    import, so every worker collects the same tests. The suite runs on the
    CPU; on a machine with a card, RT_TEST_PLATFORMS=cpu,cuda adds it (the
    CPU stays the default device)."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (RT_TEST_PLATFORMS=cpu,cuda on the card)")


# ---------------------------------------------------------------------------
# Fast tier: `pytest -m "not slow"` runs in ~2 min on a CPU; the slow tier
# (the 8-device mesh, scene zoo, goldens of the full path tracer) is the
# full-fidelity suite. Tests already decorated with @pytest.mark.slow are
# additive to this list.
# ---------------------------------------------------------------------------

_SLOW = {
    # 8-device virtual mesh
    "test_sharded_render_matches_single_device",
    "test_train_step_grads_match_single_device",
    "test_objsharded_closest_hit_matches",
    # full-pipeline goldens / progressive statistics
    "test_golden", "test_direct_progressive_passes",
    "test_pathtracer_progressive_mean_stable", "test_checkpoint_resume",
    "test_pathtracer_spp_equivalence", "test_grid_image_equals_brute_image",
    # heavyweight diff/runtime/viewer paths
    "test_grad_triangle_vertices_interior",
    "test_pathtracer_geometry_grad_finite", "test_grad_albedo_pathtracer_exact",
    "test_grad_light_irradiance_linear", "test_cli_main_renders",
    "test_orbax_sharded_checkpoint", "test_profile_trace_noop",
    "test_progressive_step_and_reset",
    # reference scene zoo (loads + renders every Assign10 scene)
    "test_scene_loads_and_renders", "test_multi_light_accumulates_more",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        base = item.name.split("[")[0]
        if base in _SLOW:
            item.add_marker(pytest.mark.slow)


@pytest.hookimpl(tryfirst=True)
def pytest_pyfunc_call(pyfuncitem):
    """Run the test body on a big-stack worker thread (see stack_size
    above). Fixtures and collection stay on the main thread; exceptions
    re-raise with their original tracebacks. Only plain sync test
    functions are hijacked — coroutine tests (or anything another
    plugin must drive) fall through to the default call path, since the
    big-stack rationale covers XLA compiles from sync bodies only."""
    import inspect

    testfunction = pyfuncitem.obj
    if inspect.iscoroutinefunction(testfunction):
        return None
    testargs = {arg: pyfuncitem.funcargs[arg]
                for arg in pyfuncitem._fixtureinfo.argnames}
    box = {}

    def run():
        try:
            box["ret"] = testfunction(**testargs)
        except BaseException as e:      # noqa: BLE001 — re-raised below
            box["exc"] = e

    t = threading.Thread(target=run, name=f"test:{pyfuncitem.name}")
    t.start()
    t.join()
    if "exc" in box:
        raise box["exc"]
    return True
