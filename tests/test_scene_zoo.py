"""Every reference Assign10 scene must load and render finite images
(multi-light scenes exercise the per-light loops)."""
import glob
import os

import numpy as np
import pytest

from raytracing_tpu import RenderConfig
from raytracing_tpu.io.scene_xml import load_scene
from raytracing_tpu.render import pathtracer

SCENES = sorted(glob.glob(os.path.join(
    os.environ.get("RT_REFERENCE_DIR", "/root/reference"),
    "Assign10-Path_Tracing/scenes/*.xml")))

pytestmark = pytest.mark.skipif(not SCENES, reason="reference not mounted")


@pytest.mark.parametrize("path", SCENES, ids=[os.path.basename(p)
                                              for p in SCENES])
def test_scene_loads_and_renders(path):
    scene = load_scene(path, 24, 18)
    cfg = RenderConfig(width=24, height=18, spp=1, bounces=1, seed=1)
    st = pathtracer.render_passes(scene, pathtracer.init_state(cfg), cfg, 2)
    img = np.array(pathtracer.image(st, cfg))
    assert np.isfinite(img).all()
    assert img.max() > 0.0                # something renders
    assert scene.lights.count >= 1


def test_multi_light_accumulates_more():
    three = [p for p in SCENES if "threeLights" in p]
    one = [p for p in SCENES if os.path.basename(p) == "cornell.xml"]
    if not three or not one:
        pytest.skip("expected scenes missing")
    cfg = RenderConfig(width=24, height=18, spp=1, bounces=0, seed=1)

    def mean_img(p):
        sc = load_scene(p, 24, 18)
        st = pathtracer.render_passes(sc, pathtracer.init_state(cfg), cfg, 2)
        return np.array(pathtracer.image(st, cfg)).mean(), sc.lights.count

    m3, n3 = mean_img(three[0])
    m1, n1 = mean_img(one[0])
    assert n3 > n1
    assert m3 > 0 and m1 > 0
