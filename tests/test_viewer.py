"""Presentation-layer tests: the live web viewer (viewer.py).

Covers the reference's UI contract (Assign10 index.html:25-48 +
startRender/stopRender code.js:1872-1894): controls exist, progressive
passes accumulate, Start with changed settings resets (initAcu), and the
HTTP surface serves page/status/frame."""
import json
import urllib.request

from raytracing_tpu import viewer


def _tiny_session():
    return viewer.RenderSession(width=32, height=24, bounces=1,
                                chunk_passes=1)


def test_index_html_has_reference_controls():
    # scene select, sqrt-spp / focal / lens inputs, Start/Stop, canvas
    for needle in ['id="scene"', 'id="sqspp"', 'id="focal"', 'id="lens"',
                   'id="start"', 'id="stop"', "<canvas"]:
        assert needle in viewer.INDEX_HTML


def test_progressive_step_and_reset():
    s = _tiny_session()
    s.step(n_passes=2)
    assert s.status()["passes"] == 2
    assert s.frame_png()[:8] == b"\x89PNG\r\n\x1a\n"
    f0 = s.status()["frame"]
    s.step(n_passes=1)                     # same settings -> accumulates
    assert s.status()["passes"] == 3
    assert s.status()["frame"] == f0 + 1
    s.step(n_passes=1, spp=4)              # settings change -> initAcu
    assert s.status()["passes"] == 1


def test_direct_renderer_step():
    s = _tiny_session()
    s.step(renderer="direct", n_passes=1)
    assert s.status()["passes"] == 1
    assert len(s.frame_png()) > 0


def test_http_surface():
    s = _tiny_session()
    s.step(n_passes=1)                     # have a frame ready
    srv = viewer.make_server(s, port=0)
    import threading
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        assert b"<canvas" in urllib.request.urlopen(base + "/").read()
        scenes = json.loads(urllib.request.urlopen(base + "/scenes").read())
        assert "cornell" in scenes
        st = json.loads(urllib.request.urlopen(base + "/status").read())
        assert st["passes"] == 1 and not st["running"]
        png = urllib.request.urlopen(base + "/frame.png").read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
    finally:
        srv.shutdown()


def test_viewer_runs_production_engine():
    """The live viewer drives the route render.route names for its scene
    and platform (grids prepared), and reports which engine it runs."""
    from raytracing_tpu.render import route
    s = _tiny_session()
    s.step(n_passes=1)
    sc = s._scene_for("cornell")
    assert s.status()["engine"] == route.forward(sc, s._cfg(sc, 1))
    assert s.status()["engine"] == route.XLA     # CPU
    # device inventory for the UI select (ref findWebCLDevices)
    devs = s.devices()
    assert len(devs) >= 1 and all(":" in d for d in devs)


def test_viewer_orbit_and_fake_renderer():
    """Assign02 parity: orbit control moves the camera every chunk (each
    chunk restarts accumulation) and the fake-shade renderer runs."""
    s = _tiny_session()
    s.step(renderer="fake", n_passes=1)
    assert len(s.frame_png()) > 0
    a0 = s._angle
    s.step(renderer="path", orbit=True, n_passes=1)
    s.step(renderer="path", orbit=True, n_passes=1)
    assert s._angle != a0
    assert int(s._state["passes"]) == 1     # orbit chunk restarts acc


def test_index_html_has_round4_controls():
    for needle in ['id="device"', 'id="orbit"', 'value="fake"']:
        assert needle in viewer.INDEX_HTML
