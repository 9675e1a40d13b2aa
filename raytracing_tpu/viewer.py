"""Live progressive web viewer — the browser half of the presentation layer.

The reference is a *web-based* ray tracer: an HTML page with a <canvas>, a
scene/device select, rays-per-pixel / focal-length / lens-diameter inputs and
Start/Stop buttons driving a progressive render loop
(ref Assign10-Path_Tracing/index.html:25-48, code.js:1861-1894, canvas blit
via putImageData code.js:1530-1537). `cli.py` maps those controls to flags;
this module supplies the live-browser experience itself: a zero-dependency
HTTP server (stdlib http.server) that runs the progressive renderer in a
background thread and streams each pass to a canvas.

    python -m raytracing_tpu.viewer --port 8000 --width 320 --height 240
    # open http://localhost:8000  ->  scene/spp/focal/lens controls,
    # Start/Stop, live pass counter and segs/s — the Assign10 UI.

Rendering goes through the same entry points as the CLI (render.pathtracer
/ render.direct, which ask render.route for the implementation), so the
viewer is presentation only — no second render path to keep correct.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>raytracing_tpu viewer</title>
<style>
 body { font-family: system-ui, sans-serif; background:#111; color:#ddd;
        display:flex; flex-direction:column; align-items:center; gap:12px;
        padding:24px; }
 .controls { display:flex; gap:8px; flex-wrap:wrap; align-items:center; }
 input, select, button { background:#222; color:#ddd; border:1px solid #444;
        padding:4px 8px; border-radius:4px; }
 button { cursor:pointer; }
 canvas { image-rendering:pixelated; border:1px solid #333; }
 #status { font-variant-numeric: tabular-nums; color:#8c8; }
</style></head><body>
<h3>raytracing_tpu — progressive path tracer</h3>
<div class="controls">
 <label>device <select id="device"></select></label>
 <label>scene <select id="scene"></select></label>
 <label>renderer <select id="renderer">
   <option value="path">path (Assign10)</option>
   <option value="direct">direct (Assign08/09)</option>
   <option value="fake">fake shade (Assign01/02)</option>
 </select></label>
 <label>&radic;spp <input id="sqspp" type="number" value="1" min="1" max="8"
        style="width:3em"></label>
 <label>focal <input id="focal" type="number" step="0.1" style="width:5em"
        placeholder="scene"></label>
 <label>lens &empty; <input id="lens" type="number" step="0.01"
        style="width:5em" placeholder="scene"></label>
 <label>orbit <input id="orbit" type="checkbox"></label>
 <button id="start">Start</button>
 <button id="stop">Stop</button>
</div>
<canvas id="cv"></canvas>
<div id="status">idle</div>
<script>
const cv = document.getElementById('cv'), ctx2d = cv.getContext('2d');
const img = new Image();
img.onload = () => { cv.width = img.width; cv.height = img.height;
                     ctx2d.drawImage(img, 0, 0); };
async function tick() {
  const st = await (await fetch('/status')).json();
  document.getElementById('status').textContent =
    `device: ${st.device} | engine: ${st.engine} | pass ${st.passes}` +
    (st.running ? ` | ${st.msegs_per_s.toFixed(1)} M segs/s` : ' | stopped');
  if (st.frame > lastFrame) { lastFrame = st.frame;
                              img.src = '/frame.png?f=' + st.frame; }
}
let lastFrame = -1;
setInterval(tick, 500);
fetch('/scenes').then(r => r.json()).then(names => {
  const sel = document.getElementById('scene');
  for (const n of names) {
    const o = document.createElement('option'); o.value = o.text = n;
    sel.add(o);
  }
});
fetch('/devices').then(r => r.json()).then(devs => {
  const sel = document.getElementById('device');
  devs.forEach((d, i) => {
    const o = document.createElement('option'); o.value = i; o.text = d;
    sel.add(o);
  });
});
document.getElementById('start').onclick = () => {
  const q = new URLSearchParams({
    scene: document.getElementById('scene').value,
    renderer: document.getElementById('renderer').value,
    sqspp: document.getElementById('sqspp').value,
    focal: document.getElementById('focal').value,
    lens: document.getElementById('lens').value,
    device: document.getElementById('device').value,
    orbit: document.getElementById('orbit').checked ? '1' : '' });
  fetch('/start?' + q);
};
document.getElementById('stop').onclick = () => fetch('/stop');
</script></body></html>
"""


class RenderSession:
    """Progressive render loop + latest-frame store (thread-safe).

    The loop body is the reference's continuosRender (code.js:1861-1870):
    render one chunk of passes, publish the tonemapped frame, repeat until
    stopped. State is the (acc, rng counter, passes) triple, so Stop/Start
    with unchanged settings resumes accumulation (SURVEY §5 checkpoint
    analog); changing settings resets it (initAcu)."""

    def __init__(self, width: int = 320, height: int = 240, bounces: int = 5,
                 chunk_passes: int = 4, scenes: dict | None = None):
        self.width, self.height, self.bounces = width, height, bounces
        self.chunk_passes = chunk_passes
        self.scene_names = list(scenes) if scenes else ["cornell", "spheres"]
        # entries with a path value are XML files; None = builtin name
        self._extra_scenes = {k: v for k, v in (scenes or {}).items() if v}
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._running = False
        self._png = b""
        self._img = None
        self._png_frame = -1
        self._frame = 0
        self._passes = 0
        self._msegs = 0.0
        self._settings = None
        self._scene_cache: dict = {}
        self._engine = "?"
        self._angle = 0.0

    # -- rendering ---------------------------------------------------------

    def _load(self, name: str):
        if name in self._extra_scenes:
            from .io.scene_xml import load_scene
            return load_scene(self._extra_scenes[name],
                              self.width, self.height)
        from .cli import load_named_scene
        return load_named_scene(name, self.width, self.height)

    def _scene_for(self, name: str):
        """Load + accel-prepare a scene ONCE per session (the reference
        loads the scene and bins its grids in preRender, not per frame —
        code.js:1784-1804)."""
        sc = self._scene_cache.get(name)
        if sc is None:
            from .accel import prepare_grids
            sc = prepare_grids(self._load(name), "auto", mesh_slabs="auto")
            self._scene_cache[name] = sc
        return sc

    def _cfg(self, scene, spp: int):
        from . import RenderConfig
        from .render import route

        # grids pay once the tables outgrow brute force
        n_objects = scene.spheres.count + scene.triangles.count \
            + sum(m.tris.count for m in scene.meshes)
        cfg = RenderConfig(width=self.width, height=self.height, spp=spp,
                           bounces=self.bounces, use_grid=n_objects > 64)
        self._engine = route.forward(scene, cfg)
        return cfg

    def _publish(self, img) -> None:
        # LAZY publish (round 5): store the device-side image and bump the
        # frame counter; the host fetch + PNG encode (~0.5 s at 1024^2 on
        # this box — 35x one render chunk) happens only when a client
        # actually requests /frame.png, once per frame (cached). The
        # reference pays putImageData every pass (code.js:1530-1537); we
        # don't have to.
        with self._lock:
            self._img = img
            self._frame += 1

    def step(self, scene="cornell", renderer="path", spp=1,
             focal=None, lens=None, n_passes=1, orbit=False) -> None:
        """One synchronous chunk (used by the loop and by tests). Renders
        through the same entry points as the CLI and the bench, so the
        route is the one render.route names — the reference's L5 always
        drove its real kernels progressively (code.js:1861-1870)."""
        import jax.numpy as jnp

        from . import replace
        from .render import pathtracer

        sc = self._scene_for(scene)
        if focal:
            sc = replace(sc, focal_length=jnp.float32(focal))
        if lens:
            sc = replace(sc, lens_radius=jnp.float32(lens / 2))
        cfg = self._cfg(sc, spp)
        if orbit:
            # ref Assign02 rotate (code.js:55-98): orbit the eye around
            # the scene; each chunk restarts accumulation (camera moved)
            self._angle = (self._angle + 3.0 * n_passes) % 360.0
            cam = sc.camera.orbit(sc.bounds, self._angle)
            sc = replace(sc, camera=cam)
        key = (scene, renderer, spp, focal, lens, orbit)
        changed = self._settings != key
        if changed or orbit:            # settings change -> initAcu;
            self._settings = key        # orbit: camera moved every chunk
            self._state = pathtracer.init_state(cfg)
            if changed:
                self._passes = 0
        if renderer == "fake":
            # Assign01/02 analog: fake depth shade of the sphere set
            from .render.simple import render_fake_shade
            cam = replace(sc.camera, cols=cfg.width, rows=cfg.height)
            colors = sc.materials[sc.spheres.mat_id][:, :3]
            img = render_fake_shade(cam, sc.spheres, colors)
            self._engine = "xla"
            self._passes += n_passes
            self._publish(img)
            return
        if renderer == "direct":
            from .render.direct import render_direct
            img = render_direct(sc, cfg, n_passes=n_passes)
            self._passes += n_passes
            self._publish(img)
            return
        self._state = pathtracer.render_passes(sc, self._state, cfg, n_passes)
        self._passes = int(self._state["passes"])
        self._publish(pathtracer.image(self._state, cfg))

    def _loop(self, device: int = 0, **kw) -> None:
        import jax

        n_lights = 1
        try:
            n_lights = int(self._scene_for(kw["scene"]).lights.count)
        except Exception:
            pass
        # ISSUED wavefront segments per pass (what the kernels actually
        # dispatch): path = primary + per-light shadow at every depth;
        # direct = primary + per-light shadow; fake = primary only
        rays = self.width * self.height * max(kw["spp"], 1)
        if kw.get("renderer") == "direct":
            segs = rays * (1 + n_lights)
        elif kw.get("renderer") == "fake":
            segs = rays
        else:
            segs = rays * (1 + n_lights + self.bounces * (1 + n_lights))
        devs = jax.devices()
        dev = devs[device] if 0 <= device < len(devs) else devs[0]
        self._device = f"{dev.platform}:{dev.id}"
        with jax.default_device(dev):
            while self._running:
                t0 = time.time()
                self.step(n_passes=self.chunk_passes, **kw)
                dt = max(time.time() - t0, 1e-9)
                self._msegs = segs * self.chunk_passes / dt / 1e6

    # -- controls (ref startRender/stopRender code.js:1872-1894) -----------

    def start(self, **kw) -> None:
        self.stop()
        self._running = True
        self._thread = threading.Thread(target=self._loop, kwargs=kw,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def status(self) -> dict:
        import jax
        with self._lock:
            dev = getattr(self, "_device", None) \
                or jax.devices()[0].platform
            return {"running": self._running, "passes": self._passes,
                    "frame": self._frame, "msegs_per_s": self._msegs,
                    "device": dev, "engine": self._engine}

    @staticmethod
    def devices() -> list:
        """Compute-device inventory for the UI select (the reference's
        findWebCLDevices populating its device <select>, code.js:466-505)."""
        import jax
        return [f"[{d.id}] {d.platform}: {d.device_kind}"
                for d in jax.devices()]

    def frame_png(self) -> bytes:
        import numpy as np

        from .io.png import encode_png
        with self._lock:
            img = self._img
            frame = self._frame
            if img is None:
                return self._png
            if frame == self._png_frame and self._png:
                return self._png
        png = encode_png(np.asarray(img))      # fetch+encode outside lock
        with self._lock:
            if frame >= self._png_frame:
                self._png = png
                self._png_frame = frame
        return png


def make_server(session: RenderSession, port: int = 8000,
                host: str = "127.0.0.1") -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):       # quiet
            pass

        def _send(self, body: bytes, ctype: str, code: int = 200) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            if url.path == "/":
                self._send(INDEX_HTML.encode(), "text/html")
            elif url.path == "/scenes":
                self._send(json.dumps(session.scene_names).encode(),
                           "application/json")
            elif url.path == "/status":
                self._send(json.dumps(session.status()).encode(),
                           "application/json")
            elif url.path == "/frame.png":
                png = session.frame_png()
                if png:
                    self._send(png, "image/png")
                else:
                    self._send(b"no frame yet", "text/plain", 404)
            elif url.path == "/devices":
                self._send(json.dumps(session.devices()).encode(),
                           "application/json")
            elif url.path == "/start":
                sq = max(int(q.get("sqspp") or 1), 1)
                session.start(
                    scene=q.get("scene", "cornell"),
                    renderer=q.get("renderer", "path"),
                    spp=sq * sq,        # forced square, ref code.js:516-529
                    focal=float(q["focal"]) if q.get("focal") else None,
                    lens=float(q["lens"]) if q.get("lens") else None,
                    device=int(q.get("device") or 0),
                    orbit=bool(q.get("orbit")))
                self._send(b"started", "text/plain")
            elif url.path == "/stop":
                session.stop()
                self._send(b"stopped", "text/plain")
            else:
                self._send(b"not found", "text/plain", 404)

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="raytracing_tpu.viewer",
                                description="live progressive web viewer")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--bounces", type=int, default=5)
    p.add_argument("--chunk-passes", type=int, default=4)
    p.add_argument("--scene-xml", action="append", default=[],
                   help="extra XML scene file(s) to add to the scene select")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    from .utils.cache import enable_compilation_cache
    enable_compilation_cache()

    import os
    extra = {os.path.splitext(os.path.basename(p))[0]: p
             for p in args.scene_xml}
    scenes = {"cornell": None, "spheres": None, **extra} if extra else None
    session = RenderSession(width=args.width, height=args.height,
                            bounces=args.bounces,
                            chunk_passes=args.chunk_passes, scenes=scenes)
    srv = make_server(session, args.port, args.host)
    print(f"viewer at http://{args.host}:{args.port}  (Ctrl-C to quit)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        session.stop()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
