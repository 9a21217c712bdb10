"""Interactive progressive viewer — the windowed-app capability.

The reference's bin/src/app.rs runs a winit window: per-frame
acquire->render->present progressively refines the image (app.rs:286-305),
'o' opens a file dialog to hot-swap scenes keeping the old one on errors
(app.rs:263-283, 225-234), and resizing restarts accumulation
(app.rs:239-242).  The equivalent here is a tiny HTTP viewer: a
render thread refines batch by batch while a browser polls the current
accumulation; scene hot-swap (explicit or by watching the file's mtime)
and resize-restart follow the same semantics.

    python -m raytrace_tpu.cli view scene.json [--port 8000]

Endpoints: `/` (auto-refreshing page), `/image.png` (current
accumulation), `/status` (JSON), `/reload?path=` (hot-swap; errors keep
the old scene), `/resize?width=&height=` (restart accumulation).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

log = logging.getLogger("raytrace_tpu")

_PAGE = """<!doctype html>
<html><head><title>raytrace_tpu viewer</title><style>
body {{ background:#111; color:#ddd; font-family:monospace; }}
img {{ image-rendering:pixelated; border:1px solid #444; }}
</style></head><body>
<h3>raytrace_tpu — {scene}</h3>
<div id="status">…</div>
<p><img id="view" width="{dw}" src="/image.png"></p>
<form action="/resize"><input name="width" placeholder="width" size="6">
<input name="height" placeholder="height" size="6">
<button>resize (restarts)</button></form>
<form action="/reload"><input name="path" placeholder="scene path" size="48">
<button>load scene</button></form>
<script>
async function tick() {{
  const s = await (await fetch('/status')).json();
  document.getElementById('status').textContent =
    `batch ${{s.batch}}/${{s.total_batches}} — ` +
    `${{s.mrays_per_sec.toFixed(1)}} Mrays/s — ${{s.width}}x${{s.height}}`;
  document.getElementById('view').src = '/image.png?b=' + s.batch +
    '&g=' + s.generation;
}}
setInterval(tick, 1000); tick();
</script></body></html>"""


class ViewerState:
    """Shared state between the render thread and HTTP handlers."""

    def __init__(self, scene_path: str, width=None, height=None):
        self.lock = threading.Lock()
        self.scene_path = os.path.abspath(scene_path)
        self.width = width
        self.height = height
        self.renderer = None
        self.generation = 0          # bumps on reload/resize
        self.error = None
        self.stop = False
        self._mtime = None
        self._pending = None         # (path, width, height) request
        self._build()

    # -- build / swap -----------------------------------------------------

    def _build(self):
        from .engine import Renderer
        from .models import compile_scene
        from .scene_file import SceneFile

        sf = SceneFile.load_json(self.scene_path)
        sf.validate()
        cs = compile_scene(sf, width=self.width, height=self.height)
        renderer = Renderer(cs)
        with self.lock:
            self.renderer = renderer
            self.generation += 1
            self.error = None
            self._mtime = os.path.getmtime(self.scene_path)

    def request(self, path=None, width=None, height=None):
        self._pending = (path or self.scene_path,
                         width or self.width, height or self.height)

    def _apply_pending(self):
        """Hot-swap semantics: a bad scene file logs the error and keeps
        the current render going (app.rs:225-234)."""
        req, self._pending = self._pending, None
        if req is None:
            return
        old = (self.scene_path, self.width, self.height)
        try:
            self.scene_path, self.width, self.height = (
                os.path.abspath(req[0]), req[1], req[2])
            self._build()
            log.info("viewer: loaded %s", self.scene_path)
        except Exception as e:                        # noqa: BLE001
            self.scene_path, self.width, self.height = old
            with self.lock:
                self.error = str(e)
            log.error("viewer: scene load failed, keeping old scene: %s", e)

    # -- render loop ------------------------------------------------------

    def render_loop(self):
        while not self.stop:
            if self._pending is not None:
                self._apply_pending()
            try:
                mt = os.path.getmtime(self.scene_path)
                if self._mtime is not None and mt != self._mtime:
                    log.info("viewer: %s changed on disk, reloading",
                             self.scene_path)
                    self.request()
                    self._mtime = mt
                    continue
            except OSError:
                pass
            r = self.renderer
            if r.current_batch >= r.compiled.render.sample_batches:
                time.sleep(0.25)
                continue
            r.render_next_batch()

    # -- views ------------------------------------------------------------

    def png_bytes(self) -> bytes:
        from .utils.image import encode_png, to_srgb_u8

        with self.lock:
            img = np.asarray(self.renderer.accum)
        return encode_png(to_srgb_u8(img))

    def status(self) -> dict:
        with self.lock:
            r = self.renderer
            return {
                "scene": self.scene_path,
                "batch": r.current_batch,
                "total_batches": r.compiled.render.sample_batches,
                "width": r.static.width,
                "height": r.static.height,
                "mrays_per_sec": r.stats.mrays_per_sec,
                "generation": self.generation,
                "error": self.error,
            }


def _make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):                    # quiet
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Cache-Control", "no-store")
            if code == 302:
                self.send_header("Location", "/")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            if url.path == "/":
                st = state.status()
                dw = min(1024, 2 * st["width"])
                page = _PAGE.format(scene=os.path.basename(st["scene"]),
                                    dw=dw)
                self._send(200, "text/html", page.encode())
            elif url.path == "/image.png":
                self._send(200, "image/png", state.png_bytes())
            elif url.path == "/status":
                self._send(200, "application/json",
                           json.dumps(state.status()).encode())
            elif url.path == "/reload":
                state.request(path=q.get("path", [None])[0])
                self._send(302, "text/plain", b"")
            elif url.path == "/resize":
                def _i(k):
                    v = q.get(k, [None])[0]
                    return int(v) if v else None
                state.request(width=_i("width"), height=_i("height"))
                self._send(302, "text/plain", b"")
            else:
                self._send(404, "text/plain", b"not found")

    return Handler


class Viewer:
    """Render thread + HTTP server pair; `serve_forever` blocks."""

    def __init__(self, scene_path, width=None, height=None, port=8000,
                 host="127.0.0.1"):
        self.state = ViewerState(scene_path, width, height)
        self.httpd = ThreadingHTTPServer((host, port),
                                         _make_handler(self.state))
        self.port = self.httpd.server_address[1]
        self._render_thread = threading.Thread(
            target=self.state.render_loop, daemon=True)

    def start(self):
        self._render_thread.start()
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        log.info("viewer: http://127.0.0.1:%d/", self.port)

    def stop(self):
        self.state.stop = True
        self.httpd.shutdown()

    def serve_forever(self):
        self.start()
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            self.stop()
