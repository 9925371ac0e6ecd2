"""Interactive viewer — counterpart of `app/viewer.py`: live browser-fed
frame stream + fly camera.

The headless-compatible re-expression of the reference's Win32 window shell
(`Engine/Source/App.cpp:117-145` WASD/RMB fly camera, `:382-404` title-bar
fps/cull stats): a stdlib HTTP server streams rendered frames to a browser
page whose JS captures the same inputs and posts them back.

* WASD move in camera space at the reference's 0.05 units/frame
  (App.cpp:125-145: delta rotated by the camera world matrix);
* right-mouse drag rotates at 0.1 deg/pixel (App.cpp:119-123);
* the stats line mirrors UpdateFrameStatus's window caption
  (fps / time / culled / drawn).

Frames are rendered on the HTTP server's handler threads, one at a time
(`ViewerState.lock`), so the first frame, and with it the kernels' first-use
build (`kernels/build.py`, locked per process) and their grid caches
(`csrc/persistent_grid.cuh`, under a mutex), is reached from a thread that
is not the main one. Each frame is copied to the host with `.cpu().numpy()`
and encoded as a JPEG.

Run: python -m direct12pbrrenderer_tpu_torch.app --serve 8080 [--asset-root ...]
then open http://localhost:8080/.
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..utils.mathlib import Deg2Rad

_PAGE = """<!DOCTYPE html>
<html><head><title>direct12pbrrenderer_tpu</title><style>
body { margin: 0; background: #111; color: #ddd; font: 13px monospace; }
#bar { padding: 4px 8px; background: #222; }
img { display: block; outline: none; }
</style></head><body>
<div id="bar">connecting…</div>
<img id="view" draggable="false" oncontextmenu="return false;">
<script>
const keys = {};
let rmb = false, dx = 0, dy = 0;
window.addEventListener('keydown', e => { keys[e.key.toLowerCase()] = true; });
window.addEventListener('keyup',   e => { keys[e.key.toLowerCase()] = false; });
const img = document.getElementById('view');
img.addEventListener('mousedown', e => { if (e.button === 2) rmb = true; });
window.addEventListener('mouseup', e => { if (e.button === 2) rmb = false; });
window.addEventListener('mousemove', e => { if (rmb) { dx += e.movementX; dy += e.movementY; } });
async function pump() {
  while (true) {
    const input = { w: !!keys['w'], a: !!keys['a'], s: !!keys['s'], d: !!keys['d'],
                    rmb: rmb, dx: dx, dy: dy };
    dx = 0; dy = 0;
    try {
      const r = await fetch('/step', { method: 'POST', body: JSON.stringify(input) });
      const meta = JSON.parse(r.headers.get('X-Stats'));
      document.getElementById('bar').textContent = meta.caption;
      const blob = await r.blob();
      const url = URL.createObjectURL(blob);
      img.onload = () => URL.revokeObjectURL(url);
      img.src = url;
    } catch (err) { await new Promise(res => setTimeout(res, 500)); }
  }
}
pump();
</script></body></html>
"""


class ViewerState:
    """Camera + render loop state shared between HTTP threads."""

    def __init__(self, app):
        self.app = app
        self.lock = threading.Lock()  # one render at a time
        self.t0 = time.perf_counter()
        self.frame_times: list[float] = []

    def step(self, inp: dict) -> tuple[bytes, str]:
        from PIL import Image

        cam = self.app.camera
        pipe = self.app.pipeline
        with self.lock:
            # App::Update input semantics
            if inp.get("rmb"):
                ddx = float(inp.get("dx", 0.0)) * 0.1
                ddy = float(inp.get("dy", 0.0)) * 0.1
                cam.rotate(0.0, ddx * Deg2Rad, ddy * Deg2Rad)
            delta = np.zeros(3, np.float32)
            if inp.get("w"):
                delta[2] += 1
            if inp.get("s"):
                delta[2] -= 1
            if inp.get("a"):
                delta[0] -= 1
            if inp.get("d"):
                delta[0] += 1
            if delta.any():
                world = np.asarray(cam.world_matrix())
                cam.move(world[:3, :3] @ (delta * 0.05))

            t0 = time.perf_counter()
            img = pipe.render(cam, delta_time=1.0 / 60.0).cpu().numpy()  # sync
            self.frame_times.append(time.perf_counter() - t0)
            self.frame_times = self.frame_times[-30:]

        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=85)
        stats = pipe.last_stats
        fps = 1.0 / max(np.mean(self.frame_times), 1e-6)
        vis = getattr(stats, "visible_instances", 0)
        culled = getattr(stats, "total_instances", vis) - vis
        caption = (
            f"direct12pbrrenderer_tpu    fps: {fps:.1f}"
            f"    time {time.perf_counter() - self.t0:.1f}"
            f" culled: {culled} drawed: {vis}"
        )
        return buf.getvalue(), caption


def serve(app, port: int = 8080, host: str = "127.0.0.1"):
    state = ViewerState(app)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                body = _PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_error(404)

        def do_POST(self):
            if self.path != "/step":
                self.send_error(404)
                return
            n = int(self.headers.get("Content-Length", 0))
            try:
                inp = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError:
                inp = {}
            jpeg, caption = state.step(inp)
            self.send_response(200)
            self.send_header("Content-Type", "image/jpeg")
            self.send_header("Content-Length", str(len(jpeg)))
            self.send_header("X-Stats", json.dumps({"caption": caption}))
            self.end_headers()
            self.wfile.write(jpeg)

    httpd = ThreadingHTTPServer((host, port), Handler)
    print(f"viewer at http://{host}:{port}/ (WASD move, right-drag look)")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
