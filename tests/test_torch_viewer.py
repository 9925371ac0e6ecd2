"""The port's interactive viewer (`app/viewer.py`) on the CPU: its HTTP
endpoints and input rules (W/S/A/D move 0.05 along the camera axes,
right-drag turns 0.1 deg per pixel), with a stub pipeline and with a real
port pipeline at 160x120 on the CPU.

Each server binds a free ephemeral port of its own (never the JAX viewer
tests' 8765/8766, so the two files can run side by side) on a daemon
thread; the frames are rendered on the server's handler threads.
"""

import json
import socket
import threading
import time
import types
import urllib.request

import numpy as np
import torch

from direct12pbrrenderer_tpu_torch.app import viewer
from direct12pbrrenderer_tpu_torch.config import RenderConfig
from direct12pbrrenderer_tpu_torch.scene.camera import Camera
from direct12pbrrenderer_tpu_torch.tools.tiny_scene import tiny_pipeline

torch.set_num_threads(2)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(app) -> int:
    """`viewer.serve(app, port)` on a daemon thread; returns the port once
    the page answers."""
    port = free_port()
    threading.Thread(target=viewer.serve, args=(app, port), daemon=True).start()
    for _ in range(100):
        try:
            page = urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=5).read()
            break
        except OSError:
            time.sleep(0.1)
    assert b"direct12pbrrenderer_tpu" in page and b"/step" in page
    return port


def step(port, payload, timeout=120):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/step",
                                 data=json.dumps(payload).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read(), json.loads(r.headers["X-Stats"])["caption"]


def test_viewer_input_semantics_stub_pipeline():
    renders = []

    class StubStats:
        visible_instances = 3
        total_instances = 5

    class StubPipe:
        last_stats = StubStats()

        def render(self, cam, delta_time=1.0 / 60.0):
            renders.append(threading.current_thread())
            return torch.zeros((12, 16, 3), dtype=torch.uint8)

    cfg = RenderConfig(width=16, height=12)
    cam = Camera(cfg.fov, cfg.width, cfg.height, cfg.near, cfg.far)
    cam.move([0, 0, 4])
    app = types.SimpleNamespace(pipeline=StubPipe(), camera=cam)
    port = start(app)
    pos0 = np.asarray(cam.position).copy()
    jpeg, caption = step(port, {"w": True})
    assert jpeg[:2] == b"\xff\xd8"
    assert "fps" in caption and "culled: 2 drawed: 3" in caption
    pos1 = np.asarray(cam.position).copy()
    assert np.isclose(np.linalg.norm(pos1 - pos0), 0.05, atol=1e-5)
    # S undoes W, A and D move along the camera's x axis
    step(port, {"s": True})
    np.testing.assert_allclose(cam.position, pos0, atol=1e-6)
    step(port, {"d": True})
    right = np.asarray(cam.world_matrix())[:3, 0]
    np.testing.assert_allclose(np.asarray(cam.position) - pos0, 0.05 * right, atol=1e-6)
    step(port, {"a": True})
    np.testing.assert_allclose(cam.position, pos0, atol=1e-6)
    view0 = np.asarray(cam.view_matrix()).copy()
    step(port, {"rmb": True, "dx": 50, "dy": -20})
    np.testing.assert_allclose(cam.position, pos0, atol=1e-6)   # a turn does not move
    assert not np.allclose(np.asarray(cam.view_matrix()), view0)
    step(port, {"rmb": False, "dx": 50})                        # no turn without the button
    assert len(renders) == 6 and threading.main_thread() not in renders


def test_viewer_serves_port_pipeline_frames():
    pipe, cam, cfg = tiny_pipeline("cpu", width=160, height=120, tile_h=60, tile_w=160)
    app = types.SimpleNamespace(pipeline=pipe, camera=cam)
    port = start(app)
    pos0 = np.asarray(cam.position).copy()
    jpeg, caption = step(port, {"w": True})
    assert jpeg[:2] == b"\xff\xd8" and len(jpeg) > 500
    assert "fps" in caption and "culled: 0 drawed: 1" in caption
    pos1 = np.asarray(cam.position).copy()
    assert np.isclose(np.linalg.norm(pos1 - pos0), 0.05, atol=1e-5)
    # W moves along the camera's forward axis, toward the sphere at the origin
    assert np.linalg.norm(pos1) < np.linalg.norm(pos0)
    step(port, {"rmb": True, "dx": 100, "dy": 0})
    np.testing.assert_allclose(cam.position, pos1)
    _, caption = step(port, {})
    assert "drawed: 1" in caption
    assert pipe.last_stats.visible_instances == 1
