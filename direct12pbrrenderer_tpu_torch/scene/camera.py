"""Fly camera (Renderer/Camera.h + Camera.cpp) — the port's copy of the JAX
package's `scene/camera.py` (same matrices).

World matrix = free TRS transform; view = QuickInverse(world); projection =
projection_matrix1 (z in [0,1]). Rotation accumulates roll/yaw/pitch and
rebuilds the basis via from_euler_angle(roll, yaw, pitch) exactly like
Camera::Rotate (Camera.cpp:5-12)."""

from __future__ import annotations

import numpy as np

from ..utils import mathlib as ml


class Camera:
    def __init__(self, fov: float, width: int, height: int, near: float, far: float):
        self.fov = float(fov)
        self.ratio = width / height
        self.near = float(near)
        self.far = float(far)
        self.roll = 0.0
        self.yaw = 0.0
        self.pitch = 0.0
        self.transform = ml.identity4()  # view space -> world space

    def move(self, delta) -> None:
        self.transform[:3, 3] += np.asarray(delta, np.float32)

    def move_local(self, delta, speed: float = 0.05) -> None:
        """WASD-style move along the camera basis (App.cpp:126-145)."""
        d = ml.transform_vector(self.transform, np.asarray(delta, np.float32) * speed)
        self.move(d)

    def rotate(self, roll: float, yaw: float, pitch: float) -> None:
        self.roll += roll
        self.yaw += yaw
        self.pitch += pitch
        rot = ml.from_euler_angle(self.roll, self.yaw, self.pitch)
        scale = np.linalg.norm(self.transform[:3, :3], axis=0)
        self.transform[:3, :3] = rot * scale[None, :]

    @property
    def position(self) -> np.ndarray:
        return self.transform[:3, 3].copy()

    def world_matrix(self) -> np.ndarray:
        return self.transform.copy()

    def view_matrix(self) -> np.ndarray:
        return ml.quick_inverse(self.transform)

    def projection_matrix(self) -> np.ndarray:
        return ml.projection_matrix1(self.fov, self.ratio, self.near, self.far)

    def view_proj(self) -> np.ndarray:
        return self.projection_matrix() @ self.view_matrix()

    def frustum_planes(self) -> np.ndarray:
        return ml.frustum_planes_from_matrix(self.view_proj())
