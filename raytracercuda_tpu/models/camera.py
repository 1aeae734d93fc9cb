"""Pinhole camera with a precomputed normalized ray grid.

Analog of ``ICamera``/``Camera`` (`Raytracer/Beam.h:65-72`,
`Raytracer/Camera.cpp`).  The reference precomputes per-pixel normalized ray
directions on the CPU in a double loop and uploads once
(`Camera.cpp:51-69`); here the same math is a single vectorized jnp
expression.  ``trace_scene`` forwards to the scene's march exactly as
`Camera.cpp:85-97` does.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..errors import (
    ERROR_ALL_FINE,
    ERROR_INVALID_PARAMETER,
    ERROR_NO_RENDER_TARGET,
)


def camera_ray_grid(
    width: int,
    height: int,
    left: float = -1.0,
    right: float = 1.0,
    top: float = 1.0,
    bottom: float = -1.0,
    zoom: float = 1.0,
) -> jnp.ndarray:
    """Normalized pinhole ray directions, ``[height*width, 3]`` float32.

    Vectorization of `Camera.cpp:51-68`: pixel centers sampled at half-step
    offsets, direction ``(rx, ry, zoom) / sqrt(zoom^2 + rx^2 + ry^2)``.
    Defaults mirror `Beam.h:69`.  Row-major, y-outer — identical addressing
    to the reference's ``y*width+x``.
    """
    dx = (right - left) / width
    dy = (bottom - top) / height
    rx = left + dx * (jnp.arange(width, dtype=jnp.float32) + 0.5)
    ry = top + dy * (jnp.arange(height, dtype=jnp.float32) + 0.5)
    gx = jnp.broadcast_to(rx[None, :], (height, width))
    gy = jnp.broadcast_to(ry[:, None], (height, width))
    gz = jnp.full((height, width), float(zoom), jnp.float32)
    d = 1.0 / jnp.sqrt(zoom * zoom + gx * gx + gy * gy)
    dirs = jnp.stack([gx * d, gy * d, gz * d], axis=-1)
    return dirs.reshape(height * width, 3)


def framing_eye(positions, dist: float = 2.0) -> jnp.ndarray:
    """Eye that frames a scene: backed off along -z from its AABB center
    by ``dist`` times its largest extent (looking down +z)."""
    p = np.asarray(positions)
    lo, hi = p.min(axis=0), p.max(axis=0)
    extent = float(np.max(hi - lo))
    return jnp.asarray((lo + hi) / 2 - np.array([0.0, 0.0, dist * extent]),
                       jnp.float32)


def orient_from_pan_pitch(pan: float, pitch: float) -> np.ndarray:
    """3x3 orientation = yaw(pan, +Y) @ pitch(pitch, +X) — the fly-camera
    matrix of `TestProgram/Program.cpp:253-255,326-328`.  Column-vector
    convention (dir' = orient @ dir), matching glm."""
    cy, sy = np.cos(pan), np.sin(pan)
    cp, sp = np.cos(pitch), np.sin(pitch)
    yaw = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    pit = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)
    return yaw @ pit


class Camera:
    """Host-side camera object (``ICamera`` parity)."""

    def __init__(self) -> None:
        # Reference defaults 1000x1000 (`Camera.cpp:33-36`).
        self.width = 1000
        self.height = 1000
        self.initial_rays: Optional[jnp.ndarray] = None

    @staticmethod
    def create() -> "Camera":
        """`Camera.cpp:26-29`."""
        return Camera()

    def set_initial_rays(
        self,
        width: int,
        height: int,
        left: float = -1.0,
        right: float = 1.0,
        top: float = 1.0,
        bottom: float = -1.0,
        zoom: float = 1.0,
    ) -> int:
        """`Camera.cpp:43-72` with the same validation and defaults."""
        if width == 0 or height == 0:
            return ERROR_INVALID_PARAMETER
        denom = np.sqrt(zoom * zoom)  # zoom==0 with rx==ry==0 would be inf
        if not np.isfinite(denom):
            return ERROR_INVALID_PARAMETER
        self.width = int(width)
        self.height = int(height)
        self.initial_rays = camera_ray_grid(width, height, left, right, top, bottom, zoom)
        if not bool(jnp.all(jnp.isfinite(self.initial_rays))):
            return ERROR_INVALID_PARAMETER
        return ERROR_ALL_FINE

    def clear(self, render_target, value: int) -> int:
        """`Camera.cpp:74-83` — clear the (global) render target."""
        if render_target is None:
            return ERROR_NO_RENDER_TARGET
        from ..ops.clear import clear_buffer

        render_target.buffer = clear_buffer(
            render_target.width * render_target.height, value
        )
        return ERROR_ALL_FINE

    def trace_scene(self, eye, orient, scene, render_target) -> int:
        """`Camera.cpp:85-97` — sanitize and forward to the scene march."""
        if eye is None or orient is None or scene is None:
            return ERROR_INVALID_PARAMETER
        if self.width == 0 or self.height == 0 or self.initial_rays is None:
            return ERROR_INVALID_PARAMETER
        return scene.march(eye, orient, self, render_target)
