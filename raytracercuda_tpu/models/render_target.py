"""Render target: the framebuffer as a device array.

Analog of ``IRenderTarget``/``RenderTarget``
(`Raytracer/Beam.h:32-45`, `Raytracer/RenderTarget.{h,cpp}`).  The reference
wraps a CUDA-mapped OpenGL texture-buffer object with lock/unlock map/unmap
semantics and a process-global "current RT" (`RenderTarget.cpp:53-91`).
Without GL, the render target is simply a packed-u32
framebuffer array that kernels produce, which can be gathered to host 0 and
written out as PNG (`utils/png.py`).  lock/unlock are kept for API parity
and enforce the same state machine (`ERROR_UNLOCK_FIRST`/`ERROR_LOCK_FIRST`,
`RenderTarget.cpp:53-83`), and the class-level "current" target mirrors the
global ``RenderTarget::get()``.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from ..errors import ERROR_ALL_FINE, ERROR_LOCK_FIRST, ERROR_UNLOCK_FIRST


class RenderTarget:
    _current: Optional["RenderTarget"] = None  # RenderTarget::m_RT analog

    def __init__(self, width: int, height: int):
        self.width = int(width)
        self.height = int(height)
        self.pitch = self.width * 4  # bytes per row, RGBA8 as in the GL TBO
        self.buffer: jnp.ndarray = jnp.zeros(self.width * self.height, jnp.uint32)
        self._locked = False

    @staticmethod
    def create(width: int, height: int) -> "RenderTarget":
        """``IRenderTarget::registerGLTBO`` analog (`RenderTarget.cpp:17-28`)
        minus the GL registration — allocates the framebuffer array."""
        return RenderTarget(width, height)

    def lock(self) -> int:
        """Map-for-writing (`RenderTarget.cpp:53-69`): becomes the global
        current target, double-lock is an error."""
        if self._locked:
            return ERROR_UNLOCK_FIRST
        self._locked = True
        RenderTarget._current = self
        return ERROR_ALL_FINE

    def unlock(self) -> int:
        """`RenderTarget.cpp:71-83`."""
        if not self._locked:
            return ERROR_LOCK_FIRST
        self._locked = False
        if RenderTarget._current is self:
            RenderTarget._current = None
        return ERROR_ALL_FINE

    @property
    def locked(self) -> bool:
        """Whether this target is currently mapped for writing."""
        return self._locked

    @staticmethod
    def get() -> Optional["RenderTarget"]:
        """Process-global current target (`RenderTarget.cpp:85-91`)."""
        return RenderTarget._current

    def image(self) -> jnp.ndarray:
        """Framebuffer as ``[H, W]`` packed u32."""
        return self.buffer.reshape(self.height, self.width)
