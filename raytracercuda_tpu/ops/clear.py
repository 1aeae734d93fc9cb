"""Framebuffer clear.

Equivalent of ``bmKernelClear``/``bmClear`` (`Raytracer/RTClear.cu:8-48`):
fill the packed-u32 framebuffer with a constant.  XLA emits the fill as one
kernel.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnames=("num_pixels",))
def _fill(num_pixels: int, value) -> jnp.ndarray:
    return jnp.full((num_pixels,), value, jnp.uint32)


def clear_buffer(num_pixels: int, value) -> jnp.ndarray:
    """Return a ``[num_pixels]`` u32 buffer filled with ``value``."""
    # np.uint32 first: a Python int above 2**31 overflows jit's int32
    # argument conversion.
    return _fill(num_pixels, np.uint32(value))
