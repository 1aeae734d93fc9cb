"""Animated rounded-square SDF "blob".

Equivalent of ``bmKernelBlob``/``bmStartBlob``
(`Raytracer/Blob.cu:5-69`), the reference's procedural-animation smoke
test: a rotating rounded-square signed distance field smoothstep-mixed
over a vignetted background.  The animation time is a traced scalar, so
frames don't recompile.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from .math import pack_rgb


def _square_sdf(ux, uy, hx, hy):
    """`Blob.cu:5-11`: rounded-square distance."""
    dx = jnp.abs(ux) - hx
    dy = jnp.abs(uy) - hy
    t = jnp.minimum(0.0, jnp.maximum(dx, dy))
    lx = jnp.maximum(dx, 0.0)
    ly = jnp.maximum(dy, 0.0)
    return t + jnp.sqrt(lx * lx + ly * ly)


def _smoothstep(e0, e1, x):
    t = jnp.clip((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def blob_values(i: jnp.ndarray, w: int, h: int, time) -> jnp.ndarray:
    """Packed u32 for linear indices (`Blob.cu:27-58`)."""
    size = w * h
    i = jnp.minimum(i, size)
    ux = (i % w).astype(jnp.float32) - (w // 2)
    uy = (i // w).astype(jnp.float32) - (h // 2)
    s, c = jnp.sin(time), jnp.cos(time)
    rx = c * ux - s * uy
    ry = s * ux + c * uy
    ry = ry * 2.0
    d = _square_sdf(rx, ry, 100.0, 100.0)
    f = 1.0 - _smoothstep(-1.0, 1.0, d)
    shade = 1.0 - jnp.clip(d / 1500.0, 0.0, 1.0)
    bg = shade * shade  # pow(s,2) * white background
    # mix(bg, red, f) componentwise: red = (1,0,0).
    mr = bg * (1.0 - f) + 1.0 * f
    mg = bg * (1.0 - f)
    mb = bg * (1.0 - f)
    return pack_rgb(mr, mg, mb)


@partial(jax.jit, static_argnames=("width", "height"))
def blob(width: int, height: int, time) -> jnp.ndarray:
    """``bmStartBlob`` analog: ``[width*height]`` packed u32 at ``time``."""
    idx = jnp.arange(width * height, dtype=jnp.int32)
    return blob_values(idx, width, height, jnp.asarray(time, jnp.float32))
