"""Six-band color gradient.

Equivalent of ``bmKernelColorGradient``/``bmStartColorGradient``
(`Raytracer/Gradient.cu:5-52`), the reference's simplest full-frame display
smoke test: the linear pixel index selects one of six color ramps
(R, G, B, RG, GB, RB), each fading 0..255 across its band.  Bit-identical
output to the CUDA kernel.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def gradient_values(i: jnp.ndarray, size: int) -> jnp.ndarray:
    """Packed u32 for linear indices ``i`` (`Gradient.cu:8-40`).

    Matches the CUDA kernel exactly, including ``i = i<size ? i : 0``
    clamping and the untouched (zero) band when ``size%6 != 0`` puts
    ``colorType`` past case 5.
    """
    i = jnp.where(i < size, i, 0)
    block = size // 6
    color_type = i // block
    # The value is in [0,255], so the int32 detour to u32 is exact.
    c = (
        ((i % block).astype(jnp.float32) / float(block) * 255.0)
        .astype(jnp.int32)
        .astype(jnp.uint32)
    )
    z = jnp.zeros_like(c)
    bands = [
        c << 16,
        c << 8,
        c,
        (c << 16) | (c << 8),
        (c << 8) | c,
        (c << 16) | c,
    ]
    out = z
    for k, band in enumerate(bands):
        out = jnp.where(color_type == k, band, out)
    return out


@partial(jax.jit, static_argnames=("width", "height"))
def color_gradient(width: int, height: int) -> jnp.ndarray:
    """``bmStartColorGradient`` analog: ``[width*height]`` packed u32."""
    size = width * height
    return gradient_values(jnp.arange(size, dtype=jnp.int32), size)
