"""Progressive accumulation rendering — the completed ``SceneProgressive``.

The reference allocates a progressive-refinement scene
(`Raytracer/SceneProgressive.cpp`) whose march never ran (`Trace2.cu`
launcher stubbed).  This module finishes the capability:
successive frames sample jittered sub-pixel ray grids and accumulate a
running mean.  Sample positions come from the deterministic Halton (2,3)
sequence — no RNG state, so accumulation is bit-stable run-to-run and
identical regardless of how ray tiles are sharded across chips
(SURVEY.md §7 hard-part #5: fixed-order accumulation for multi-chip
reproducibility).  The whole step is differentiable (it composes
``diff.render_grad.render_rgb``), giving averaged-image gradients for
BASELINE config #4.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..diff.render_grad import render_rgb
from ..models.scene import SceneData


def halton(index, base: int):
    """Halton radical inverse of ``index`` (traced int) in ``base``."""
    f = jnp.float32(1.0)
    r = jnp.float32(0.0)
    i = index

    def cond(state):
        i, _, _ = state
        return i > 0

    def body(state):
        i, f, r = state
        f = f / base
        r = r + f * (i % base)
        return i // base, f, r

    _, _, r = jax.lax.while_loop(cond, body, (i, f, r))
    return r


def jittered_ray_grid(
    width: int,
    height: int,
    jitter_x,
    jitter_y,
    left: float = -1.0,
    right: float = 1.0,
    top: float = 1.0,
    bottom: float = -1.0,
    zoom: float = 1.0,
) -> jnp.ndarray:
    """Pinhole grid sampled at sub-pixel offset (jx, jy) in [0,1) instead
    of the reference's fixed half-pixel centers (`Camera.cpp:51-68`)."""
    dx = (right - left) / width
    dy = (bottom - top) / height
    rx = left + dx * (jnp.arange(width, dtype=jnp.float32) + jitter_x)
    ry = top + dy * (jnp.arange(height, dtype=jnp.float32) + jitter_y)
    gx = jnp.broadcast_to(rx[None, :], (height, width))
    gy = jnp.broadcast_to(ry[:, None], (height, width))
    d = 1.0 / jnp.sqrt(zoom * zoom + gx * gx + gy * gy)
    dirs = jnp.stack([gx * d, gy * d, jnp.full_like(gx, zoom) * d], axis=-1)
    return dirs.reshape(height * width, 3)


class ProgressiveState(NamedTuple):
    accum: jnp.ndarray  # [R,3] running sum of samples
    count: jnp.ndarray  # scalar int32 samples so far

    @property
    def image(self) -> jnp.ndarray:
        return self.accum / jnp.maximum(self.count, 1).astype(jnp.float32)


def init_progressive(num_rays: int) -> ProgressiveState:
    return ProgressiveState(
        accum=jnp.zeros((num_rays, 3), jnp.float32),
        count=jnp.int32(0),
    )


@partial(
    jax.jit,
    static_argnames=("width", "height", "config", "shading", "with_shadows", "zoom"),
)
def progressive_step(
    state: ProgressiveState,
    scene: SceneData,
    accel,
    eye: jnp.ndarray,
    orient: jnp.ndarray,
    width: int,
    height: int,
    config: RenderConfig,
    shading: str = "lambert",
    with_shadows: bool = False,
    zoom: float = 1.0,
) -> ProgressiveState:
    """Accumulate one jittered sample frame into the running mean."""
    sample = state.count
    jx = halton(sample + 1, 2)
    jy = halton(sample + 1, 3)
    rays = jittered_ray_grid(width, height, jx, jy, zoom=zoom)
    # A jittered pinhole grid still shares one origin per tile, so the
    # dense tile fast path applies (frame_hw routes to it when the frame
    # divides the tile size).
    rgb = render_rgb(
        scene, accel, rays, eye, orient, config,
        shading=shading, with_shadows=with_shadows,
        frame_hw=(height, width),
    )
    return ProgressiveState(accum=state.accum + rgb, count=state.count + 1)
