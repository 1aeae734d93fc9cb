"""Forward render pipeline: camera rays -> closest hit -> shade -> packed u32.

The fusion of the reference's frame path
(`Camera::traceScene` -> `Scene*::march` -> march kernel -> shade,
`Camera.cpp:85-97`, `SceneTree.cpp:109-127`, `BuildTree.cu:367-499`): one
jitted function from ray grid to framebuffer, with the acceleration-structure
backend dispatched on config.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.lax import Precision

from ..config import AccelKind, RenderConfig
from ..models.scene import SceneData
from ..types import Hit


def rotate_rays(initial_rays: jnp.ndarray, orient: jnp.ndarray) -> jnp.ndarray:
    """Apply the camera orientation to the precomputed ray grid:
    ``dir = orient * initialRays[i]`` (`BuildTree.cu:377-378`).  ``orient``
    is 3x3 column-vector convention, so batched form is ``rays @ orient.T``."""
    return jnp.matmul(initial_rays, orient.T, precision=Precision.HIGHEST)


def trace_hit(
    scene: SceneData,
    accel,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    config: RenderConfig,
    frame_hw: tuple[int, int] | None = None,
    common_origin: jnp.ndarray | None = None,
) -> Hit:
    """Closest-hit dispatch over the configured acceleration backend.

    ``frame_hw`` + ``common_origin`` unlock the beam fast path for
    pinhole frames (one traversal per pixel tile)."""
    kind = config.accel
    if kind == AccelKind.BRUTE or accel is None:
        from .bruteforce import trace_brute

        return trace_brute(scene.positions, scene.faces, origin, direction, config.trace)
    if kind == AccelKind.CLUSTER:
        tc = config.trace
        if frame_hw is not None and common_origin is not None:
            from .dense import trace_dense

            return trace_dense(
                accel, common_origin, direction,
                height=frame_hw[0], width=frame_hw[1],
                tile_px=tc.dense_tile_px, round_k=tc.dense_round_clusters,
                tiles_per_chunk=tc.dense_tiles_per_chunk,
                cluster_chunk=tc.dense_cluster_chunk, trace_cfg=tc,
            )
        # Arbitrary bundles (no shared origin / frame) take the exact
        # per-ray cluster sweep.
        from .dense import trace_clusters_rays

        return trace_clusters_rays(accel, origin, direction, config.trace)
    if kind == AccelKind.BVH:
        tc = config.trace
        if (
            tc.use_beam
            and frame_hw is not None
            and common_origin is not None
            and frame_hw[0] % tc.beam_tile == 0
            and frame_hw[1] % tc.beam_tile == 0
        ):
            from .beam import trace_beam

            return trace_beam(
                accel, common_origin, direction,
                height=frame_hw[0], width=frame_hw[1],
                tile_px=tc.beam_tile, queue=tc.beam_queue,
                cfg=config.bvh, trace_cfg=tc,
                tiles_per_chunk=tc.beam_tiles_per_chunk,
            )
        from .traverse import trace_bvh

        return trace_bvh(accel, scene.positions, scene.faces, origin, direction,
                         config.bvh, config.trace)
    if kind == AccelKind.GRID:
        from .grid_march import trace_grid

        return trace_grid(accel, scene.positions, scene.faces, origin, direction,
                          config.grid, config.trace)
    if kind == AccelKind.WAVEFRONT:
        from .wavefront import trace_wavefront

        return trace_wavefront(accel, scene.positions, scene.faces, origin, direction,
                               config.bvh, config.trace)
    raise ValueError(f"unknown accel kind {kind}")


@partial(jax.jit, static_argnames=("config", "frame_hw"))
def trace_to_buffer(
    scene: SceneData,
    accel,
    initial_rays: jnp.ndarray,
    eye: jnp.ndarray,
    orient: jnp.ndarray,
    config: RenderConfig,
    frame_hw: tuple[int, int] | None = None,
) -> jnp.ndarray:
    """Full parity frame: returns the ``[R]`` packed-u32 framebuffer the
    reference's march kernels write (`BuildTree.cu:486-496`)."""
    from .shade import shade_normal_packed

    dirs = rotate_rays(initial_rays, orient)
    origin = jnp.broadcast_to(eye[None, :], dirs.shape)
    hit = trace_hit(scene, accel, origin, dirs, config,
                    frame_hw=frame_hw, common_origin=eye)
    return shade_normal_packed(scene, hit)
