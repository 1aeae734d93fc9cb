"""FrameRenderer: the product path for pinhole frames.

The reference's hot path IS its product path (`SceneTree::march`,
`SceneTree.cpp:109-127`): applications call one method and get the
fastest kernel.  This module gives the framework the same property —
`bench.py`, the render CLI and `chip_smoke.py` all render through
FrameRenderer, so the benchmark measures the code every consumer runs.

One jitted program per frame: rotate the ray grid, closest hit through the
configured accel (`trace/pipeline.trace_hit`; for ``AccelKind.CLUSTER`` the
dense cull → compact → sweep of `trace/dense.py`), directional-light
occlusion, Lambert shading and the packed framebuffer.  Shade-attribute
tables are built ONCE per (scene, accel), not per frame.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..models.scene import SceneData
from ..ops.math import normalize
from ..types import FLT_MAX
from .bruteforce import any_hit_brute, trace_brute
from .dense import occlusion_dense
from .pipeline import rotate_rays, trace_hit
from .shade import build_face_tables, pack_shaded, shade_lambert_rgb


class FrameRenderer:
    """Render pinhole frames of one (scene, accel) pair at a fixed size."""

    def __init__(
        self,
        scene: SceneData,
        accel,
        config: RenderConfig,
        height: int,
        width: int,
        light_dir=(0.4, 0.8, -0.45),
        ambient: float = 0.08,
        background=(0.0, 1.0, 0.0),
        shadows: bool = True,
    ):
        self.scene = scene
        self.accel = accel
        self.config = config
        self.height, self.width = height, width
        self.ambient = float(ambient)
        self.background = jnp.asarray(background, jnp.float32)
        self.shadows = shadows
        self.light = normalize(jnp.asarray(light_dir, jnp.float32))
        lo = scene.positions.min(axis=0)
        hi = scene.positions.max(axis=0)
        self.extent = float(jnp.max(hi - lo))
        # Shadow-ray offset scaled to the scene: push the origin toward
        # the light far enough to clear the surface at float precision.
        self.shadow_eps = jnp.float32(config.trace.t_epsilon * self.extent)
        self.tile_px = config.trace.dense_tile_px
        self.tables = build_face_tables(scene)

    def shadow_origins(self, eye, dirs, hit):
        """Shadow-ray origins for a frame's hits (the eye where it missed),
        offset toward the light."""
        origin = jnp.broadcast_to(eye[None, :], dirs.shape)
        p = origin + dirs * jnp.minimum(hit.t, 1e6)[..., None]
        return (jnp.where(hit.hit_mask[..., None], p, origin)
                + self.light * self.shadow_eps)

    def _trace(self, scene, accel, rays, eye, orient):
        """``(dirs, hit, shadow)`` of one pose; ``shadow`` is None without
        shadows."""
        tc = self.config.trace
        dirs = rotate_rays(rays, orient)
        origin = jnp.broadcast_to(eye[None, :], dirs.shape)
        hit = trace_hit(scene, accel, origin, dirs, self.config,
                        frame_hw=(self.height, self.width),
                        common_origin=eye)
        if not self.shadows:
            return dirs, hit, None
        so = self.shadow_origins(eye, dirs, hit)
        if hasattr(accel, "cluster_size"):
            shadow = occlusion_dense(
                accel, so, self.light, hit.hit_mask,
                self.height, self.width, tile_px=self.tile_px,
                round_k=tc.dense_round_clusters,
                tiles_per_chunk=tc.dense_tiles_per_chunk,
                cluster_chunk=tc.dense_cluster_chunk, trace_cfg=tc)
        else:
            shadow = any_hit_brute(
                scene.positions, scene.faces, so,
                jnp.broadcast_to(self.light, dirs.shape),
                jnp.full(dirs.shape[:1], float(FLT_MAX)), tc)
            shadow = shadow & hit.hit_mask
        return dirs, hit, shadow

    def _shade(self, scene, eye, dirs, hit, shadow, tables=None):
        origin = jnp.broadcast_to(eye[None, :], dirs.shape)
        rgb = shade_lambert_rgb(scene, hit, origin, dirs,
                                light_dir=self.light, shadow_mask=shadow,
                                ambient=self.ambient,
                                background=self.background, tables=tables)
        return pack_shaded(rgb)

    @partial(jax.jit, static_argnums=0)
    def _frame(self, scene, accel, tables, rays, eye, orient):
        dirs, hit, shadow = self._trace(scene, accel, rays, eye, orient)
        return self._shade(scene, eye, dirs, hit, shadow, tables)

    def render(self, eye: jnp.ndarray, orient: jnp.ndarray,
               rays: jnp.ndarray) -> jnp.ndarray:
        """Packed-u32 row-major framebuffer for one camera pose.

        ``rays``: the precomputed pinhole ray grid (`camera_ray_grid`),
        row-major ``[H*W, 3]``."""
        return self._frame(self.scene, self.accel, self.tables, rays, eye,
                           orient)

    def hits(self, eye, orient, rays):
        """``(hit, shadow)`` exactly as `render` computes them."""
        return self._hits(self.scene, self.accel, rays, eye, orient)

    @partial(jax.jit, static_argnums=0)
    def _hits(self, scene, accel, rays, eye, orient):
        _, hit, shadow = self._trace(scene, accel, rays, eye, orient)
        return hit, shadow

    def oracle(self, eye, orient, rays, trace_cfg=None):
        """``(hit, shadow, packed)`` of the same frame composed from the
        brute-force oracle (`trace_brute` + `any_hit_brute`) and the same
        shading — the reference `render` is checked against.
        ``trace_cfg`` overrides the brute tiling (results do not depend
        on it)."""
        return self._oracle(self.scene, rays, eye, orient,
                            trace_cfg or self.config.trace)

    @partial(jax.jit, static_argnums=(0, 5))
    def _oracle(self, scene, rays, eye, orient, tc):
        dirs = rotate_rays(rays, orient)
        hit = trace_brute(scene.positions, scene.faces, eye, dirs, tc)
        shadow = None
        if self.shadows:
            shadow = any_hit_brute(
                scene.positions, scene.faces,
                self.shadow_origins(eye, dirs, hit),
                jnp.broadcast_to(self.light, dirs.shape),
                jnp.full(dirs.shape[:1], float(FLT_MAX)), tc)
            shadow = shadow & hit.hit_mask
        return hit, shadow, self._shade(scene, eye, dirs, hit, shadow)
