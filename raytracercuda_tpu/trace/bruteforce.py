"""Brute-force (all-pairs) closest-hit tracer — the correctness oracle.

This plays the role of the reference's CPU fallback backend
(``#define CUDA 0``, `Raytracer/CudaComon.cuh:36-56` + the serial loops in
every launcher, e.g. `BuildTree.cu:521-541`) and of the dead brute-force
kernel `Raytracer/Trace.cu:39-185`: intersect every ray against every
triangle, keep the closest.  It is a tiled sweep — ray tiles by
triangle chunks, pure elementwise work — rather than one thread per ray.

Every acceleration structure is validated allclose against this tracer.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import TraceConfig
from ..ops.math import tri_intersect
from ..types import FLT_MAX, Hit


def _pad_axis0(x, multiple, fill):
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x
    pad_width = [(0, rem)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad_width, constant_values=fill)


def trace_brute(
    positions: jnp.ndarray,
    faces: jnp.ndarray,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    cfg: TraceConfig = TraceConfig(),
) -> Hit:
    """Closest hit of each ray against all faces.

    Args:
      positions: ``[V,3]`` float32.
      faces: ``[F,4]`` int32 face table.
      origin/direction: ``[R,3]`` rays (origin may broadcast from ``[3]``).
      cfg: trace options (tiling, backward-hit clipping).

    Returns:
      ``Hit`` with fields of shape ``[R]``.
    """
    num_rays = direction.shape[0]
    if origin.ndim == 1:
        origin = jnp.broadcast_to(origin[None, :], direction.shape)

    v0 = positions[faces[:, 0]]
    v1 = positions[faces[:, 1]]
    v2 = positions[faces[:, 2]]

    chunk = min(cfg.tile_faces, max(v0.shape[0], 1))
    # Pad faces with degenerate triangles (NaN barycentrics -> miss).
    v0p = _pad_axis0(v0, chunk, 0.0)
    v1p = _pad_axis0(v1, chunk, 0.0)
    v2p = _pad_axis0(v2, chunk, 0.0)
    num_chunks = v0p.shape[0] // chunk
    fids = jnp.arange(v0p.shape[0], dtype=jnp.int32).reshape(num_chunks, chunk)
    v0c = v0p.reshape(num_chunks, chunk, 3)
    v1c = v1p.reshape(num_chunks, chunk, 3)
    v2c = v2p.reshape(num_chunks, chunk, 3)

    tile = min(cfg.tile_rays_brute, max(num_rays, 1))
    o_p = _pad_axis0(origin, tile, 0.0)
    d_p = _pad_axis0(direction, tile, 1.0)
    num_tiles = o_p.shape[0] // tile
    o_t = o_p.reshape(num_tiles, tile, 3)
    d_t = d_p.reshape(num_tiles, tile, 3)

    t_eps = jnp.float32(cfg.t_epsilon)

    def tile_fn(tile_rays):
        o, d = tile_rays

        def chunk_body(carry, chunk_data):
            bt, bu, bv, bf = carry
            cv0, cv1, cv2, cid = chunk_data
            t, u, v = tri_intersect(
                o[:, None, :], d[:, None, :], cv0[None], cv1[None], cv2[None]
            )
            if cfg.clip_backward_hits:
                t = jnp.where(t < t_eps, FLT_MAX, t)
            j = jnp.argmin(t, axis=1)
            rows = jnp.arange(t.shape[0])
            ct, cu, cv = t[rows, j], u[rows, j], v[rows, j]
            cf = cid[j]
            upd = ct < bt
            return (
                jnp.where(upd, ct, bt),
                jnp.where(upd, cu, bu),
                jnp.where(upd, cv, bv),
                jnp.where(upd, cf, bf),
            ), None

        init = (
            jnp.full((tile,), FLT_MAX, jnp.float32),
            jnp.zeros((tile,), jnp.float32),
            jnp.zeros((tile,), jnp.float32),
            jnp.full((tile,), -1, jnp.int32),
        )
        (bt, bu, bv, bf), _ = jax.lax.scan(
            chunk_body, init, (v0c, v1c, v2c, fids)
        )
        bf = jnp.where(bt == FLT_MAX, -1, bf)
        return bt, bu, bv, bf

    bt, bu, bv, bf = jax.lax.map(tile_fn, (o_t, d_t))
    flat = lambda x: x.reshape(-1)[:num_rays]
    return Hit(t=flat(bt), u=flat(bu), v=flat(bv), face=flat(bf))


def any_hit_brute(
    positions: jnp.ndarray,
    faces: jnp.ndarray,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    t_max: jnp.ndarray,
    cfg: TraceConfig = TraceConfig(),
) -> jnp.ndarray:
    """Occlusion query for shadow rays: True where ANY face is hit with
    ``t_eps < t < t_max``.  (The reference has no shadow rays; BASELINE
    config #3 demands them.)"""
    hit = trace_brute(positions, faces, origin, direction, cfg)
    return (hit.t > cfg.t_epsilon) & (hit.t < t_max)
