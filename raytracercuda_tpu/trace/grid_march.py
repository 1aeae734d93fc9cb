"""DDA cell-walking march over the hashed uniform grid.

Equivalent of ``bmMarchKernelSpace`` (`Raytracer/Hash.cu:235-302`):
each ray walks cells from the eye point — hash the current cell, test its
faces, else step through the cell via the exit-distance slab test plus a
pinch-through epsilon — capped at MAX_SEARCH_ITERS.  All rays step in
lockstep; the per-cell face sweep is a bounded masked loop whose trip count
is the max face count among the cells the active rays currently occupy.

Like the reference, a ray stops at the first cell where it finds a hit
(`Hash.cu:280`), which (also like the reference) inherits the hash
structure's approximation: hash collisions can surface far-away faces.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..accel.grid import HashGrid, hash3_cells, map_cell
from ..config import GridConfig, TraceConfig
from ..ops.math import box_ray_intersect_no_zero, tri_intersect
from ..types import FLT_MAX, Hit


@partial(jax.jit, static_argnames=("cfg", "trace_cfg"))
def trace_grid(
    grid: HashGrid,
    positions: jnp.ndarray,
    faces: jnp.ndarray,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    cfg: GridConfig = GridConfig(),
    trace_cfg: TraceConfig = TraceConfig(),
) -> Hit:
    if origin.ndim == 1:
        origin = jnp.broadcast_to(origin[None, :], direction.shape)
    num_rays = direction.shape[0]
    inv_dir = 1.0 / direction
    res = grid.cell_res
    eps = res * jnp.float32(cfg.pinch_epsilon_frac)
    t_eps = jnp.float32(trace_cfg.t_epsilon)
    num_entries = grid.entries.shape[0]

    def cond(state):
        iters, active, *_ = state
        return (iters < cfg.max_search_iters) & jnp.any(active)

    def body(state):
        iters, active, p, bt, bu, bv, bf = state
        cp = map_cell(p, res)
        h = hash3_cells(cp, cfg.num_cells)
        start = grid.cell_start[h]
        end = grid.cell_start[h + 1]
        count = jnp.minimum(end - start, cfg.max_faces_per_cell)
        kmax = jnp.max(jnp.where(active, count, 0))

        def face_loop(k, carry):
            bt, bu, bv, bf = carry
            in_range = active & (k < count)
            slot = jnp.clip(start + k, 0, num_entries - 1)
            fid = grid.entries[slot]
            frow = faces[fid]
            # Intersect with the ORIGINAL ray (eye, dir), as the reference
            # does (`Hash.cu:272`), not from the walked point p.
            t, u, v = tri_intersect(
                origin,
                direction,
                positions[frow[..., 0]],
                positions[frow[..., 1]],
                positions[frow[..., 2]],
            )
            if trace_cfg.clip_backward_hits:
                t = jnp.where(t < t_eps, FLT_MAX, t)
            closer = in_range & (t < bt)
            return (
                jnp.where(closer, t, bt),
                jnp.where(closer, u, bu),
                jnp.where(closer, v, bv),
                jnp.where(closer, fid, bf),
            )

        bt, bu, bv, bf = jax.lax.fori_loop(0, kmax, face_loop, (bt, bu, bv, bf))

        # Stop rays that found a hit in this cell (`Hash.cu:280`).
        found = bt < FLT_MAX
        # Advance the survivors through the cell (`Hash.cu:283-286`).
        bmin = cp.astype(jnp.float32) * res
        bmax = bmin + res
        box_d = box_ray_intersect_no_zero(bmin, bmax, p, inv_dir)
        p_new = p + direction * (box_d + eps)[..., None]
        still = active & ~found & jnp.all(jnp.isfinite(p_new), axis=-1)
        p = jnp.where(still[..., None], p_new, p)
        return iters + 1, still, p, bt, bu, bv, bf

    init = (
        jnp.int32(0),
        jnp.ones((num_rays,), bool),
        origin,
        jnp.full((num_rays,), FLT_MAX, jnp.float32),
        jnp.zeros((num_rays,), jnp.float32),
        jnp.zeros((num_rays,), jnp.float32),
        jnp.full((num_rays,), -1, jnp.int32),
    )
    _, _, _, bt, bu, bv, bf = jax.lax.while_loop(cond, body, init)
    bf = jnp.where(bt == FLT_MAX, -1, bf)
    return Hit(t=bt, u=bu, v=bv, face=bf)
