"""Stackless skip-link BVH traversal — the vectorized march kernel.

Replaces the reference's per-thread 38-deep-stack kd-tree descent
(`Raytracer/BuildTree.cu:367-499`).  A per-ray stack does not vectorize;
instead every ray carries ONE integer — its current node in the
threaded (hit-link/skip-link) LBVH — and a whole ray TILE steps in
lockstep: one packed-row gather per node visit, slab test, advance to
hit-link or skip-link, Möller-Trumbore the leaf's pre-sorted triangles,
keep the closest.

Performance structure (vs the naive formulation):
  * two row gathers per step (a [T,6] AABB row + a [T,2] int link row)
    instead of ~7 separate gathers — links stay integer because float rows
    can corrupt int payloads (NaN canonicalization, denormal flush);
  * leaf triangles pre-sorted in Morton order (`Bvh.packed_tris`) — the
    leaf sweep gathers contiguous rows with NO face-table indirection; the
    winning sorted slot maps to a face id once, at the end;
  * rays processed in tiles (`TraceConfig.tile_rays`) via ``lax.map`` —
    each tile's while_loop terminates at ITS deepest ray, not the frame's
    (camera tiles are coherent, so tails are short).

Where the reference early-breaks on the first leaf containing any hit
(`BuildTree.cu:427-431` — an approximation relying on near-to-far
ordering), this kernel prunes with the AABB entry distance against the
current best hit (exact closest-hit, strictly stronger).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..accel.bvh import Bvh, LEAF_PACK
from ..config import BvhConfig, TraceConfig
from ..ops.math import box_ray_intersect, tri_intersect
from ..types import FLT_MAX, Hit


def _pad_tile(origin, direction, tile):
    """Pad rays to a tile multiple with guaranteed-miss rays."""
    r = direction.shape[0]
    rem = (-r) % tile
    if rem:
        far = jnp.full((rem, 3), 3.0e18, jnp.float32)
        away = jnp.broadcast_to(jnp.array([1.0, 1.0, 1.0], jnp.float32), (rem, 3))
        origin = jnp.concatenate([origin, far])
        direction = jnp.concatenate([direction, away])
    return origin, direction, r


def _gather_node(bvh, nid):
    """One AABB row + one link row per node visit (links live in their own
    int32 array: float rows can corrupt int payloads via NaN
    canonicalization / denormal flush)."""
    row = bvh.packed_nodes[nid]
    links = bvh.packed_links[nid]
    return row[:, 0:3], row[:, 3:6], links[:, 0], links[:, 1]


def _closest_hit_tile(bvh: Bvh, origin, direction, cfg: BvhConfig,
                      trace_cfg: TraceConfig):
    """Closest-hit march for one ray tile ``[T,3]`` -> (t,u,v,slot)."""
    tile = direction.shape[0]
    inv_dir = 1.0 / direction
    t_eps = jnp.float32(trace_cfg.t_epsilon)
    num_slots = bvh.packed_tris.shape[0]

    def cond(state):
        step, cur, *_ = state
        return (step < cfg.max_iters) & jnp.any(cur >= 0)

    def body(state):
        step, cur, bt, bu, bv, bslot = state
        active = cur >= 0
        nmin, nmax, a, skip = _gather_node(bvh, jnp.maximum(cur, 0))
        box_d = box_ray_intersect(nmin, nmax, origin, inv_dir)
        # Prune: only enter boxes that could contain a closer hit.
        enter = active & (box_d < bt)
        leaf = a < 0
        enc = -a - 2
        first = enc // LEAF_PACK
        count = enc % LEAF_PACK
        at_leaf = enter & leaf
        # Bounded leaf sweep over Morton-contiguous triangle rows
        # (MAX_FACES_PER_BOX-bounded analog, `BuildTree.cu:413-426`).
        # fori (not Python unroll): max_leaf_faces can be large and the
        # trip count adapts to the widest leaf actually present.
        k_hi = jnp.max(jnp.where(at_leaf, count, 0))

        def leaf_body(k, carry):
            bt, bu, bv, bslot = carry
            in_range = at_leaf & (k < count)
            slot = jnp.clip(first + k, 0, num_slots - 1)
            trow = bvh.packed_tris[slot]
            t, u, v = tri_intersect(
                origin, direction, trow[:, 0:3], trow[:, 3:6], trow[:, 6:9]
            )
            if trace_cfg.clip_backward_hits:
                t = jnp.where(t < t_eps, FLT_MAX, t)
            closer = in_range & (t < bt)
            return (
                jnp.where(closer, t, bt),
                jnp.where(closer, u, bu),
                jnp.where(closer, v, bv),
                jnp.where(closer, slot, bslot),
            )

        bt, bu, bv, bslot = jax.lax.fori_loop(0, k_hi, leaf_body, (bt, bu, bv, bslot))
        nxt = jnp.where(enter & ~leaf, a, skip)
        cur = jnp.where(active, nxt, -1)
        return step + 1, cur, bt, bu, bv, bslot

    init = (
        jnp.int32(0),
        jnp.zeros((tile,), jnp.int32),  # start at the root
        jnp.full((tile,), FLT_MAX, jnp.float32),
        jnp.zeros((tile,), jnp.float32),
        jnp.zeros((tile,), jnp.float32),
        jnp.zeros((tile,), jnp.int32),
    )
    _, _, bt, bu, bv, bslot = jax.lax.while_loop(cond, body, init)
    return bt, bu, bv, bslot


@partial(jax.jit, static_argnames=("cfg", "trace_cfg"))
def trace_bvh(
    bvh: Bvh,
    positions: jnp.ndarray,
    faces: jnp.ndarray,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    cfg: BvhConfig = BvhConfig(),
    trace_cfg: TraceConfig = TraceConfig(),
) -> Hit:
    """Closest hit for ``[R,3]`` rays against the threaded LBVH.

    ``positions``/``faces`` are unused on the hot path (geometry is baked
    into ``bvh.packed_tris`` at build) but kept in the signature so all
    tracer backends are interchangeable.
    """
    del positions, faces
    if origin.ndim == 1:
        origin = jnp.broadcast_to(origin[None, :], direction.shape)
    num_rays = direction.shape[0]
    tile = min(trace_cfg.tile_rays, max(num_rays, 1))
    origin, direction, _ = _pad_tile(origin, direction, tile)
    num_tiles = direction.shape[0] // tile

    o_t = origin.reshape(num_tiles, tile, 3)
    d_t = direction.reshape(num_tiles, tile, 3)
    bt, bu, bv, bslot = jax.lax.map(
        lambda od: _closest_hit_tile(bvh, od[0], od[1], cfg, trace_cfg),
        (o_t, d_t),
    )
    flat = lambda x: x.reshape(-1)[:num_rays]
    bt, bu, bv, bslot = flat(bt), flat(bu), flat(bv), flat(bslot)
    bf = jnp.where(bt == FLT_MAX, -1, bvh.face_order[bslot])
    return Hit(t=bt, u=bu, v=bv, face=bf)


def _any_hit_tile(bvh: Bvh, origin, direction, t_max, cfg: BvhConfig,
                  trace_cfg: TraceConfig):
    tile = direction.shape[0]
    inv_dir = 1.0 / direction
    t_eps = jnp.float32(trace_cfg.t_epsilon)
    num_slots = bvh.packed_tris.shape[0]

    def cond(state):
        step, cur, _ = state
        return (step < cfg.max_iters) & jnp.any(cur >= 0)

    def body(state):
        step, cur, occluded = state
        active = cur >= 0
        nmin, nmax, a, skip = _gather_node(bvh, jnp.maximum(cur, 0))
        box_d = box_ray_intersect(nmin, nmax, origin, inv_dir)
        enter = active & (box_d < t_max)
        leaf = a < 0
        enc = -a - 2
        first = enc // LEAF_PACK
        count = enc % LEAF_PACK
        at_leaf = enter & leaf
        k_hi = jnp.max(jnp.where(at_leaf, count, 0))

        def leaf_body(k, occluded):
            in_range = at_leaf & (k < count)
            slot = jnp.clip(first + k, 0, num_slots - 1)
            trow = bvh.packed_tris[slot]
            t, _, _ = tri_intersect(
                origin, direction, trow[:, 0:3], trow[:, 3:6], trow[:, 6:9]
            )
            return occluded | (in_range & (t > t_eps) & (t < t_max))

        occluded = jax.lax.fori_loop(0, k_hi, leaf_body, occluded)
        nxt = jnp.where(enter & ~leaf, a, skip)
        # Occluded rays deactivate immediately (any-hit semantics).
        cur = jnp.where(active & ~occluded, nxt, -1)
        return step + 1, cur, occluded

    init = (
        jnp.int32(0),
        jnp.zeros((tile,), jnp.int32),
        jnp.zeros((tile,), bool),
    )
    _, _, occluded = jax.lax.while_loop(cond, body, init)
    return occluded


@partial(jax.jit, static_argnames=("cfg", "trace_cfg"))
def any_hit_bvh(
    bvh: Bvh,
    positions: jnp.ndarray,
    faces: jnp.ndarray,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    t_max: jnp.ndarray,
    cfg: BvhConfig = BvhConfig(),
    trace_cfg: TraceConfig = TraceConfig(),
) -> jnp.ndarray:
    """Occlusion (shadow-ray) query: True where anything lies in
    ``(t_eps, t_max)``."""
    del positions, faces
    if origin.ndim == 1:
        origin = jnp.broadcast_to(origin[None, :], direction.shape)
    num_rays = direction.shape[0]
    tile = min(trace_cfg.tile_rays, max(num_rays, 1))
    origin, direction, _ = _pad_tile(origin, direction, tile)
    if t_max.ndim == 0:
        t_max = jnp.full((num_rays,), t_max)
    t_max_p = jnp.concatenate(
        [t_max, jnp.zeros((direction.shape[0] - num_rays,), jnp.float32)]
    )
    num_tiles = direction.shape[0] // tile
    occ = jax.lax.map(
        lambda odt: _any_hit_tile(bvh, odt[0], odt[1], odt[2], cfg, trace_cfg),
        (
            origin.reshape(num_tiles, tile, 3),
            direction.reshape(num_tiles, tile, 3),
            t_max_p.reshape(num_tiles, tile),
        ),
    )
    return occ.reshape(-1)[:num_rays]
