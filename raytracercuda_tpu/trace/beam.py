"""Beam (tile-frustum) tracing: the BVH primary-ray fast path.

The reference traces one CUDA thread per ray, each walking the tree
independently (`BuildTree.cu:367-499`).  Vectorized, per-ray traversal is
gather-bound and pays the slowest ray's path length in every lockstep
tile.  Beam tracing restructures the work the way the hardware wants it
(and completes the arc the reference began by naming its library "Beam"):

  Phase B (walk)  — ONE skip-link walk per 16x16 pixel tile, vectorized
    over all tiles.  The tile's 256 rays share an origin, so they span a
    convex cone bounded by the 4 corner directions; a node is culled when
    its AABB lies fully outside any of the cone's 4 side planes (or
    behind the eye).  Surviving leaves append their (first, count) face
    ranges to the tile's bounded candidate queue.

  Phase C (test)  — dense Möller-Trumbore of every tile's 256 rays
    against its candidate faces, an elementwise sweep over Morton-contiguous
    triangle rows with per-ray min-reduction.

  Rounds — a tile whose queue fills simply pauses its walk cursor and
    resumes after testing, so results remain EXACT closest-hit (validated
    against the brute-force oracle), unlike bounded-queue schemes that
    drop overflow.

Per-ray cost collapses from (path length x gathers) to (candidates x
~50 flops): the 256 rays of a tile amortize one traversal.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..accel.bvh import Bvh, LEAF_PACK
from ..config import BvhConfig, TraceConfig
from ..ops.math import tri_intersect
from ..types import FLT_MAX, Hit


def _corner_planes(c00, c01, c11, c10, mean_dir):
    """Planes from 4 corner dirs (tl,tr,br,bl loop) — [T,5,3] normals."""
    def plane(a, b):
        n = jnp.cross(a, b)
        # Orient inward: the mean direction must be on the positive side.
        s = jnp.sign(jnp.sum(n * mean_dir, axis=-1, keepdims=True))
        return n * jnp.where(s == 0, 1.0, s)

    return jnp.stack(
        [plane(c00, c01), plane(c01, c11), plane(c11, c10), plane(c10, c00),
         mean_dir],
        axis=1,
    )


def _box_outside_planes(planes, eye, bmin, bmax):
    """True where the AABB is fully outside ANY plane (conservative cull).

    planes: [T,5,3]; bmin/bmax: [T,3] (per-tile current node box).
    Outside plane i  <=>  max over box corners of dot(n_i, c - eye) < 0,
    computed with the p-vertex trick."""
    n = planes  # [T,5,3]
    pv = jnp.where(n > 0, bmax[:, None, :], bmin[:, None, :])  # [T,5,3]
    d = jnp.sum(n * (pv - eye[None, None, :]), axis=-1)  # [T,5]
    return jnp.any(d < 0.0, axis=-1)


@partial(jax.jit, static_argnames=("height", "width", "tile_px", "queue",
                                   "cfg", "trace_cfg", "tiles_per_chunk"))
def trace_beam(
    bvh: Bvh,
    eye: jnp.ndarray,
    dirs: jnp.ndarray,
    height: int | None = None,
    width: int | None = None,
    tile_px: int = 16,
    queue: int = 256,
    cfg: BvhConfig = BvhConfig(),
    trace_cfg: TraceConfig = TraceConfig(),
    tiles_per_chunk: int = 16,
) -> Hit:
    """Closest hit for a pinhole frame via tile-beam traversal.

    Args:
      eye: [3] common ray origin.
      dirs: [H*W, 3] row-major pixel directions (already oriented).
      height/width: frame dims; inferred square if omitted.
    """
    num_rays = dirs.shape[0]
    if height is None or width is None:
        side = int(round(num_rays ** 0.5))
        assert side * side == num_rays, "non-square frame needs height/width"
        height = width = side
    assert height % tile_px == 0 and width % tile_px == 0, (
        f"{height}x{width} not divisible by tile {tile_px}")
    th, tw = height // tile_px, width // tile_px
    num_tiles = th * tw
    rays_per_tile = tile_px * tile_px

    # [H,W,3] -> [T, R, 3] tile-major.
    d_img = dirs.reshape(height, width, 3)
    d_tiles = (
        d_img.reshape(th, tile_px, tw, tile_px, 3)
        .transpose(0, 2, 1, 3, 4)
        .reshape(num_tiles, rays_per_tile, 3)
    )
    # Corner rays of each tile (the extreme rays of its pinhole sub-grid).
    c00 = d_tiles[:, 0]
    c01 = d_tiles[:, tile_px - 1]
    c10 = d_tiles[:, (tile_px - 1) * tile_px]
    c11 = d_tiles[:, rays_per_tile - 1]
    mean_dir = d_tiles.mean(axis=1)
    planes = _corner_planes(c00, c01, c11, c10, mean_dir)  # [T,5,3]

    num_slots = bvh.packed_tris.shape[0]
    t_eps = jnp.float32(trace_cfg.t_epsilon)
    k_leaf = cfg.max_leaf_faces

    # ---------------- Phase B walk (vectorized over tiles) ---------------
    def walk_round(cur, tile_tmax):
        """Walk until every tile's queue is full or its walk ended.

        ``tile_tmax``: per-tile upper bound on the farthest unresolved ray
        (max over the tile's current best t).  The Euclidean eye-to-box
        distance lower-bounds every (unit-direction) ray's hit t inside
        the box, so boxes farther than tile_tmax are pruned — the beam
        analog of the per-ray box_d < best_t prune.
        Returns (new_cur, q_first [T,queue], q_count [T,queue], q_n [T])."""
        q_first = jnp.zeros((num_tiles, queue), jnp.int32)
        q_count = jnp.zeros((num_tiles, queue), jnp.int32)
        q_n = jnp.zeros((num_tiles,), jnp.int32)
        rows = jnp.arange(num_tiles)

        def step_once(cur, q_first, q_count, q_n):
            walking = (cur >= 0) & (q_n < queue)
            nid = jnp.maximum(cur, 0)
            row = bvh.packed_nodes[nid]
            links = bvh.packed_links[nid]
            a, skip = links[:, 0], links[:, 1]
            bmin, bmax = row[:, 0:3], row[:, 3:6]
            outside = _box_outside_planes(planes, eye, bmin, bmax)
            # Distance prune: closest point of box to eye vs tile_tmax.
            gap = jnp.maximum(bmin - eye, 0.0) + jnp.maximum(eye - bmax, 0.0)
            too_far = jnp.sum(gap * gap, axis=-1) > tile_tmax * tile_tmax
            enter = walking & ~outside & ~too_far
            leaf = a < 0
            enc = -a - 2
            append = enter & leaf
            slot_idx = jnp.minimum(q_n, queue - 1)
            q_first = q_first.at[rows, slot_idx].set(
                jnp.where(append, enc // LEAF_PACK, q_first[rows, slot_idx])
            )
            q_count = q_count.at[rows, slot_idx].set(
                jnp.where(append, enc % LEAF_PACK, q_count[rows, slot_idx])
            )
            q_n = q_n + append.astype(jnp.int32)
            nxt = jnp.where(enter & ~leaf, a, skip)
            cur = jnp.where(walking, nxt, cur)
            return cur, q_first, q_count, q_n

        def cond(state):
            step, cur, _, _, q_n = state
            walking = (cur >= 0) & (q_n < queue)
            return (step < cfg.max_iters) & jnp.any(walking)

        def body(state):
            step, cur, q_first, q_count, q_n = state
            # Unroll a few steps per loop iteration to amortize loop
            # overhead (each step is tiny [T]-lane work).
            for _ in range(4):
                cur, q_first, q_count, q_n = step_once(cur, q_first, q_count, q_n)
            return step + 4, cur, q_first, q_count, q_n

        _, cur, q_first, q_count, q_n = jax.lax.while_loop(
            cond, body, (jnp.int32(0), cur, q_first, q_count, q_n)
        )
        return cur, q_first, q_count, q_n

    # ---------------- Phase C dense test (chunked over tiles) ------------
    def test_round(q_first, q_count, q_n, bt, bu, bv, bslot):
        """MT-test each tile's candidates against its rays.

        The candidate sweep iterates leaf-blocks only up to the CHUNK's
        max queue length (a traced fori bound): chunks of finished/empty
        tiles cost almost nothing, so extra rounds are cheap for everyone
        except the tiles that actually need them."""
        leaf_block = 64  # leaves per inner block (leaf_block*k_leaf faces)
        k_off = jnp.arange(k_leaf, dtype=jnp.int32)
        b_ids = jnp.arange(leaf_block, dtype=jnp.int32)

        def tile_chunk(args):
            d_c, qf_c, qc_c, qn_c, bt_c, bu_c, bv_c, bs_c = args
            n_tiles_c = d_c.shape[0]
            qn_max = jnp.max(qn_c)

            def block_body(b, carry):
                bt_c, bu_c, bv_c, bs_c = carry
                q_lo = b * leaf_block
                q_idx = jnp.clip(q_lo + b_ids, 0, queue - 1)  # [B]
                qf_b = qf_c[:, q_idx]  # [C, B] wait: gather cols
                qc_b = qc_c[:, q_idx]
                # Candidate slots [C, B, K] -> [C, B*K].
                slots = qf_b[:, :, None] + k_off[None, None, :]
                valid = (
                    ((q_lo + b_ids)[None, :, None] < qn_c[:, None, None])
                    & (k_off[None, None, :] < qc_b[:, :, None])
                )
                cand = leaf_block * k_leaf
                slots = jnp.clip(slots, 0, num_slots - 1).reshape(n_tiles_c, cand)
                valid = valid.reshape(n_tiles_c, cand)
                # Whole-leaf contiguous reads (one [K,9] slice per queue
                # entry) instead of per-slot row gathers — packed_tris has
                # a LEAF_PACK zero-row tail so no clipping is needed.
                tri = jax.vmap(
                    lambda s: jax.lax.dynamic_slice(
                        bvh.packed_tris, (s, jnp.int32(0)), (k_leaf, 9))
                )(jnp.maximum(qf_b, 0).reshape(-1))
                tri = tri.reshape(n_tiles_c, cand, 9)
                t, u, v = tri_intersect(
                    eye[None, None, :],
                    d_c[:, :, None, :],  # [C, R, 1, 3]
                    tri[:, None, :, 0:3],
                    tri[:, None, :, 3:6],
                    tri[:, None, :, 6:9],
                )  # [C, R, cand]
                if trace_cfg.clip_backward_hits:
                    t = jnp.where(t < t_eps, FLT_MAX, t)
                t = jnp.where(valid[:, None, :], t, FLT_MAX)
                j = jnp.argmin(t, axis=-1)  # [C, R]
                ii = jnp.arange(t.shape[0])[:, None]
                rr = jnp.arange(t.shape[1])[None, :]
                ct, cu, cv = t[ii, rr, j], u[ii, rr, j], v[ii, rr, j]
                cs = jnp.take_along_axis(slots, j, axis=1)  # [C, R]
                closer = ct < bt_c
                return (
                    jnp.where(closer, ct, bt_c),
                    jnp.where(closer, cu, bu_c),
                    jnp.where(closer, cv, bv_c),
                    jnp.where(closer, cs, bs_c),
                )

            n_blocks = (qn_max + leaf_block - 1) // leaf_block
            return jax.lax.fori_loop(
                0, n_blocks, block_body, (bt_c, bu_c, bv_c, bs_c)
            )

        n_chunks = -(-num_tiles // tiles_per_chunk)
        pad_t = n_chunks * tiles_per_chunk - num_tiles

        def padt(x, fill=0):
            if pad_t == 0:
                return x
            pw = [(0, pad_t)] + [(0, 0)] * (x.ndim - 1)
            return jnp.pad(x, pw, constant_values=fill)

        chunked = lambda x: padt(x).reshape(
            (n_chunks, tiles_per_chunk) + x.shape[1:]
        )
        outs = jax.lax.map(
            tile_chunk,
            (
                chunked(d_tiles), chunked(q_first), chunked(q_count),
                chunked(q_n), chunked(bt), chunked(bu), chunked(bv),
                chunked(bslot),
            ),
        )
        unchunk = lambda x: x.reshape((-1,) + x.shape[2:])[:num_tiles]
        return tuple(unchunk(o) for o in outs)

    # ---------------- Rounds ---------------------------------------------
    bt = jnp.full((num_tiles, rays_per_tile), FLT_MAX, jnp.float32)
    bu = jnp.zeros((num_tiles, rays_per_tile), jnp.float32)
    bv = jnp.zeros((num_tiles, rays_per_tile), jnp.float32)
    bslot = jnp.zeros((num_tiles, rays_per_tile), jnp.int32)

    cur = jnp.zeros((num_tiles,), jnp.int32)

    def round_cond(state):
        cur, *_ = state
        return jnp.any(cur >= 0)

    def round_body(state):
        cur, bt, bu, bv, bslot = state
        # Farthest unresolved ray per tile bounds what the walk must visit.
        tile_tmax = jnp.max(bt, axis=1)
        cur, q_first, q_count, q_n = walk_round(cur, tile_tmax)
        bt, bu, bv, bslot = test_round(q_first, q_count, q_n, bt, bu, bv, bslot)
        return cur, bt, bu, bv, bslot

    cur, bt, bu, bv, bslot = jax.lax.while_loop(
        round_cond, round_body, (cur, bt, bu, bv, bslot)
    )

    # Tile-major -> row-major pixels.
    def untile(x):
        return (
            x.reshape(th, tw, tile_px, tile_px)
            .transpose(0, 2, 1, 3)
            .reshape(num_rays)
        )

    bt, bu, bv, bslot = untile(bt), untile(bu), untile(bv), untile(bslot)
    bf = jnp.where(bt == FLT_MAX, -1, bvh.face_order[bslot])
    return Hit(t=bt, u=bu, v=bv, face=bf)


@partial(jax.jit, static_argnames=("height", "width", "tile_px", "queue",
                                   "cfg", "trace_cfg", "tiles_per_chunk"))
def occlusion_beam(
    bvh: Bvh,
    origins: jnp.ndarray,
    light_dir: jnp.ndarray,
    active: jnp.ndarray,
    height: int,
    width: int,
    tile_px: int = 16,
    queue: int = 128,
    cfg: BvhConfig = BvhConfig(),
    trace_cfg: TraceConfig = TraceConfig(),
    tiles_per_chunk: int = 32,
) -> jnp.ndarray:
    """Beam-accelerated shadow (any-hit) query for a DIRECTIONAL light.

    Every shadow ray shares one direction, and the origins of a pixel
    tile are spatially coherent (they lie on the surfaces the tile's
    primary rays hit).  The tile's shadow beam is therefore an axis-
    aligned origin box swept along ``light_dir``: a BVH node can be
    culled when its AABB's projection onto either axis perpendicular to
    the light misses the origin box's projection, or when the node lies
    entirely behind every origin along the light.  Candidates are then
    any-hit tested densely per tile.

    Args:
      origins: [H*W, 3] shadow-ray origins (row-major pixels).
      light_dir: [3] normalized direction toward the light.
      active: [H*W] bool — rays that need occlusion (primary hits).
    Returns:
      [H*W] bool occlusion mask (False wherever ``active`` is False).
    """
    num_rays = origins.shape[0]
    assert height % tile_px == 0 and width % tile_px == 0
    th, tw = height // tile_px, width // tile_px
    num_tiles = th * tw
    rays_per_tile = tile_px * tile_px

    def tile_major(x):
        trailing = x.shape[2:]  # x is [H, W, ...]
        shp = (th, tile_px, tw, tile_px) + trailing
        perm = (0, 2, 1, 3) + tuple(range(4, 4 + len(trailing)))
        return (
            x.reshape(shp).transpose(perm).reshape(
                (num_tiles, rays_per_tile) + trailing
            )
        )

    o_tiles = tile_major(origins.reshape(height, width, 3))
    a_tiles = tile_major(active.reshape(height, width))

    from .occlusion_cull import beam_cannot_occlude, swept_tile_beams

    beam = swept_tile_beams(o_tiles, a_tiles, light_dir)
    l = beam.l

    t_eps = jnp.float32(trace_cfg.t_epsilon)
    k_leaf = cfg.max_leaf_faces
    rows = jnp.arange(num_tiles)

    def cull(bmin, bmax):
        """True where the node CANNOT occlude any ray of the tile."""
        return beam_cannot_occlude(beam, bmin, bmax)

    def walk_round(cur):
        q_first = jnp.zeros((num_tiles, queue), jnp.int32)
        q_count = jnp.zeros((num_tiles, queue), jnp.int32)
        q_n = jnp.zeros((num_tiles,), jnp.int32)

        def step_once(cur, q_first, q_count, q_n):
            walking = (cur >= 0) & (q_n < queue)
            nid = jnp.maximum(cur, 0)
            row = bvh.packed_nodes[nid]
            links = bvh.packed_links[nid]
            a, skip = links[:, 0], links[:, 1]
            enter = walking & ~cull(row[:, 0:3], row[:, 3:6])
            leaf = a < 0
            enc = -a - 2
            append = enter & leaf
            slot_idx = jnp.minimum(q_n, queue - 1)
            q_first = q_first.at[rows, slot_idx].set(
                jnp.where(append, enc // LEAF_PACK, q_first[rows, slot_idx]))
            q_count = q_count.at[rows, slot_idx].set(
                jnp.where(append, enc % LEAF_PACK, q_count[rows, slot_idx]))
            q_n = q_n + append.astype(jnp.int32)
            nxt = jnp.where(enter & ~leaf, a, skip)
            cur = jnp.where(walking, nxt, cur)
            return cur, q_first, q_count, q_n

        def cond(state):
            step, cur, _, _, q_n = state
            return (step < cfg.max_iters) & jnp.any((cur >= 0) & (q_n < queue))

        def body(state):
            step, cur, q_first, q_count, q_n = state
            for _ in range(4):
                cur, q_first, q_count, q_n = step_once(cur, q_first, q_count, q_n)
            return step + 4, cur, q_first, q_count, q_n

        _, cur, q_first, q_count, q_n = jax.lax.while_loop(
            cond, body, (jnp.int32(0), cur, q_first, q_count, q_n))
        return cur, q_first, q_count, q_n

    leaf_block = 64
    k_off = jnp.arange(k_leaf, dtype=jnp.int32)
    b_ids = jnp.arange(leaf_block, dtype=jnp.int32)

    def test_round(q_first, q_count, q_n, occ):
        def tile_chunk(args):
            o_c, a_c, qf_c, qc_c, qn_c, occ_c = args
            n_tiles_c = o_c.shape[0]
            qn_max = jnp.max(qn_c)

            def block_body(b, occ_c):
                q_lo = b * leaf_block
                q_idx = jnp.clip(q_lo + b_ids, 0, queue - 1)
                qf_b = qf_c[:, q_idx]
                qc_b = qc_c[:, q_idx]
                valid = (
                    ((q_lo + b_ids)[None, :, None] < qn_c[:, None, None])
                    & (k_off[None, None, :] < qc_b[:, :, None])
                )
                cand = leaf_block * k_leaf
                valid = valid.reshape(n_tiles_c, cand)
                tri = jax.vmap(
                    lambda s: jax.lax.dynamic_slice(
                        bvh.packed_tris, (s, jnp.int32(0)), (k_leaf, 9))
                )(jnp.maximum(qf_b, 0).reshape(-1))
                tri = tri.reshape(n_tiles_c, cand, 9)
                t, _, _ = tri_intersect(
                    o_c[:, :, None, :],
                    l[None, None, None, :],
                    tri[:, None, :, 0:3],
                    tri[:, None, :, 3:6],
                    tri[:, None, :, 6:9],
                )  # [C, R, cand]
                hit = valid[:, None, :] & (t > t_eps) & (t < FLT_MAX)
                return occ_c | (a_c & jnp.any(hit, axis=-1))

            n_blocks = (qn_max + leaf_block - 1) // leaf_block
            return jax.lax.fori_loop(0, n_blocks, block_body, occ_c)

        n_chunks = -(-num_tiles // tiles_per_chunk)
        pad_t = n_chunks * tiles_per_chunk - num_tiles

        def padt(x):
            if pad_t == 0:
                return x
            pw = [(0, pad_t)] + [(0, 0)] * (x.ndim - 1)
            return jnp.pad(x, pw)

        chunked = lambda x: padt(x).reshape(
            (n_chunks, tiles_per_chunk) + x.shape[1:])
        occ_out = jax.lax.map(
            tile_chunk,
            (chunked(o_tiles), chunked(a_tiles), chunked(q_first),
             chunked(q_count), chunked(q_n), chunked(occ)),
        )
        return occ_out.reshape((-1, rays_per_tile))[:num_tiles]

    occ = jnp.zeros((num_tiles, rays_per_tile), bool)
    cur = jnp.where(beam.tile_any, 0, -1).astype(jnp.int32)

    def round_cond(state):
        cur, _ = state
        return jnp.any(cur >= 0)

    def round_body(state):
        cur, occ = state
        cur, q_first, q_count, q_n = walk_round(cur)
        occ = test_round(q_first, q_count, q_n, occ)
        return cur, occ

    _, occ = jax.lax.while_loop(round_cond, round_body, (cur, occ))

    # Tile-major -> row-major pixels.
    out = (
        occ.reshape(th, tw, tile_px, tile_px)
        .transpose(0, 2, 1, 3)
        .reshape(num_rays)
    )
    return out & active
