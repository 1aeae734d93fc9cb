"""Dense (matrix-form) tracing for pinhole frames and directional-light
shadows.

Fills the role of the reference's march kernels (`BuildTree.cu:367-499`)
but with the opposite work shape.  Where a CUDA thread walks a pointer
tree per ray, this path does three rectangular passes:

  1. CULL   — every pixel tile's frustum against every cluster AABB, one
              dense ``[tiles, clusters]`` rectangle of plane tests whose
              dot products are one matmul (p-vertex trick split as
              ``n.(c-eye) + |n|.h``).
  2. COMPACT— per-tile survivor lists via a row sort of the cull mask
              (the ids arrive Morton-ordered, i.e. spatially coherent).
  3. SWEEP  — Möller–Trumbore of each tile's 256 rays against its
              candidate clusters as ONE ``[R,3] @ [3, 3·L·K]`` contraction
              per round (see `accel/clusters.py` for why det/u·det/v·det
              are linear in the ray), plus an elementwise compare epilogue
              and a running min-reduction.

Exactness: culling is conservative (a cluster is only skipped when its
AABB provably misses the whole tile beam), every surviving cluster is
tested (rounds advance a cursor through the FULL sorted survivor list —
nothing is dropped on overflow), and the winning triangle is re-intersected
with the oracle formula (`ops/math.tri_intersect`) so reported t/u/v are
bit-identical to the brute-force reference for the same winner.  Every f32
contraction here is pinned to ``Precision.HIGHEST``: a reduced-precision
(TF32) matmul could make the "conservative" cull drop a visible cluster or
flip the closest hit.

Frames whose height or width is not a multiple of the tile edge are
edge-padded to whole tiles and cropped back (`_pad_frame`); the replicated
edge rays are valid directions whose pixels are discarded.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.lax import Precision

from ..accel.clusters import (
    ClusterSet,
    DirectionConsts,
    OriginConsts,
    direction_consts,
    origin_consts,
)
from ..config import TraceConfig
from ..ops.math import tri_intersect
from ..types import FLT_MAX, Hit

import numpy as _np

#: Sort key for culled clusters — larger than any cluster id.
_CULLED = _np.int32(1 << 30)


# ---------------------------------------------------------------------------
# Tiling helpers (row-major pixels <-> tile-major lanes).
# ---------------------------------------------------------------------------

def tile_pixels(x: jnp.ndarray, height: int, width: int, tile_px: int):
    """[H*W, ...] row-major -> [T, R, ...] tile-major."""
    trailing = x.shape[1:]
    th, tw = height // tile_px, width // tile_px
    shp = (th, tile_px, tw, tile_px) + trailing
    perm = (0, 2, 1, 3) + tuple(range(4, 4 + len(trailing)))
    return (
        x.reshape(shp).transpose(perm)
        .reshape((th * tw, tile_px * tile_px) + trailing)
    )


def untile_pixels(x: jnp.ndarray, height: int, width: int, tile_px: int):
    """[T, R, ...] tile-major -> [H*W, ...] row-major."""
    trailing = x.shape[2:]
    th, tw = height // tile_px, width // tile_px
    shp = (th, tw, tile_px, tile_px) + trailing
    perm = (0, 2, 1, 3) + tuple(range(4, 4 + len(trailing)))
    return x.reshape(shp).transpose(perm).reshape((height * width,) + trailing)


def _pad_frame(x: jnp.ndarray, height: int, width: int, tile_px: int,
               fill=None):
    """Pad a row-major ``[H*W, ...]`` frame to whole tiles.

    Returns ``(x_padded, padded_height, padded_width)``.  New pixels
    replicate the frame's edge (``fill=None``) or take ``fill``."""
    hp = -(-height // tile_px) * tile_px
    wp = -(-width // tile_px) * tile_px
    if (hp, wp) == (height, width):
        return x, height, width
    img = x.reshape((height, width) + x.shape[1:])
    widths = [(0, hp - height), (0, wp - width)] + [(0, 0)] * (x.ndim - 1)
    if fill is None:
        img = jnp.pad(img, widths, mode="edge")
    else:
        img = jnp.pad(img, widths, constant_values=fill)
    return img.reshape((hp * wp,) + x.shape[1:]), hp, wp


def _crop_frame(x: jnp.ndarray, height: int, width: int, hp: int, wp: int):
    """Inverse of `_pad_frame`: padded ``[hp*wp, ...]`` -> ``[H*W, ...]``."""
    if (hp, wp) == (height, width):
        return x
    img = x.reshape((hp, wp) + x.shape[1:])[:height, :width]
    return img.reshape((height * width,) + x.shape[1:])


def tile_frustum_planes(d_tiles: jnp.ndarray, tile_px: int) -> jnp.ndarray:
    """Inward-oriented bounding planes of each tile's pinhole beam.

    The tile's rays share an origin, so they span a convex cone bounded by
    the 4 corner directions; the 5th plane (the mean direction) rejects
    geometry behind the eye.  Returns ``[T, 5, 3]`` normals (planes pass
    through the eye)."""
    rays_per_tile = tile_px * tile_px
    c00 = d_tiles[:, 0]
    c01 = d_tiles[:, tile_px - 1]
    c10 = d_tiles[:, (tile_px - 1) * tile_px]
    c11 = d_tiles[:, rays_per_tile - 1]
    mean_dir = d_tiles.mean(axis=1)

    def plane(a, b):
        n = jnp.cross(a, b)
        s = jnp.sign(jnp.sum(n * mean_dir, axis=-1, keepdims=True))
        return n * jnp.where(s == 0, 1.0, s)

    return jnp.stack(
        [plane(c00, c01), plane(c01, c11), plane(c11, c10), plane(c10, c00),
         mean_dir],
        axis=1,
    )


# ---------------------------------------------------------------------------
# Phase 1: dense cull.
# ---------------------------------------------------------------------------

def _cull_frustum(planes: jnp.ndarray, eye: jnp.ndarray,
                  cmin: jnp.ndarray, cmax: jnp.ndarray) -> jnp.ndarray:
    """[T,5,3] planes x [C] cluster boxes -> [T,C] survive mask.

    p-vertex trick as ONE matmul: max over box corners of ``n.(corner-eye)``
    equals ``n.(mid-eye) + |n|.half``, linear in ``[n | |n|]`` — so all
    T*5 planes test all C boxes in a single ``[T*5, 6] @ [6, C]``
    contraction (vs 10 K=3 matmuls); outside any plane => culled."""
    cmid = (cmin + cmax) * 0.5 - eye  # [C,3]
    chalf = (cmax - cmin) * 0.5
    t, p = planes.shape[0], planes.shape[1]
    n = planes.reshape(t * p, 3)
    a = jnp.concatenate([n, jnp.abs(n)], axis=1)  # [T*5, 6]
    b = jnp.concatenate([cmid, chalf], axis=1).T  # [6, C]
    d = jnp.matmul(a, b, precision=Precision.HIGHEST).reshape(t, p, -1)
    return jnp.min(d, axis=1) >= 0.0


def _compact(survive: jnp.ndarray, round_k: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """[T,C] mask -> (sorted survivor ids padded to a K multiple, counts).

    The sort runs on int16 keys when cluster ids fit (halves the sorted
    bytes; chunked callers keep local ids < 32k)."""
    c = survive.shape[1]
    if c < 32000:
        cids = jnp.arange(c, dtype=jnp.int16)
        key = jnp.where(survive, cids[None, :], jnp.int16(32000))
        lists = jnp.sort(key, axis=1).astype(jnp.int32)
        lists = jnp.where(lists >= 32000, _CULLED, lists)
    else:
        cids = jnp.arange(c, dtype=jnp.int32)
        key = jnp.where(survive, cids[None, :], _CULLED)
        lists = jnp.sort(key, axis=1)
    pad = -(-c // round_k) * round_k - c
    if pad:
        lists = jnp.pad(lists, ((0, 0), (0, pad)), constant_values=_CULLED)
    return lists, jnp.sum(survive, axis=1).astype(jnp.int32)


# ---------------------------------------------------------------------------
# Phase 3: matrix MT sweeps.
# ---------------------------------------------------------------------------

def _chunked_map(fn, args, num_items: int, chunk: int):
    """lax.map over fixed-size chunks of the leading axis (pad + unpad)."""
    n_chunks = -(-num_items // chunk)
    pad = n_chunks * chunk - num_items

    def prep(x):
        if pad:
            x = jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))
        return x.reshape((n_chunks, chunk) + x.shape[1:])

    outs = jax.lax.map(fn, tuple(prep(a) for a in args))
    return jax.tree_util.tree_map(
        lambda x: x.reshape((-1,) + x.shape[2:])[:num_items], outs
    )


def _sweep_primary(d_tiles, lists, counts, oc: OriginConsts, *,
                   cluster_size: int, round_k: int, tiles_per_chunk: int,
                   chunk_offset: int, t_eps: float, best_t, best_slot):
    """Test every listed cluster against its tile's rays; keep closest.

    ``lists``/``counts`` index clusters LOCAL to the current column chunk;
    ``chunk_offset`` rebases winning slots into global sorted-face ids.
    Work is chunked over tiles; each chunk runs only the rounds its own
    deepest tile needs (empty chunks cost one bound check)."""
    L = cluster_size
    K = round_k
    num_tiles = d_tiles.shape[0]
    c_local = oc.st.shape[0]

    def tile_chunk(args):
        d_c, lists_c, counts_c, bt_c, bs_c = args
        tc = d_c.shape[0]
        rounds = (jnp.max(counts_c) + K - 1) // K

        def round_body(r, carry):
            bt, bs = carry
            window = jax.lax.dynamic_slice(lists_c, (0, r * K), (tc, K))
            valid = window < _CULLED  # [tc,K]
            safe = jnp.minimum(window, c_local - 1)
            # Per-quantity [tc,K*L,3] gathers in natural layout; each
            # einsum contracts the trailing xyz axis — no transposes.
            def quant(m):
                m = m[safe].reshape(tc, K * L, 3)
                return jnp.einsum("trx,tnx->trn", d_c, m,
                                  precision=Precision.HIGHEST,
                                  preferred_element_type=jnp.float32)

            st = oc.st[safe].reshape(tc, K * L)  # [tc,K*L]
            det = quant(oc.mp)
            ud = quant(oc.qu)
            vd = quant(oc.qv)
            s = jnp.sign(det)
            t = st[:, None, :] / det
            ok = (
                (ud * s >= 0.0)
                & (vd * s >= 0.0)
                & ((ud + vd) * s <= det * s)
                & (t > t_eps)
                & (t < FLT_MAX)
                & jnp.repeat(valid, L, axis=1)[:, None, :]
            )
            t = jnp.where(ok, t, FLT_MAX)
            j = jnp.argmin(t, axis=-1)  # [tc,R]
            ct = jnp.take_along_axis(t, j[..., None], axis=-1)[..., 0]
            win_cluster = jnp.take_along_axis(window, j // L, axis=-1)
            cslot = (win_cluster + chunk_offset) * L + (j % L)
            closer = ct < bt
            return (jnp.where(closer, ct, bt),
                    jnp.where(closer, cslot, bs))

        return jax.lax.fori_loop(0, rounds, round_body, (bt_c, bs_c))

    return _chunked_map(
        tile_chunk, (d_tiles, lists, counts, best_t, best_slot),
        num_tiles, tiles_per_chunk,
    )


def _sweep_occlusion(o_tiles, a_tiles, lists, counts, dc: DirectionConsts, *,
                     cluster_size: int, round_k: int, tiles_per_chunk: int,
                     t_eps: float, occluded):
    """Any-hit sweep for a common-direction bundle (directional shadows)."""
    L = cluster_size
    K = round_k
    num_tiles = o_tiles.shape[0]
    c_local = dc.det.shape[0]

    def tile_chunk(args):
        o_c, a_c, lists_c, counts_c, occ_c = args
        tc = o_c.shape[0]
        rounds = (jnp.max(counts_c) + K - 1) // K

        def round_body(r, occ):
            window = jax.lax.dynamic_slice(lists_c, (0, r * K), (tc, K))
            valid = window < _CULLED
            safe = jnp.minimum(window, c_local - 1)

            def quant(m):
                m = m[safe].reshape(tc, K * L, 3)
                return jnp.einsum("trx,tnx->trn", o_c, m,
                                  precision=Precision.HIGHEST,
                                  preferred_element_type=jnp.float32)

            off = dc.off[safe].reshape(tc, K * L, 3)
            det = dc.det[safe].reshape(tc, 1, K * L)
            ud = quant(dc.pvec) - off[:, None, :, 0]
            vd = quant(dc.mvec) - off[:, None, :, 1]
            td = quant(dc.pp) - off[:, None, :, 2]
            s = jnp.sign(det)
            t = td / det
            ok = (
                (ud * s >= 0.0)
                & (vd * s >= 0.0)
                & ((ud + vd) * s <= det * s)
                & (t > t_eps)
                & (t < FLT_MAX)
                & jnp.repeat(valid, L, axis=1)[:, None, :]
            )
            return occ | (a_c & jnp.any(ok, axis=-1))

        return jax.lax.fori_loop(0, rounds, round_body, occ_c)

    return _chunked_map(
        tile_chunk, (o_tiles, a_tiles, lists, counts, occluded),
        num_tiles, tiles_per_chunk,
    )


# ---------------------------------------------------------------------------
# Public entry points.
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("height", "width", "tile_px", "round_k",
                                   "tiles_per_chunk", "cluster_chunk",
                                   "trace_cfg"))
def trace_dense(
    cs: ClusterSet,
    eye: jnp.ndarray,
    dirs: jnp.ndarray,
    height: int,
    width: int,
    tile_px: int = 16,
    round_k: int = 32,
    tiles_per_chunk: int = 32,
    cluster_chunk: int = 8192,
    trace_cfg: TraceConfig = TraceConfig(),
) -> Hit:
    """Closest hit for a pinhole frame (common origin ``eye``).

    Args:
      dirs: ``[H*W, 3]`` row-major oriented pixel directions.
    """
    padded, hp, wp = _pad_frame(dirs, height, width, tile_px)
    L = cs.cluster_size
    C = cs.num_clusters
    d_tiles = tile_pixels(padded, hp, wp, tile_px)
    planes = tile_frustum_planes(d_tiles, tile_px)
    num_tiles = d_tiles.shape[0]
    t_eps = float(trace_cfg.t_epsilon) if trace_cfg.clip_backward_hits else -FLT_MAX

    oc = origin_consts(cs, eye)
    best_t = jnp.full((num_tiles, tile_px * tile_px), FLT_MAX, jnp.float32)
    best_slot = jnp.zeros((num_tiles, tile_px * tile_px), jnp.int32)

    for c0 in range(0, C, cluster_chunk):
        c1 = min(C, c0 + cluster_chunk)
        with jax.named_scope("cull"):
            survive = _cull_frustum(planes, eye, cs.cmin[c0:c1],
                                    cs.cmax[c0:c1])
        with jax.named_scope("compact"):
            lists, counts = _compact(survive, round_k)
            # Chunks pay their DEEPEST tile's round count, so group tiles
            # of similar depth together: permute tiles by survivor count
            # for the sweep, un-permute its results.
            perm = jnp.argsort(counts)
            unperm = jnp.argsort(perm)
        oc_chunk = jax.tree_util.tree_map(lambda x: x[c0:c1], oc)
        with jax.named_scope("sweep"):
            bt_p, bs_p = _sweep_primary(
                d_tiles[perm], lists[perm], counts[perm], oc_chunk,
                cluster_size=L, round_k=round_k,
                tiles_per_chunk=tiles_per_chunk, chunk_offset=c0,
                t_eps=t_eps, best_t=best_t[perm], best_slot=best_slot[perm],
            )
            best_t, best_slot = bt_p[unperm], bs_p[unperm]

    bt = _crop_frame(untile_pixels(best_t, hp, wp, tile_px),
                     height, width, hp, wp)
    bslot = _crop_frame(untile_pixels(best_slot, hp, wp, tile_px),
                        height, width, hp, wp)

    # Re-intersect each winner with the oracle formula so t/u/v match the
    # brute-force reference bit-for-bit (the sweep's algebraic rearrangement
    # only *selects* the winner).
    tri = cs.tris.reshape(-1, 9)[bslot]
    t, u, v = tri_intersect(eye[None, :], dirs, tri[:, 0:3], tri[:, 3:6],
                            tri[:, 6:9])
    hit = bt < FLT_MAX
    # Guard the fp edge where the rearranged sweep accepts a hit the oracle
    # formula rounds out of: keep the sweep's t rather than reporting miss.
    t = jnp.where(t < FLT_MAX, t, bt)
    face = jnp.where(hit, cs.face_order[bslot], -1)
    return Hit(
        t=jnp.where(hit, t, FLT_MAX),
        u=jnp.where(hit, u, 0.0),
        v=jnp.where(hit, v, 0.0),
        face=face,
    )


@partial(jax.jit, static_argnames=("trace_cfg", "round_k", "ray_chunk",
                                   "cluster_chunk"))
def trace_clusters_rays(
    cs: ClusterSet,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    trace_cfg: TraceConfig = TraceConfig(),
    round_k: int = 32,
    ray_chunk: int = 2048,
    cluster_chunk: int = 2048,
    active: jnp.ndarray | None = None,
) -> Hit:
    """Closest hit for an ARBITRARY ray bundle over the cluster structure.

    No shared origin/direction means no matrix trick and no tile frustum;
    instead each ray chunk culls clusters collectively (a cluster survives
    when ANY ray's slab test enters its AABB) and sweeps survivors with the
    full Möller–Trumbore.  Exact for any bundle; fast when the bundle is
    coherent (e.g. one bounce off a pixel tile).  This is the bundle-shape
    analog of the reference's generic march (`BuildTree.cu:367-499`), used
    by secondary bounces.
    """
    L = cs.cluster_size
    C = cs.num_clusters
    num_rays = origin.shape[0]
    t_eps = float(trace_cfg.t_epsilon) if trace_cfg.clip_backward_hits else -FLT_MAX
    tris_flat = cs.tris.reshape(-1, 9)

    if active is None:
        active_all = jnp.ones((num_rays,), bool)
    else:
        active_all = active

    def ray_chunk_fn(args):
        o_c, d_c, act_c = args
        rc = o_c.shape[0]
        # NaN-robust slab form: a zero direction component with the origin
        # exactly on a box plane gives 0*inf = NaN, which would make
        # `enters` False and break the conservative-cull contract; a huge
        # finite inverse keeps the parallel-ray semantics instead (same
        # guard as `ops/math.box_ray_intersect`).
        inv = jnp.where(d_c == 0.0, 3.0e37, 1.0 / d_c)
        bt = jnp.full((rc,), FLT_MAX, jnp.float32)
        bslot = jnp.zeros((rc,), jnp.int32)

        for c0 in range(0, C, cluster_chunk):
            c1 = min(C, c0 + cluster_chunk)
            cmin, cmax = cs.cmin[c0:c1], cs.cmax[c0:c1]
            # Slab entry test, [rc, Cc]: does any ACTIVE ray enter the box
            # before its current best t?
            t0 = (cmin[None] - o_c[:, None]) * inv[:, None]
            t1 = (cmax[None] - o_c[:, None]) * inv[:, None]
            tnear = jnp.max(jnp.minimum(t0, t1), axis=-1)
            tfar = jnp.min(jnp.maximum(t0, t1), axis=-1)
            enters = (
                (tfar >= jnp.maximum(tnear, 0.0))
                & (tnear < bt[:, None])
                & act_c[:, None]
            )
            survive = jnp.any(enters, axis=0)  # [Cc]
            cids = jnp.arange(c1 - c0, dtype=jnp.int32)
            lists = jnp.sort(jnp.where(survive, cids, _CULLED))
            pad = -(-(c1 - c0) // round_k) * round_k - (c1 - c0)
            if pad:
                lists = jnp.pad(lists, (0, pad), constant_values=_CULLED)
            count = jnp.sum(survive).astype(jnp.int32)
            rounds = (count + round_k - 1) // round_k

            def round_body(r, carry):
                bt, bslot = carry
                window = jax.lax.dynamic_slice(lists, (r * round_k,), (round_k,))
                valid = window < _CULLED
                safe = jnp.minimum(window, c1 - c0 - 1) + c0
                slots = safe[:, None] * L + jnp.arange(L, dtype=jnp.int32)[None]
                tri = tris_flat[slots.reshape(-1)]  # [K*L, 9]
                t, _, _ = tri_intersect(
                    o_c[:, None, :], d_c[:, None, :],
                    tri[None, :, 0:3], tri[None, :, 3:6], tri[None, :, 6:9],
                )  # [rc, K*L]
                ok = (t > t_eps) & (t < FLT_MAX) & jnp.repeat(valid, L)[None, :]
                t = jnp.where(ok, t, FLT_MAX)
                j = jnp.argmin(t, axis=-1)
                ct = jnp.take_along_axis(t, j[:, None], axis=-1)[..., 0]
                cslot = slots.reshape(-1)[j]
                closer = ct < bt
                return (jnp.where(closer, ct, bt), jnp.where(closer, cslot, bslot))

            bt, bslot = jax.lax.fori_loop(0, rounds, round_body, (bt, bslot))
        return bt, bslot

    bt, bslot = _chunked_map(ray_chunk_fn, (origin, direction, active_all),
                             num_rays, ray_chunk)
    hit = (bt < FLT_MAX) & active_all
    tri = tris_flat[bslot]
    t, u, v = tri_intersect(origin, direction, tri[:, 0:3], tri[:, 3:6],
                            tri[:, 6:9])
    t = jnp.where(t < FLT_MAX, t, bt)
    return Hit(
        t=jnp.where(hit, t, FLT_MAX),
        u=jnp.where(hit, u, 0.0),
        v=jnp.where(hit, v, 0.0),
        face=jnp.where(hit, cs.face_order[bslot], -1),
    )


@partial(jax.jit, static_argnames=("trace_cfg", "round_k", "ray_chunk",
                                   "cluster_chunk"))
def any_hit_clusters_rays(
    cs: ClusterSet,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    max_t: jnp.ndarray,
    trace_cfg: TraceConfig = TraceConfig(),
    round_k: int = 32,
    ray_chunk: int = 2048,
    cluster_chunk: int = 2048,
) -> jnp.ndarray:
    """Any-hit (occlusion) for an arbitrary bundle over the clusters.

    Returns ``[R]`` bool: some triangle lies at ``t in (eps, max_t)``."""
    hit = trace_clusters_rays(cs, origin, direction, trace_cfg,
                              round_k=round_k, ray_chunk=ray_chunk,
                              cluster_chunk=cluster_chunk)
    return hit.hit_mask & (hit.t < max_t)


@partial(jax.jit, static_argnames=("height", "width", "tile_px", "round_k",
                                   "tiles_per_chunk", "cluster_chunk",
                                   "trace_cfg"))
def occlusion_dense(
    cs: ClusterSet,
    origins: jnp.ndarray,
    light_dir: jnp.ndarray,
    active: jnp.ndarray,
    height: int,
    width: int,
    tile_px: int = 16,
    round_k: int = 32,
    tiles_per_chunk: int = 32,
    cluster_chunk: int = 8192,
    trace_cfg: TraceConfig = TraceConfig(),
) -> jnp.ndarray:
    """Any-hit occlusion for a DIRECTIONAL light (common direction).

    The tile beam is its origins' AABB swept along ``light_dir``: a cluster
    survives when its projection overlaps the origin box's on both axes
    perpendicular to the light and it is not entirely behind every origin.

    Args:
      origins: ``[H*W, 3]`` shadow-ray origins (row-major pixels).
      active: ``[H*W]`` bool — rays needing occlusion.
    Returns: ``[H*W]`` bool occlusion mask (False where not active).
    """
    L = cs.cluster_size
    C = cs.num_clusters
    o_pad, hp, wp = _pad_frame(origins, height, width, tile_px)
    a_pad, _, _ = _pad_frame(active, height, width, tile_px, fill=False)
    o_tiles = tile_pixels(o_pad, hp, wp, tile_px)
    a_tiles = tile_pixels(a_pad, hp, wp, tile_px)
    num_tiles = o_tiles.shape[0]
    t_eps = float(trace_cfg.t_epsilon)

    from .occlusion_cull import beam_survive_matrix, swept_tile_beams

    beam = swept_tile_beams(o_tiles, a_tiles, light_dir)
    l = beam.l

    dc = direction_consts(cs, l)
    occluded = jnp.zeros_like(a_tiles)

    for c0 in range(0, C, cluster_chunk):
        c1 = min(C, c0 + cluster_chunk)
        with jax.named_scope("shadow_cull"):
            survive = beam_survive_matrix(beam, cs.cmin[c0:c1],
                                          cs.cmax[c0:c1])
        with jax.named_scope("shadow_compact"):
            lists, counts = _compact(survive, round_k)
            perm = jnp.argsort(counts)
            unperm = jnp.argsort(perm)
        dc_chunk = jax.tree_util.tree_map(lambda x: x[c0:c1], dc)
        with jax.named_scope("shadow_sweep"):
            occ_p = _sweep_occlusion(
                o_tiles[perm], a_tiles[perm], lists[perm], counts[perm],
                dc_chunk, cluster_size=L, round_k=round_k,
                tiles_per_chunk=tiles_per_chunk, t_eps=t_eps,
                occluded=occluded[perm],
            )
            occluded = occ_p[unperm]

    occluded = untile_pixels(occluded, hp, wp, tile_px)
    return _crop_frame(occluded, height, width, hp, wp) & active
