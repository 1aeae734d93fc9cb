"""LBVH construction: Morton codes -> sort -> Karras linking -> refit ->
stackless skip-link threading.

This is the deterministic replacement for BOTH of the reference's acceleration
builders: the atomicCAS kd-tree (`Raytracer/BuildTree.cu:7-61,154-256`) and
the Fletcher16 hash grid (`Raytracer/Hash.cu:132-178`).  Their lock-free
concurrent insertion (bmStore bump allocators with accepted memory leaks,
`CudaComon.cuh:268-291`, `BuildTree.cu:13-17`) is
deliberately NOT reproduced: construction here is a deterministic
sort/scan pipeline (quantize -> Morton -> radix sort -> Karras 2012 internal
node linking -> bottom-up AABB refit), which is reproducible, rebuilt per
frame entirely on device, and friendly to differentiation.

The output is a flattened index-based node array — the design the
reference's own unfinished wavefront path was reaching for
(`bmBvhNode{hs,cp,left,right}` packed-index nodes, `Trace2.cu:21-43`) —
threaded with hit/skip links so traversal needs NO per-ray stack at all
(the reference burns a 38-deep local stack per thread,
`BuildTree.cu:384-387`).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import BvhConfig


#: Leaf ranges pack into one int32 as ``first * LEAF_PACK + count``;
#: bounds max_leaf_faces and keeps first < 2^25 faces addressable.
LEAF_PACK = 64


class Bvh(NamedTuple):
    """Flattened, threaded BVH.

    Nodes: ``N = 2*F - 1`` (internal 0..F-2, Karras leaves F-1..2F-2);
    node 0 is the root (for F == 1 there is a single leaf node).

    Traversal contract (see `trace/traverse.py`): at node ``v`` test the
    AABB; on miss go to ``skip_link[v]``; on hit go to ``hit_link[v]`` if
    internal, else intersect faces ``face_order[leaf_first[v] :
    leaf_first[v]+leaf_count[v]]`` and then go to ``skip_link[v]``.
    ``-1`` terminates.

    The hot traversal path reads only the HBM-friendly packed layouts:

    ``packed_nodes [N,6]`` float32 — aabb min | aabb max, one row gather
      per node visit.

    ``packed_links [N,2]`` int32 — per node:
      [0] "a-link": >= 0 -> internal, value = hit link;
          < 0 -> leaf, value = -(first*LEAF_PACK + count) - 2,
      [1] skip link (-1 terminates).
      Links are a SEPARATE int array on purpose: bitcasting them into
      float rows can corrupt them (NaN canonicalization rewrites the
      0xFFFFFFFF pattern of -1, and denormal flush zeroes small links).

    ``packed_tris [F+LEAF_PACK,9]`` float32 — triangle vertices PRE-SORTED in Morton
    order (row s = corners of face ``face_order[s]``), so the leaf sweep
    is a single contiguous-row gather with no index indirection; the best
    sorted slot maps back to a face id via ``face_order`` once, at the end.
    """

    node_min: jnp.ndarray  # [N,3] float32
    node_max: jnp.ndarray  # [N,3] float32
    hit_link: jnp.ndarray  # [N] int32: internal -> left child
    skip_link: jnp.ndarray  # [N] int32: next node after this subtree, -1 = done
    is_leaf: jnp.ndarray  # [N] bool (after collapse)
    leaf_first: jnp.ndarray  # [N] int32 into face_order
    leaf_count: jnp.ndarray  # [N] int32
    face_order: jnp.ndarray  # [F] int32: face ids in Morton order
    packed_nodes: jnp.ndarray  # [N,6] float32 aabb min|max
    packed_links: jnp.ndarray  # [N,2] int32 a-link | skip link
    packed_tris: jnp.ndarray  # [F+LEAF_PACK,9] float32 sorted v0|v1|v2 (zero tail)

    @property
    def num_faces(self) -> int:
        return self.face_order.shape[0]


def _pack_layouts(node_min, node_max, hit_link, skip_link, is_leaf,
                  leaf_first, leaf_count, face_order, v0, v1, v2):
    """Assemble the packed node/tri layouts from the component arrays."""
    a_link = jnp.where(
        is_leaf, -(leaf_first * LEAF_PACK + leaf_count) - 2, hit_link
    ).astype(jnp.int32)
    packed_nodes = jnp.concatenate([node_min, node_max], axis=1)
    packed_links = jnp.stack([a_link, skip_link.astype(jnp.int32)], axis=1)
    # LEAF_PACK zero rows of tail padding let the dense-test phase read
    # whole leaves with unclipped contiguous slices (zero rows are
    # degenerate triangles -> NaN barycentrics -> MT miss).
    packed_tris = jnp.concatenate(
        [v0[face_order], v1[face_order], v2[face_order]], axis=1
    )
    packed_tris = jnp.concatenate(
        [packed_tris, jnp.zeros((LEAF_PACK, 9), jnp.float32)], axis=0
    )
    return packed_nodes, packed_links, packed_tris


# ---------------------------------------------------------------------------
# Morton codes.  The reference quantizes points to 0.03-sized cells and
# Fletcher16-hashes them (`Hash.cu:17-63`); here the same quantization idea
# feeds a Z-order curve instead of a lossy hash.
# ---------------------------------------------------------------------------

def _part1by2(x: jnp.ndarray) -> jnp.ndarray:
    """Spread the low 10 bits of x two apart (Morton interleave helper)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton3d(q: jnp.ndarray) -> jnp.ndarray:
    """``[...,3]`` uint32 (10-bit) -> 30-bit Morton codes."""
    return (
        (_part1by2(q[..., 0]) << 2)
        | (_part1by2(q[..., 1]) << 1)
        | _part1by2(q[..., 2])
    )


def morton_codes(centroids: jnp.ndarray, smin, smax, bits: int = 10) -> jnp.ndarray:
    """Quantize centroids into the scene AABB and interleave."""
    scale = (1 << bits) - 1
    extent = jnp.maximum(smax - smin, 1e-12)
    q = jnp.clip((centroids - smin) / extent * scale, 0, scale).astype(jnp.uint32)
    return morton3d(q)


# ---------------------------------------------------------------------------
# Karras 2012 internal-node construction, fully vectorized.
# ---------------------------------------------------------------------------

def _clz32(x: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.clz(x.astype(jnp.uint32)).astype(jnp.int32)


def _karras_ranges(codes: jnp.ndarray):
    """For each internal node i in [0, n-2], the covered sorted-leaf range
    and the split position, via the longest-common-prefix metric.

    All three searches run exactly ``ceil(log2(n))``-bounded trip counts
    (n is static), not fixed 30-32 passes — ranges can never exceed n."""
    n = codes.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    log2n = max(1, (n - 1).bit_length())

    # The query side of every LCP probe is node i = arange(n-1), so its
    # codes are a SLICE, not a gather — this halves the data-dependent
    # gather count of the three searches (the probes' cj gathers are the
    # irreducible remainder).
    ci_all = codes[: n - 1]

    def delta(i, j):
        """LCP of sorted keys i and j; -1 outside [0, n).  Equal codes fall
        back to index bits (Karras's augmented key), making keys unique."""
        valid = (j >= 0) & (j < n)
        cj = codes[jnp.clip(j, 0, n - 1)]
        x = ci_all ^ cj
        d = jnp.where(
            x == 0,
            32 + _clz32((i ^ j).astype(jnp.uint32)),
            _clz32(x),
        )
        return jnp.where(valid, d, -1)

    i = idx[: n - 1]
    d = jnp.sign(delta(i, i + 1) - delta(i, i - 1)).astype(jnp.int32)
    dmin = delta(i, i - d)

    def delta3(m1, m2, m3):
        """delta(i, i + m*d) for three probe distances in ONE gather.

        Every search round costs one data-dependent gather launch.
        Batching a round's probes into one [3(n-1)] gather halves the
        launch count vs classic radix-2."""
        m = jnp.stack([m1, m2, m3])  # [3, n-1]
        j = i[None, :] + m * d[None, :]
        valid = (j >= 0) & (j < n)
        cj = codes[jnp.clip(j.reshape(-1), 0, n - 1)].reshape(3, n - 1)
        x = ci_all[None, :] ^ cj
        dd = jnp.where(
            x == 0,
            32 + _clz32((i[None, :] ^ j).astype(jnp.uint32)),
            _clz32(x),
        )
        return jnp.where(valid, dd, -1)

    def radix4_max_prefix(threshold):
        """Largest l in [0, B) with delta(i, i+l*d) > threshold for ALL
        prefixes — valid because LCP against i is monotone non-increasing
        with distance over sorted keys.  Radix-4: ceil(log2(n)/2) rounds,
        one batched gather each (replaces the doubling + radix-2 binary
        pair, which cost 2*log2(n) gather launches)."""
        m = (log2n + 1) // 2
        B = 1 << (2 * m)  # power of 4 >= n
        l = jnp.zeros_like(i)
        b = B >> 2
        while b >= 1:
            dd = delta3(l + b, l + 2 * b, l + 3 * b)
            p1, p2, p3 = dd[0] > threshold, dd[1] > threshold, dd[2] > threshold
            l = l + b * jnp.where(p3, 3, jnp.where(p2, 2, jnp.where(p1, 1, 0)))
            b >>= 2
        return l

    # Other end j = i + l*d: largest l with delta still above dmin.
    l = radix4_max_prefix(dmin)
    j = i + l * d

    # Split position: first step from i where the running LCP drops to
    # dnode (probes past j read delta <= dmin <= dnode, so the same
    # monotone search applies unchanged).
    dnode = delta(i, j)
    s = radix4_max_prefix(dnode)
    gamma = i + s * d + jnp.minimum(d, 0)

    first = jnp.minimum(i, j)
    last = jnp.maximum(i, j)
    return first, last, gamma


# ---------------------------------------------------------------------------
# Build.
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cfg",))
def build_bvh(positions: jnp.ndarray, faces: jnp.ndarray, cfg: BvhConfig = BvhConfig()) -> Bvh:
    """Build the threaded LBVH for a flattened scene.

    Args:
      positions: ``[V,3]`` float32 vertex positions.
      faces: ``[F,4]`` int32 face table (3 vertex ids + mesh id).
      cfg: build knobs (static).

    The whole build is jittable and runs on device every call — the
    deterministic analog of the reference's per-frame
    reset+insert rebuild (`SceneTree.cpp:70-91`).
    """
    num_faces = faces.shape[0]
    # One [3F] corner gather instead of three [F] gathers.
    corners = positions[faces[:, :3].reshape(-1)].reshape(num_faces, 3, 3)
    v0, v1, v2 = corners[:, 0], corners[:, 1], corners[:, 2]
    tri_min = jnp.minimum(v0, jnp.minimum(v1, v2))
    tri_max = jnp.maximum(v0, jnp.maximum(v1, v2))
    centroids = (tri_min + tri_max) * 0.5
    smin = jnp.min(tri_min, axis=0)
    smax = jnp.max(tri_max, axis=0)

    codes = morton_codes(centroids, smin, smax, cfg.morton_bits)
    order = jnp.argsort(codes, stable=True).astype(jnp.int32)
    codes = codes[order]

    if num_faces == 1:
        packed_nodes, packed_links, packed_tris = _pack_layouts(
            tri_min, tri_max,
            jnp.array([-1], jnp.int32), jnp.array([-1], jnp.int32),
            jnp.array([True]), jnp.array([0], jnp.int32),
            jnp.array([1], jnp.int32), order, v0, v1, v2,
        )
        return Bvh(
            node_min=tri_min,
            node_max=tri_max,
            hit_link=jnp.array([-1], jnp.int32),
            skip_link=jnp.array([-1], jnp.int32),
            is_leaf=jnp.array([True]),
            leaf_first=jnp.array([0], jnp.int32),
            leaf_count=jnp.array([1], jnp.int32),
            face_order=order,
            packed_nodes=packed_nodes,
            packed_links=packed_links,
            packed_tris=packed_tris,
        )

    n = num_faces
    num_nodes = 2 * n - 1
    leaf_base = n - 1  # leaf j lives at node leaf_base + j

    first, last, gamma = _karras_ranges(codes)
    left = jnp.where(first == gamma, leaf_base + gamma, gamma)
    right = jnp.where(last == gamma + 1, leaf_base + gamma + 1, gamma + 1)

    # Parent pointers (scatter; each node has exactly one parent).
    internal_ids = jnp.arange(n - 1, dtype=jnp.int32)
    parent = jnp.full((num_nodes,), -1, jnp.int32)
    parent = parent.at[left].set(internal_ids)
    parent = parent.at[right].set(internal_ids)

    # Per-node sorted-face ranges.
    node_first = jnp.concatenate([first, jnp.arange(n, dtype=jnp.int32)])
    node_last = jnp.concatenate([last, jnp.arange(n, dtype=jnp.int32)])
    size = node_last - node_first + 1

    # ---- AABB "refit" as a range-min/max query ----------------------------
    # A Karras node's AABB is the union of a CONTIGUOUS run of sorted leaf
    # boxes, so instead of O(depth) bottom-up converging passes we build a
    # sparse table (log2(n) elementwise min/max passes over the sorted leaf
    # boxes) and answer every internal node with two gathers — O(n log n)
    # work with no sequential tree-depth dependence at all.
    leaf_min = tri_min[order]
    leaf_max = tri_max[order]
    log2n = max(1, (n - 1).bit_length())

    def sparse_table(leaf_vals, combine):
        tbl = [leaf_vals]
        for k in range(1, log2n + 1):
            prev = tbl[-1]
            sh = min(1 << (k - 1), n - 1)
            # Static edge-clamped shift as slice+broadcast (NOT a gather:
            # the indices are static, and XLA lowers slices for free).
            shifted = jnp.concatenate(
                [prev[sh:], jnp.broadcast_to(prev[-1:], (sh,) + prev.shape[1:])],
                axis=0)
            tbl.append(combine(prev, shifted))
        return jnp.stack(tbl)  # [log2n+1, n, 3]

    tbl_min = sparse_table(leaf_min, jnp.minimum)
    tbl_max = sparse_table(leaf_max, jnp.maximum)
    length = last - first + 1
    klev = 31 - _clz32(length)  # floor(log2(len)) per internal node
    hi_start = last - (1 << klev) + 1

    def rmq(tbl, combine):
        flat = tbl.reshape(-1, 3)
        a = flat[klev * n + first]
        b = flat[klev * n + hi_start]
        return combine(a, b)

    node_min = jnp.concatenate([rmq(tbl_min, jnp.minimum), leaf_min])
    node_max = jnp.concatenate([rmq(tbl_max, jnp.maximum), leaf_max])

    # ---- leaf collapse ---------------------------------------------------
    # A node becomes a traversal leaf when its subtree is small enough and
    # its parent's is not (MAX_FACES_PER_BOX analog, `BuildTree.cuh:17`).
    k = cfg.max_leaf_faces
    parent_size = jnp.where(parent >= 0, size[jnp.maximum(parent, 0)], n + 1)
    is_leaf = (size <= k) & (parent_size > k)

    # ---- skip-link threading (closed form) --------------------------------
    # In pre-order, the node visited after finishing subtree [a, b] is the
    # LARGEST node whose range starts at b+1 (ranges starting at one index
    # are nested, so "largest" is unique); no node follows b == n-1.  This
    # replaces the O(depth) pointer-propagation passes with two scatters.
    node_ids = jnp.arange(num_nodes, dtype=jnp.int32)
    best_size = jnp.zeros((n,), jnp.int32).at[node_first].max(size)
    winner = size == best_size[node_first]
    best_id = (
        jnp.full((n,), -1, jnp.int32)
        .at[node_first]
        .max(jnp.where(winner, node_ids, -1))
    )
    skip_link = jnp.where(node_last == n - 1, -1, best_id[jnp.minimum(node_last + 1, n - 1)])

    hit_link = jnp.concatenate([left, jnp.full((n,), -1, jnp.int32)])

    assert cfg.max_leaf_faces < LEAF_PACK, "max_leaf_faces must fit LEAF_PACK"
    packed_nodes, packed_links, packed_tris = _pack_layouts(
        node_min, node_max, hit_link, skip_link, is_leaf,
        node_first, size, order, v0, v1, v2,
    )

    return Bvh(
        node_min=node_min,
        node_max=node_max,
        hit_link=hit_link,
        skip_link=skip_link,
        is_leaf=is_leaf,
        leaf_first=node_first,
        leaf_count=size,
        face_order=order,
        packed_nodes=packed_nodes,
        packed_links=packed_links,
        packed_tris=packed_tris,
    )
