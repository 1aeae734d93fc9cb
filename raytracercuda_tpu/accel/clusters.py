"""Morton-ordered triangle clusters: the dense (matrix-form) acceleration
structure behind the CLUSTER fast path.

The reference accelerates rays with pointer trees walked one node per
thread-step (`Raytracer/BuildTree.cu:367-499`).  This module builds a
structure for the opposite shape, *dense rectangular work*:

  * Triangles are sorted by the Morton code of their centroid (the same
    quantize-and-order idea as the reference's spatial hash,
    `Raytracer/Hash.cu:17-63`, minus the lossy Fletcher16 step) and grouped
    into fixed-size clusters of ``cluster_size`` consecutive triangles.
  * Each cluster's AABB comes from a single reshape-reduction — the entire
    "build" is sort + reshape + min/max, where the reference spends
    51.7 ms of atomicCAS tree insertion (`aa.xml` row 3, GTX 660 Ti).
  * Per-triangle Möller–Trumbore constants are precomputed in a layout that
    turns the inner intersection loop into MATRIX MULTIPLIES (see
    `trace/dense.py`): for rays sharing an origin (a pinhole frame) or a
    direction (a directional-light shadow pass), ``(det, u·det, v·det)``
    are *linear* in the per-ray vector, so a ray tile tests a candidate
    cluster with one ``[R,3] @ [3, 3·L]`` contraction plus a handful of
    elementwise compare ops.

Cluster AABBs are deliberately a *flat* level (no tree): the
``[tiles, clusters]`` rectangle is culled densely.  `trace/dense.py`
chunks the rectangle when it outgrows memory.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import ClusterConfig
from .bvh import morton_codes


class ClusterSet(NamedTuple):
    """Flat cluster table + matrix-form triangle constants.

    ``C`` clusters of ``L = cluster_size`` Morton-consecutive triangles;
    the last cluster may be padded with degenerate (all-zero) triangles,
    which miss every ray (zero determinant).

    Layouts are chosen for the dense trace path's access patterns:
    whole-cluster rows gather contiguously, and the per-cluster matrices
    are ready to feed batched matmuls without transposition.
    """

    #: [C,3] / [C,3] cluster AABBs (from the real triangles only).
    cmin: jnp.ndarray
    cmax: jnp.ndarray
    #: [C, L, 9] float32 — v0 | v1 | v2 per sorted triangle (zero padding).
    #: Corners (not edges) so the winner re-intersection in `trace/dense.py`
    #: reproduces the oracle's `tri_intersect` bit-for-bit.
    tris: jnp.ndarray
    #: [C, L, 3] float32 — geometric normal P = e1 x e2 (zero padding).
    normal: jnp.ndarray
    #: [C*L] int32 — original face id per sorted slot (-1 for padding).
    face_order: jnp.ndarray

    @property
    def num_clusters(self) -> int:
        return self.cmin.shape[0]

    @property
    def cluster_size(self) -> int:
        return self.tris.shape[1]


@partial(jax.jit, static_argnames=("cfg",))
def build_clusters(
    positions: jnp.ndarray,
    faces: jnp.ndarray,
    cfg: ClusterConfig = ClusterConfig(),
) -> ClusterSet:
    """Sort triangles in Morton order and cut them into fixed clusters.

    Args:
      positions: ``[V,3]`` float32 vertex positions.
      faces: ``[F,4]`` int32 face table (3 vertex ids + mesh id).

    Fully jittable; rebuilt per frame like the reference's per-frame
    reset+insert rebuild (`SceneTree.cpp:70-91`), at a tiny fraction of
    the cost (sort + reshape reductions, no pointer publication).
    """
    L = cfg.cluster_size
    num_faces = faces.shape[0]
    v0 = positions[faces[:, 0]]
    v1 = positions[faces[:, 1]]
    v2 = positions[faces[:, 2]]
    tri_min = jnp.minimum(v0, jnp.minimum(v1, v2))
    tri_max = jnp.maximum(v0, jnp.maximum(v1, v2))
    centroids = (tri_min + tri_max) * 0.5
    smin = jnp.min(tri_min, axis=0)
    smax = jnp.max(tri_max, axis=0)

    codes = morton_codes(centroids, smin, smax, cfg.morton_bits)
    order = jnp.argsort(codes, stable=True).astype(jnp.int32)

    num_clusters = -(-num_faces // L)
    pad = num_clusters * L - num_faces

    def padded(x, fill):
        if pad == 0:
            return x
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, widths, constant_values=fill)

    face_order = padded(order, -1)
    sv0 = padded(v0[order], 0.0).reshape(num_clusters, L, 3)
    sv1 = padded(v1[order], 0.0).reshape(num_clusters, L, 3)
    sv2 = padded(v2[order], 0.0).reshape(num_clusters, L, 3)
    normal = jnp.cross(sv1 - sv0, sv2 - sv0)

    # Cluster AABBs over real triangles only (padding excluded by +/-inf).
    cmin = padded(tri_min[order], jnp.inf).reshape(num_clusters, L, 3).min(axis=1)
    cmax = padded(tri_max[order], -jnp.inf).reshape(num_clusters, L, 3).max(axis=1)

    tris = jnp.concatenate([sv0, sv1, sv2], axis=-1)
    return ClusterSet(cmin=cmin, cmax=cmax, tris=tris, normal=normal,
                      face_order=face_order)


# ---------------------------------------------------------------------------
# Frame-level matrix constants.  Derived inside the jitted frame function —
# they depend on the shared ray origin (pinhole eye) or shared direction
# (directional light), which change every frame.
# ---------------------------------------------------------------------------


class OriginConsts(NamedTuple):
    """MT constants for a COMMON-ORIGIN bundle (pinhole primary rays).

    For a ray ``eye + t*D`` against triangle ``(v0, e1, e2)`` with
    ``tvec = eye - v0`` and ``P = e1 x e2``::

        det   = -(D . P)
        u*det =   D . (e2 x tvec)      (qu)
        v*det =   D . (tvec x e1)      (qv)
        t*det =   tvec . P             (st, per-triangle scalar)

    so each quantity is one ``[R,3] @ [3, L·K]`` matmul per tile round.
    Each matrix keeps the natural ``[C, L, 3]`` layout — building them is
    pure elementwise work (no transpose/stack materialization), and the
    sweep's gathered rows feed dot_general's contraction directly.
    """

    mp: jnp.ndarray  # [C, L, 3] float32: -P (det = D . -P)
    qu: jnp.ndarray  # [C, L, 3] float32: e2 x tvec (u*det = D . qu)
    qv: jnp.ndarray  # [C, L, 3] float32: tvec x e1 (v*det = D . qv)
    st: jnp.ndarray  # [C, L] float32


class DirectionConsts(NamedTuple):
    """MT constants for a COMMON-DIRECTION bundle (directional shadows).

    With shared ``D`` and per-ray origin ``O``::

        det   = -(D . P)                       (per-triangle scalar)
        u*det =  O . pvec - v0 . pvec,  pvec = D x e2
        v*det =  O . mvec - v0 . mvec,  mvec = e1 x D
        t*det =  O . P    - v0 . P

    so the per-ray part is again per-quantity ``[R,3] @ [3, L·K]``
    matmuls over the natural ``[C, L, 3]`` layouts.  ``off``/``det``
    carry the per-triangle scalars.
    """

    pvec: jnp.ndarray  # [C, L, 3] float32: D x e2
    mvec: jnp.ndarray  # [C, L, 3] float32: e1 x D
    pp: jnp.ndarray  # [C, L, 3] float32: P = e1 x e2
    off: jnp.ndarray  # [C, L, 3] float32: v0.pvec | v0.mvec | v0.P
    det: jnp.ndarray  # [C, L] float32


def origin_consts(cs: ClusterSet, eye: jnp.ndarray) -> OriginConsts:
    """Per-frame common-origin constants (elementwise over all triangles)."""
    v0 = cs.tris[..., 0:3]
    e1 = cs.tris[..., 3:6] - v0
    e2 = cs.tris[..., 6:9] - v0
    tvec = eye[None, None, :] - v0
    qu = jnp.cross(e2, tvec)
    qv = jnp.cross(tvec, e1)
    st = jnp.sum(tvec * cs.normal, axis=-1)  # [C, L]
    return OriginConsts(mp=-cs.normal, qu=qu, qv=qv, st=st)


def direction_consts(cs: ClusterSet, d: jnp.ndarray) -> DirectionConsts:
    """Per-frame common-direction constants (elementwise over triangles)."""
    v0 = cs.tris[..., 0:3]
    e1 = cs.tris[..., 3:6] - v0
    e2 = cs.tris[..., 6:9] - v0
    pvec = jnp.cross(jnp.broadcast_to(d, e2.shape), e2)
    mvec = jnp.cross(e1, jnp.broadcast_to(d, e1.shape))
    det = -jnp.sum(d * cs.normal, axis=-1)  # [C, L]
    off = jnp.stack(
        [
            jnp.sum(v0 * pvec, axis=-1),
            jnp.sum(v0 * mvec, axis=-1),
            jnp.sum(v0 * cs.normal, axis=-1),
        ],
        axis=-1,
    )  # [C, L, 3]
    return DirectionConsts(pvec=pvec, mvec=mvec, pp=cs.normal, off=off,
                           det=det)
