"""Vectorized separating-axis triangle/AABB overlap test.

Equivalent of the reference's Akenine-Möller 13-axis SAT test
(`Raytracer/BoxTriangle.cuh:57-222`, the public-domain classic).  Instead of
macro-generated scalar early-outs per CUDA thread, this evaluates all 13
axes branchlessly over whole batches of (triangle, box) pairs.

The 13 axes are:
  * 9 cross products  e_i x unit_j  (i edge, j coordinate axis),
  * 3 box face normals (equivalent to tri-AABB vs box overlap),
  * 1 triangle face normal (plane/box overlap).

Used by both acceleration-structure builders, exactly as the reference uses
``triBoxOverlap`` from the kd-tree build (`BuildTree.cu:223-226`) and the
hash-grid build (`Hash.cu:170`).
"""

from __future__ import annotations

import jax.numpy as jnp


def _axis_separates(axis, v0, v1, v2, half):
    """True where ``axis`` is a separating axis.

    Projects the (box-centered) triangle vertices onto ``axis`` and compares
    against the box projection radius ``sum(|axis| * half)``.
    """
    p0 = jnp.sum(axis * v0, axis=-1)
    p1 = jnp.sum(axis * v1, axis=-1)
    p2 = jnp.sum(axis * v2, axis=-1)
    lo = jnp.minimum(p0, jnp.minimum(p1, p2))
    hi = jnp.maximum(p0, jnp.maximum(p1, p2))
    rad = jnp.sum(jnp.abs(axis) * half, axis=-1)
    return (lo > rad) | (hi < -rad)


def tri_box_overlap(box_center, box_half, t0, t1, t2):
    """Batched SAT triangle/box overlap (`BoxTriangle.cuh:134-222`).

    Args:
      box_center, box_half: ``[...,3]`` box center and half-extent.
      t0, t1, t2: ``[...,3]`` triangle vertices.  All broadcast together.

    Returns:
      bool array: True where the triangle overlaps the box.
    """
    # Move the box center to the origin (`BoxTriangle.cuh:154-156`).
    v0 = t0 - box_center
    v1 = t1 - box_center
    v2 = t2 - box_center

    e0 = v1 - v0
    e1 = v2 - v1
    e2 = v0 - v2

    zeros = jnp.zeros_like(v0[..., 0])

    def axes_for_edge(e):
        # cross(e, x̂) = (0, e.z, -e.y), cross(e, ŷ) = (-e.z, 0, e.x),
        # cross(e, ẑ) = (e.y, -e.x, 0).  Sign conventions differ from the
        # macro expansion but SAT is sign-invariant.
        ax = jnp.stack([zeros, e[..., 2], -e[..., 1]], axis=-1)
        ay = jnp.stack([-e[..., 2], zeros, e[..., 0]], axis=-1)
        az = jnp.stack([e[..., 1], -e[..., 0], zeros], axis=-1)
        return ax, ay, az

    separated = zeros.astype(bool)
    for e in (e0, e1, e2):
        for axis in axes_for_edge(e):
            separated = separated | _axis_separates(axis, v0, v1, v2, box_half)

    # Bullet 1: box face normals == triangle AABB vs box
    # (`BoxTriangle.cuh:196-209`).
    tri_min = jnp.minimum(v0, jnp.minimum(v1, v2))
    tri_max = jnp.maximum(v0, jnp.maximum(v1, v2))
    separated = separated | jnp.any(
        (tri_min > box_half) | (tri_max < -box_half), axis=-1
    )

    # Bullet 2: triangle plane vs box (`BoxTriangle.cuh:57-79,215-219`):
    # overlap iff |dot(n, v0)| <= sum(half * |n|).
    normal = jnp.cross(e0, e1)
    s = jnp.sum(normal * v0, axis=-1)
    r = jnp.sum(jnp.abs(normal) * box_half, axis=-1)
    separated = separated | (jnp.abs(s) > r)

    return ~separated
