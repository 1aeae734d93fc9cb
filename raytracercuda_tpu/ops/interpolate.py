"""Barycentric vertex-attribute interpolation and indexed-face intersection.

Equivalents of the reference's indexed-face helpers
(`Raytracer/CudaComon.cuh:243-266`): gather a face's three vertex attributes
by index and blend with Möller–Trumbore barycentrics.  Fully batched over
arbitrary leading dims of ``face_ids``/``u``/``v``.
"""

from __future__ import annotations

import jax.numpy as jnp

from .math import tri_intersect


def face_interpolate(attr, faces, face_ids, u, v):
    """``bmFaceInterpolate`` (`CudaComon.cuh:253-266`): ``a0*w + a1*u + a2*v``
    with ``w = 1-(u+v)``.

    Args:
      attr: ``[V, k]`` concatenated vertex attribute.
      faces: ``[F, 4]`` face table (global vertex ids + mesh id).
      face_ids: integer array ``[...]``; negative ids are clamped to 0
        (callers mask misses).
      u, v: barycentrics ``[...]``.
    Returns:
      ``[..., k]`` interpolated attribute.
    """
    safe_ids = jnp.maximum(face_ids, 0)
    f = faces[safe_ids]
    a0 = attr[f[..., 0]]
    a1 = attr[f[..., 1]]
    a2 = attr[f[..., 2]]
    w = 1.0 - (u + v)
    return a0 * w[..., None] + a1 * u[..., None] + a2 * v[..., None]


def face_ray_intersect(positions, faces, face_ids, orig, direction):
    """``bmFaceRayIntersect`` (`CudaComon.cuh:243-251`): fetch the face's
    corner positions by index and run Möller–Trumbore.  Returns (t, u, v)."""
    safe_ids = jnp.maximum(face_ids, 0)
    f = faces[safe_ids]
    v0 = positions[f[..., 0]]
    v1 = positions[f[..., 1]]
    v2 = positions[f[..., 2]]
    return tri_intersect(orig, direction, v0, v1, v2)
