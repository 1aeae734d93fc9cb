"""Vectorized device math — the equivalent of the reference's inline
device math library (`Raytracer/CudaComon.cuh:71-236`).

Every function here is pure JAX, fully broadcastable over leading batch
dimensions, and usable in plain jitted code.
Nothing is scalar: where the reference computes one ray/triangle per CUDA
thread, these compute whole ``[R]``/``[F]`` batches.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..types import FLT_MAX


# ---------------------------------------------------------------------------
# Color packing (`CudaComon.cuh:85-115`).
# The reference packs float RGB into a u32 as (r<<16)|(g<<8)|b.  The CUDA
# path truncates (u32 cast); the CPU path rounds (lrintf).  We match the CUDA
# path (that is what produced the reference's images).
# ---------------------------------------------------------------------------

def _to_u8(x):
    # The clamped [0,255] range is exactly representable in int32.
    return jnp.clip(x, 0.0, 255.0).astype(jnp.int32).astype(jnp.uint32)


def pack_rgb(r, g, b):
    """float [0,1] channels -> packed u32 0x00RRGGBB (`CudaComon.cuh:85-98`)."""
    ru = _to_u8(r * 255.0)
    gu = _to_u8(g * 255.0)
    bu = _to_u8(b * 255.0)
    return (ru << 16) | (gu << 8) | bu


def pack_rgb_vec(v):
    """``[...,3]`` float -> packed u32 (`CudaComon.cuh:100-104`)."""
    return pack_rgb(v[..., 0], v[..., 1], v[..., 2])


def pack_gray(r):
    """Single float -> gray packed u32 (`CudaComon.cuh:106-115`)."""
    ru = _to_u8(r * 255.0)
    return (ru << 16) | (ru << 8) | ru


def unpack_rgb(packed):
    """Packed u32 -> float ``[...,3]`` RGB in [0,1] (inverse of pack_rgb)."""
    p = packed.astype(jnp.uint32)
    r = ((p >> 16) & 0xFF).astype(jnp.float32) / 255.0
    g = ((p >> 8) & 0xFF).astype(jnp.float32) / 255.0
    b = (p & 0xFF).astype(jnp.float32) / 255.0
    return jnp.stack([r, g, b], axis=-1)


# ---------------------------------------------------------------------------
# Vector helpers.
# ---------------------------------------------------------------------------

def dot(a, b):
    """Row-wise dot product over the trailing axis of 3-vectors."""
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    return jnp.cross(a, b)


def normalize(v, eps: float = 0.0):
    n = jnp.sqrt(jnp.maximum(dot(v, v), eps))
    return v / n[..., None]


# ---------------------------------------------------------------------------
# Möller–Trumbore ray/triangle intersection (`CudaComon.cuh:117-155`).
# ---------------------------------------------------------------------------

def tri_intersect(orig, direction, v0, v1, v2):
    """Möller–Trumbore, broadcastable.

    Faithful to `bmTriIntersect` (`CudaComon.cuh:117-155`): no epsilon/
    determinant culling (a tiny det yields a huge invDet; the u/v window
    tests then reject), no positivity check on the returned distance — the
    caller clips if desired.  Returns ``(t, u, v)`` with ``t == FLT_MAX``
    on miss.

    All of ``orig``, ``direction``, ``v0/v1/v2`` are ``[...,3]`` and
    broadcast together; typical shapes are rays ``[R,1,3]`` against
    triangles ``[1,F,3]``.
    """
    v0v1 = v1 - v0
    v0v2 = v2 - v0
    pvec = cross(direction, v0v2)
    det = dot(v0v1, pvec)
    inv_det = 1.0 / det  # inf for parallel rays is fine, as in the reference
    tvec = orig - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, v0v1)
    v = dot(direction, qvec) * inv_det
    t = dot(v0v2, qvec) * inv_det
    miss = (u < 0.0) | (u > 1.0) | (v < 0.0) | (u + v > 1.0)
    # NaN u/v (degenerate 0/0) must also miss: comparisons with NaN are
    # False, so fold them in explicitly.
    miss = miss | jnp.isnan(u) | jnp.isnan(v) | jnp.isnan(t)
    t = jnp.where(miss, FLT_MAX, t)
    return t, u, v


# ---------------------------------------------------------------------------
# Branchless slab ray/AABB intersection (`CudaComon.cuh:158-187`).
# ---------------------------------------------------------------------------

def box_ray_intersect(bmin, bmax, orig, inv_dir):
    """Slab test returning entry distance, clamped to 0 when the origin is
    inside; FLT_MAX on miss (`bmBoxRayIntersect`, `CudaComon.cuh:158-172`)."""
    t_min = (bmin - orig) * inv_dir
    t_max = (bmax - orig) * inv_dir
    t_far = jnp.min(jnp.maximum(t_min, t_max), axis=-1)
    t_near = jnp.max(jnp.minimum(t_min, t_max), axis=-1)
    dist = jnp.maximum(0.0, t_near)
    dist = jnp.where(t_far >= t_near, dist, FLT_MAX)
    dist = jnp.where(t_far < 0.0, FLT_MAX, dist)
    return dist


def box_ray_intersect_no_zero(bmin, bmax, orig, inv_dir):
    """Slab variant returning the exit distance when the entry is behind or
    at the origin (`bmBoxRayIntersectNoZero`, `CudaComon.cuh:174-187`).
    Used by the grid DDA march to step *through* the current cell."""
    t_min = (bmin - orig) * inv_dir
    t_max = (bmax - orig) * inv_dir
    t_near = jnp.max(jnp.minimum(t_min, t_max), axis=-1)
    t_far = jnp.min(jnp.maximum(t_min, t_max), axis=-1)
    return jnp.where(jnp.isinf(t_near) | (t_near < 0.0), t_far, t_near)


def aabb_overlap(amin, amax, bmin, bmax):
    """Axis-aligned box overlap (`bmAABBOverlap`, `CudaComon.cuh:189-212`)."""
    sep = jnp.any(amin > bmax, axis=-1) | jnp.any(amax < bmin, axis=-1)
    return ~sep


def validate_aabb(bmin, bmax):
    """True where the AABB is valid (the reference asserts when all three
    extents are negative, `bmValidateAABB`, `CudaComon.cuh:214-228`)."""
    return ~jnp.all((bmax - bmin) < 0.0, axis=-1)
