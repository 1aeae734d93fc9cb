"""Core SoA value types for the ray tracer.

The reference passes AoS device structs across the host/device ABI
(`Raytracer/SharedTypes.h:10-37`: ``StaticMeshData``, ``bmFace``,
``bmRayFaceHitResult``).  Here everything is a structure-of-arrays
pytree of jnp arrays: rays are ``[R,3]`` bundles, hit records are flat
``[R]`` component arrays, and faces are rows of an ``[F,4]`` int table
(3 vertex indices + mesh index — the exact payload of ``bmFace::m_index``,
`SharedTypes.h:25-29` — but stored as one array instead of per-face structs).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

# Numeric limits: the reference uses FLT_MAX as the miss sentinel throughout
# (`CudaComon.cuh:143,147`, `BuildTree.cu:389`).  NumPy scalars on purpose:
# module import must NOT initialize the JAX backend (multi-host bring-up
# calls `jax.distributed.initialize` after importing the package).
FLT_MAX = np.float32(3.4028234663852886e38)

# Sentinel for "no face" / invalid index.
INVALID_U32 = np.uint32(0xFFFFFFFF)
INVALID_I32 = np.int32(-1)


class Rays(NamedTuple):
    """A bundle of rays (SoA).

    ``origin``/``direction``: float32 ``[..., 3]``.  Direction need not be
    normalized for intersection correctness (Möller–Trumbore and slab tests
    are scale-covariant in t), but camera rays are normalized exactly as the
    reference's precomputed ray grid is (`Camera.cpp:61-66`).
    """

    origin: jnp.ndarray
    direction: jnp.ndarray


class Hit(NamedTuple):
    """Closest-hit record (SoA) — the ``bmRayFaceHitResult`` analog
    (`SharedTypes.h:31-35`) with the face pointer replaced by an index.

    ``t`` is FLT_MAX on miss; ``face`` is -1 (int32) on miss.
    ``u``/``v`` are Möller–Trumbore barycentrics of the hit triangle.
    """

    t: jnp.ndarray
    u: jnp.ndarray
    v: jnp.ndarray
    face: jnp.ndarray  # int32 face id into the scene's flattened face table

    @property
    def hit_mask(self) -> jnp.ndarray:
        return self.face >= 0


def miss_hit(shape) -> Hit:
    """An all-miss Hit record of the given batch shape."""
    return Hit(
        t=jnp.full(shape, FLT_MAX, jnp.float32),
        u=jnp.zeros(shape, jnp.float32),
        v=jnp.zeros(shape, jnp.float32),
        face=jnp.full(shape, -1, jnp.int32),
    )
