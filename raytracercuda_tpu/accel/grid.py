"""Hashed uniform-grid acceleration structure — deterministic CSR build.

Equivalent of the reference's spatial-hash backend
(`Raytracer/Hash.cu`, `SceneHash.cpp`): points/triangles quantize to
0.03-sized cells, each cell hashes to one of 65,536 buckets by a
per-coordinate Fletcher16 checksum summed mod 65,536 (`Hash.cu:17-54`),
and triangles are inserted into every overlapped (SAT-tested) cell
(`Hash.cu:132-178`).

The reference appends concurrently with ``atomicAdd`` into fixed 256-face
cell arrays (~1 GB, `SceneHash.cpp:31-34`).  Here insertion is a
sort-based CSR build: emit (bucket, face) pairs for every overlapped cell,
sort by bucket, index with searchsorted — deterministic, compact
(O(pairs) memory), and entirely on-device.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import GridConfig
from ..ops.tribox import tri_box_overlap


class HashGrid(NamedTuple):
    """CSR cell->face table (replaces the fixed ``bmCell[65536]`` arrays)."""

    cell_start: jnp.ndarray  # [num_cells+1] int32 CSR offsets
    entries: jnp.ndarray  # [E] int32 face ids grouped by bucket
    cell_res: jnp.ndarray  # scalar float32
    num_cells: int


# ---------------------------------------------------------------------------
# Fletcher16 hashing, bit-identical to `Hash.cu:17-54`.
# ---------------------------------------------------------------------------

def fletcher16(h: jnp.ndarray) -> jnp.ndarray:
    """``bmHash`` (`Hash.cu:17-32`): Fletcher16 over the 4 little-endian
    bytes of a u32, returning ``(sum2<<8)|sum1`` (< 65536)."""
    h = h.astype(jnp.uint32)
    s1 = jnp.zeros_like(h)
    s2 = jnp.zeros_like(h)
    for k in range(4):
        byte = (h >> (8 * k)) & 0xFF
        s1 = (s1 + byte) % 255
        s2 = (s2 + s1) % 255
    return (s2 << 8) | s1


def hash3_cells(cells: jnp.ndarray, num_cells: int) -> jnp.ndarray:
    """``bmHash3(uint3)`` (`Hash.cu:40-46`): sum of per-axis Fletcher16
    mod the table size.  ``cells`` are int32 coords (two's-complement cast
    to u32, as the CUDA ``make_uint3`` cast does)."""
    u = jax.lax.bitcast_convert_type(cells.astype(jnp.int32), jnp.uint32)
    h = fletcher16(u[..., 0]) + fletcher16(u[..., 1]) + fletcher16(u[..., 2])
    return (h % num_cells).astype(jnp.int32)


def map_cell(p: jnp.ndarray, cell_res) -> jnp.ndarray:
    """``bmMap3`` (`Hash.cu:56-64`): floor(p / CELL_RES) as int32."""
    return jnp.floor(p / cell_res).astype(jnp.int32)


# ---------------------------------------------------------------------------
# Build.
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cfg",))
def build_grid(positions: jnp.ndarray, faces: jnp.ndarray, cfg: GridConfig = GridConfig()) -> HashGrid:
    """Rasterize each face over its AABB's cells, SAT-test each cell
    (`Hash.cu:146-177`), and build the CSR bucket table."""
    res = jnp.float32(cfg.cell_res)
    num_faces = faces.shape[0]
    kmax = cfg.max_cells_per_face

    v0 = positions[faces[:, 0]]
    v1 = positions[faces[:, 1]]
    v2 = positions[faces[:, 2]]
    tmin = jnp.minimum(v0, jnp.minimum(v1, v2))
    tmax = jnp.maximum(v0, jnp.maximum(v1, v2))
    c0 = map_cell(tmin, res)  # [F,3] inclusive
    c1 = map_cell(tmax, res)  # [F,3] inclusive
    dims = c1 - c0 + 1  # [F,3]
    nx, ny = dims[:, 0], dims[:, 1]
    total = dims[:, 0] * dims[:, 1] * dims[:, 2]

    # Enumerate up to kmax candidate cells per face (x-fastest order like
    # the reference's triple loop `Hash.cu:162-177`).
    k = jnp.arange(kmax, dtype=jnp.int32)[None, :]  # [1,K]
    valid = k < total[:, None]
    dx = k % nx[:, None]
    dy = (k // nx[:, None]) % ny[:, None]
    dz = k // (nx * ny)[:, None]
    cell = jnp.stack(
        [c0[:, 0:1] + dx, c0[:, 1:2] + dy, c0[:, 2:3] + dz], axis=-1
    )  # [F,K,3]

    bmin = cell.astype(jnp.float32) * res
    bmax = bmin + res
    bc = (bmin + bmax) * 0.5
    bh = (bmax - bmin) * 0.5
    overlap = tri_box_overlap(
        bc, bh, v0[:, None, :], v1[:, None, :], v2[:, None, :]
    )
    emit = valid & overlap  # [F,K]

    bucket = hash3_cells(cell, cfg.num_cells)  # [F,K]
    bucket = jnp.where(emit, bucket, cfg.num_cells)  # sentinel for dropped
    face_ids = jnp.broadcast_to(
        jnp.arange(num_faces, dtype=jnp.int32)[:, None], (num_faces, kmax)
    )

    flat_bucket = bucket.reshape(-1)
    flat_face = face_ids.reshape(-1)
    order = jnp.argsort(flat_bucket, stable=True)
    sorted_bucket = flat_bucket[order]
    sorted_face = flat_face[order]

    cell_start = jnp.searchsorted(
        sorted_bucket, jnp.arange(cfg.num_cells + 1, dtype=jnp.int32)
    ).astype(jnp.int32)

    return HashGrid(
        cell_start=cell_start,
        entries=sorted_face,
        cell_res=res,
        num_cells=cfg.num_cells,
    )
