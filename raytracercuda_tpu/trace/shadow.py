"""Directional-light occlusion via a light-space 2D grid — exact, no walk.

The reference has no shadow rays at all (its march shades the primary hit
only, `Raytracer/BuildTree.cu:486-496`); shadows are a capability this
framework adds on the way to differentiable rendering.  The first
implementation reused the beam traverser per shadow tile, but shadow rays
for a directional light all share ONE direction — which collapses the
problem from 3D traversal to 2D point-in-triangle lookup:

  Project every triangle onto the plane perpendicular to the light.  A
  surface point is occluded iff some triangle covers its 2D projection
  with a light-depth strictly nearer the light.  Coverage is found with a
  uniform 2D grid over the projected scene (the light-space analog of the
  reference's 3D hash grid, `Raytracer/Hash.cu:132-178`, minus the hash
  and minus the DDA march: each query reads exactly ONE cell).

Build = project, rasterize 2D AABBs into cells, sort, CSR — the same
deterministic sort/scan recipe as `accel/grid.py`.  Query = per-ray CSR
slice + dense Möller–Trumbore along the shared direction, an elementwise
sweep with contiguous `dynamic_slice` triangle reads (no row gathers).

Exactness: a triangle that intersects a shadow ray covers the ray
origin's (u,v) projection, so its 2D AABB overlaps the cell containing
that projection — candidate lists are conservative supersets, and the MT
test is the same one the oracle uses.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.lax import Precision

from ..config import TraceConfig
from ..ops.math import tri_intersect
from ..types import FLT_MAX


def light_basis(light_dir: jnp.ndarray):
    """Orthonormal (u, v, l) with l along the light direction."""
    l = light_dir / jnp.linalg.norm(light_dir)
    helper = jnp.where(
        jnp.abs(l[0]) < 0.9,
        jnp.array([1.0, 0.0, 0.0], jnp.float32),
        jnp.array([0.0, 1.0, 0.0], jnp.float32),
    )
    u = jnp.cross(l, helper)
    u = u / jnp.linalg.norm(u)
    v = jnp.cross(l, u)
    return u, v, l


class ShadowGrid(NamedTuple):
    """CSR light-space cell -> triangle table.

    ``entry_tris`` rows are grouped by cell, so a query reads its cell's
    candidates with contiguous slices; ``K`` extra zero rows at the end
    make unclipped ``dynamic_slice`` reads safe (degenerate triangles
    produce NaN barycentrics and are rejected by the MT miss mask).
    """

    u_axis: jnp.ndarray  # [3]
    v_axis: jnp.ndarray  # [3]
    l_axis: jnp.ndarray  # [3] unit light direction
    uv_min: jnp.ndarray  # [2] grid origin in (u,v)
    inv_cell: jnp.ndarray  # [2] 1 / cell size
    cell_start: jnp.ndarray  # [res*res+2] int32 CSR offsets; the final
    #   bucket (index res*res) holds "overflow" triangles whose 2D AABB
    #   spans more cells than the build bound — tested by EVERY ray, which
    #   keeps results exact instead of silently dropping candidates the
    #   way the reference's bounded cells do (`Hash.cu:82-88`).
    entry_tris: jnp.ndarray  # [E+K, 9] float32 v0|v1|v2 grouped by cell
    res: int  # static grid resolution per axis


@partial(jax.jit, static_argnames=("res", "max_cells_per_face"))
def build_shadow_grid(
    positions: jnp.ndarray,
    faces: jnp.ndarray,
    light_dir: jnp.ndarray,
    res: int = 128,
    max_cells_per_face: int = 64,
) -> ShadowGrid:
    """Project the scene along ``light_dir`` and build the 2D CSR grid.

    Args:
      positions: [V,3] float32 vertices.
      faces: [F,4] int32 face table (3 vertex ids + mesh id).
      light_dir: [3] direction toward the light (need not be normalized).
      res: grid resolution per axis (res*res cells over the projected AABB).
      max_cells_per_face: bound on cells a triangle's 2D AABB may overlap;
        triangles spanning more go to the overflow bucket (tested by every
        ray) so results stay exact — the bounded-rasterization analog of
        `Hash.cu:162-177` without its silent drops.
    """
    u, v, l = light_basis(light_dir)
    num_faces = faces.shape[0]
    kmax = max_cells_per_face

    v0 = positions[faces[:, 0]]
    v1 = positions[faces[:, 1]]
    v2 = positions[faces[:, 2]]

    def proj2(p):  # [.,3] -> [.,2]
        return jnp.stack([jnp.matmul(p, u, precision=Precision.HIGHEST),
                          jnp.matmul(p, v, precision=Precision.HIGHEST)],
                         axis=-1)

    p0, p1, p2 = proj2(v0), proj2(v1), proj2(v2)
    tmin = jnp.minimum(p0, jnp.minimum(p1, p2))  # [F,2]
    tmax = jnp.maximum(p0, jnp.maximum(p1, p2))

    uv_min = jnp.min(tmin, axis=0)
    uv_max = jnp.max(tmax, axis=0)
    extent = jnp.maximum(uv_max - uv_min, 1e-12)
    inv_cell = res / extent  # [2]

    c0 = jnp.clip((tmin - uv_min) * inv_cell, 0, res - 1).astype(jnp.int32)
    c1 = jnp.clip((tmax - uv_min) * inv_cell, 0, res - 1).astype(jnp.int32)
    dims = c1 - c0 + 1  # [F,2]
    nx = dims[:, 0]
    total = dims[:, 0] * dims[:, 1]

    num_cells = res * res
    k = jnp.arange(kmax, dtype=jnp.int32)[None, :]  # [1,K]
    overflow = total > kmax  # [F] -> one entry in the overflow bucket
    valid = (k < total[:, None]) & ~overflow[:, None]
    dx = k % nx[:, None]
    dy = k // nx[:, None]
    cx = c0[:, 0:1] + dx
    cy = c0[:, 1:2] + dy
    cell = cy * res + cx  # [F,K]
    cell = jnp.where(valid, cell, num_cells + 1)  # dropped: sorts last
    cell = cell.at[:, 0].set(
        jnp.where(overflow, num_cells, cell[:, 0])  # overflow bucket
    )

    face_ids = jnp.broadcast_to(
        jnp.arange(num_faces, dtype=jnp.int32)[:, None], (num_faces, kmax)
    )
    flat_cell = cell.reshape(-1)
    flat_face = face_ids.reshape(-1)
    order = jnp.argsort(flat_cell, stable=True)
    sorted_cell = flat_cell[order]
    sorted_face = flat_face[order]

    cell_start = jnp.searchsorted(
        sorted_cell, jnp.arange(num_cells + 2, dtype=jnp.int32)
    ).astype(jnp.int32)

    tris = jnp.concatenate([v0, v1, v2], axis=1)  # [F,9]
    entry_tris = tris[sorted_face]  # [F*K, 9] grouped by cell
    entry_tris = jnp.concatenate(
        [entry_tris, jnp.zeros((kmax, 9), jnp.float32)], axis=0
    )

    return ShadowGrid(
        u_axis=u, v_axis=v, l_axis=l,
        uv_min=uv_min, inv_cell=inv_cell,
        cell_start=cell_start, entry_tris=entry_tris, res=res,
    )


@partial(jax.jit, static_argnames=("chunk", "trace_cfg"))
def occlusion_grid(
    grid: ShadowGrid,
    origins: jnp.ndarray,
    active: jnp.ndarray,
    chunk: int = 32,
    trace_cfg: TraceConfig = TraceConfig(),
) -> jnp.ndarray:
    """Any-hit along the grid's light direction for each origin.

    Args:
      origins: [R,3] shadow-ray origins (surface points, already offset).
      active: [R] bool — rays needing occlusion.
      chunk: candidate triangles tested per round (contiguous CSR slice).
    Returns:
      [R] bool occlusion mask (False wherever ``active`` is False).
    """
    res = grid.res
    l = grid.l_axis
    t_eps = jnp.float32(trace_cfg.t_epsilon)

    # Clamp out-of-grid points to the nearest boundary cell: a point on the
    # grid's edge is covered only by triangles whose (clipped) AABB lands
    # in that boundary cell, and a point strictly outside is covered by no
    # triangle at all — clamping is exact, never lossy.
    p = jnp.stack(
        [jnp.matmul(origins, grid.u_axis, precision=Precision.HIGHEST),
         jnp.matmul(origins, grid.v_axis, precision=Precision.HIGHEST)],
        axis=-1)
    c = jnp.clip(
        jnp.floor((p - grid.uv_min) * grid.inv_cell), 0, res - 1
    ).astype(jnp.int32)
    cid = c[:, 1] * res + c[:, 0]
    start = grid.cell_start[cid]
    count = grid.cell_start[cid + 1] - start

    max_count = jnp.max(jnp.where(active, count, 0))
    n_rounds = (max_count + chunk - 1) // chunk
    num_entries = grid.entry_tris.shape[0] - chunk

    def slice_tris(s):  # contiguous [chunk,9] read per ray
        return jax.lax.dynamic_slice(grid.entry_tris, (s, 0), (chunk, 9))

    k_off = jnp.arange(chunk, dtype=jnp.int32)

    def body(r, occ):
        base = r * chunk
        s = jnp.clip(start + base, 0, num_entries)
        tri = jax.vmap(slice_tris)(s)  # [R, chunk, 9]
        t, _, _ = tri_intersect(
            origins[:, None, :], l[None, None, :],
            tri[..., 0:3], tri[..., 3:6], tri[..., 6:9],
        )  # [R, chunk]
        valid = (base + k_off)[None, :] < count[:, None]
        hit = valid & (t > t_eps) & (t < FLT_MAX)
        return occ | jnp.any(hit, axis=-1)

    occ = jnp.zeros(origins.shape[0], bool)
    occ = jax.lax.fori_loop(0, n_rounds, body, occ)

    # Overflow bucket: triangles too large for per-cell insertion, tested
    # by every ray (one broadcast slice per round, no gathers).
    ov_start = grid.cell_start[grid.res * grid.res]
    ov_count = grid.cell_start[grid.res * grid.res + 1] - ov_start
    ov_rounds = (ov_count + chunk - 1) // chunk

    def ov_body(r, occ):
        s = jnp.clip(ov_start + r * chunk, 0, num_entries)
        tri = slice_tris(s)[None]  # [1, chunk, 9]
        t, _, _ = tri_intersect(
            origins[:, None, :], l[None, None, :],
            tri[..., 0:3], tri[..., 3:6], tri[..., 6:9],
        )
        valid = (r * chunk + k_off)[None, :] < ov_count
        hit = valid & (t > t_eps) & (t < FLT_MAX)
        return occ | jnp.any(hit, axis=-1)

    occ = jax.lax.fori_loop(0, ov_rounds, ov_body, occ)
    return occ & active
