"""Shared swept-beam occlusion culling for directional lights.

A tile's shadow rays all travel along the SAME light direction, so the
tile is a beam: the active origins' AABB swept along the light.  A box
can occlude only if its projection overlaps the beam's on both axes
perpendicular to the light AND it is not entirely behind every origin.

One implementation, two consumers — the dense sweep
(`dense.occlusion_dense`) and the BVH beam walk (`beam.occlusion_beam`).
Divergence between hand-copied versions would produce subtle
cross-backend shadow mismatches.

Reference role: the reference has no shadows; the closest precedent is
its per-node AABB rejection during the march (`BuildTree.cu:405`).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax.lax import Precision

from .shadow import light_basis


class SweptBeam(NamedTuple):
    """Per-tile swept-origin-box projections onto the light frame."""

    u_ax: jnp.ndarray  # [3] unit, perpendicular to the light
    v_ax: jnp.ndarray  # [3] unit, perpendicular to the light
    l: jnp.ndarray     # [3] unit light direction
    ou_lo: jnp.ndarray  # [T] origin-box interval on u_ax
    ou_hi: jnp.ndarray
    ov_lo: jnp.ndarray  # [T] origin-box interval on v_ax
    ov_hi: jnp.ndarray
    ol_lo: jnp.ndarray  # [T] origin-box interval start along l
    tile_any: jnp.ndarray  # [T] bool — any active ray in the tile


def box_interval(bmin: jnp.ndarray, bmax: jnp.ndarray, axis: jnp.ndarray):
    """Projection interval of AABBs ``[...,3]`` onto a unit ``axis``."""
    c = (bmin + bmax) * 0.5
    h = (bmax - bmin) * 0.5
    pc = jnp.matmul(c, axis, precision=Precision.HIGHEST)
    ph = jnp.matmul(h, jnp.abs(axis), precision=Precision.HIGHEST)
    return pc - ph, pc + ph


def swept_tile_beams(o_tiles: jnp.ndarray, a_tiles: jnp.ndarray,
                     light_dir: jnp.ndarray) -> SweptBeam:
    """Build per-tile beams from ``[T,R,3]`` origins + ``[T,R]`` active."""
    big = jnp.float32(3.0e37)
    omin = jnp.min(jnp.where(a_tiles[..., None], o_tiles, big), axis=1)
    omax = jnp.max(jnp.where(a_tiles[..., None], o_tiles, -big), axis=1)
    tile_any = jnp.any(a_tiles, axis=1)
    u_ax, v_ax, l = light_basis(light_dir)
    ou_lo, ou_hi = box_interval(omin, omax, u_ax)
    ov_lo, ov_hi = box_interval(omin, omax, v_ax)
    ol_lo, _ = box_interval(omin, omax, l)
    return SweptBeam(u_ax=u_ax, v_ax=v_ax, l=l, ou_lo=ou_lo, ou_hi=ou_hi,
                     ov_lo=ov_lo, ov_hi=ov_hi, ol_lo=ol_lo,
                     tile_any=tile_any)


def beam_survive_matrix(beam: SweptBeam, cmin: jnp.ndarray,
                        cmax: jnp.ndarray) -> jnp.ndarray:
    """``[T, C]`` bool — which boxes each tile beam must test."""
    cu_lo, cu_hi = box_interval(cmin, cmax, beam.u_ax)
    cv_lo, cv_hi = box_interval(cmin, cmax, beam.v_ax)
    _, cl_hi = box_interval(cmin, cmax, beam.l)
    return (
        beam.tile_any[:, None]
        & (cu_hi[None, :] >= beam.ou_lo[:, None])
        & (cu_lo[None, :] <= beam.ou_hi[:, None])
        & (cv_hi[None, :] >= beam.ov_lo[:, None])
        & (cv_lo[None, :] <= beam.ov_hi[:, None])
        & (cl_hi[None, :] >= beam.ol_lo[:, None])
    )


def beam_cannot_occlude(beam: SweptBeam, bmin: jnp.ndarray,
                        bmax: jnp.ndarray) -> jnp.ndarray:
    """``[T]`` bool — per-tile boxes that cannot occlude their tile
    (the walk-side dual of `beam_survive_matrix`)."""
    nu_lo, nu_hi = box_interval(bmin, bmax, beam.u_ax)
    nv_lo, nv_hi = box_interval(bmin, bmax, beam.v_ax)
    _, nl_hi = box_interval(bmin, bmax, beam.l)
    miss_u = (nu_hi < beam.ou_lo) | (nu_lo > beam.ou_hi)
    miss_v = (nv_hi < beam.ov_lo) | (nv_lo > beam.ov_hi)
    behind = nl_hi < beam.ol_lo
    return miss_u | miss_v | behind | ~beam.tile_any
