"""Acceleration-structure introspection — the debugging backend.

The reference's CPU build path dumps tree quality after every build:
leaf-depth histogram, faces/leaf, store-top counters
(`/root/reference/Raytracer/BuildTree.cu:307-360`) and hash-cell
occupancy (`Hash.cu:223-228`).  This module is that capability for the
framework's structures: per-structure `*_stats` returning a plain dict
of host-side numbers (suitable for printing or PERF.md), plus
cluster traversal-length statistics on a probe frame — the watch item
SURVEY.md §7 flagged for LBVH object splits (traversal tails) made
measurable.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .bvh import Bvh
from .clusters import ClusterSet
from .grid import HashGrid


def _hist_summary(x: np.ndarray) -> dict:
    if x.size == 0:
        return {"min": 0, "max": 0, "mean": 0.0, "p50": 0, "p95": 0, "p99": 0}
    return {
        "min": int(x.min()), "max": int(x.max()),
        "mean": round(float(x.mean()), 2),
        "p50": int(np.percentile(x, 50)),
        "p95": int(np.percentile(x, 95)),
        "p99": int(np.percentile(x, 99)),
    }


def bvh_stats(bvh: Bvh) -> dict:
    """Leaf-depth histogram + faces/leaf — `BuildTree.cu:307-360` parity.

    Depth is computed host-side by walking hit/skip links from the root
    (iterative DFS over the explicit child links, no recursion)."""
    hit = np.asarray(bvh.hit_link)
    is_leaf = np.asarray(bvh.is_leaf)
    counts = np.asarray(bvh.leaf_count)
    n = hit.shape[0]
    depth = np.full(n, -1, np.int32)
    depth[0] = 0
    # hit_link[v] = left child; right child = left + subtree span.  The
    # builder threads children contiguously enough that a simple BFS over
    # "children of v" = {hit_link[v], sibling via skip of left} works:
    # left's skip within the parent's subtree IS the right child.
    skip = np.asarray(bvh.skip_link)
    stack = [0]
    while stack:
        v = stack.pop()
        if is_leaf[v]:
            continue
        left = hit[v]
        if left < 0 or left >= n:
            continue
        if depth[left] < 0:
            depth[left] = depth[v] + 1
            stack.append(left)
        right = skip[left]
        if 0 <= right < n and depth[right] < 0:
            depth[right] = depth[v] + 1
            stack.append(right)
    leaf_mask = is_leaf & (depth >= 0)
    leaf_depths = depth[leaf_mask]
    faces_per_leaf = counts[leaf_mask]
    return {
        "structure": "bvh",
        "nodes": int(n),
        "leaves": int(leaf_mask.sum()),
        "faces": int(bvh.num_faces),
        "leaf_depth": _hist_summary(leaf_depths),
        "faces_per_leaf": _hist_summary(faces_per_leaf),
    }


def cluster_stats(cs: ClusterSet) -> dict:
    """Cluster fill + AABB quality (the cluster analog of faces/leaf)."""
    face_order = np.asarray(cs.face_order).reshape(cs.num_clusters,
                                                   cs.cluster_size)
    fill = (face_order >= 0).sum(axis=1)
    cmin = np.asarray(cs.cmin)
    cmax = np.asarray(cs.cmax)
    ext = np.maximum(cmax - cmin, 0.0)
    # Surface area drives expected sweep cost (SAH-style quality proxy).
    sa = 2.0 * (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
                + ext[:, 0] * ext[:, 2])
    scene_ext = np.maximum(cmax.max(axis=0) - cmin.min(axis=0), 1e-30)
    scene_sa = 2.0 * (scene_ext[0] * scene_ext[1] + scene_ext[1] * scene_ext[2]
                      + scene_ext[0] * scene_ext[2])
    live = fill > 0
    return {
        "structure": "cluster",
        "clusters": int(cs.num_clusters),
        "cluster_size": int(cs.cluster_size),
        "faces": int((face_order >= 0).sum()),
        "fill": _hist_summary(fill[live]),
        "rel_surface_area_pct": round(float(sa[live].sum() / scene_sa) * 100,
                                      1),
    }


def grid_stats(grid: HashGrid) -> dict:
    """Cell-occupancy histogram — `Hash.cu:223-228` parity (the reference
    prints per-cell face counts and warns on overflowing cells)."""
    start = np.asarray(grid.cell_start)
    occ = np.diff(start)
    live = occ > 0
    return {
        "structure": "grid",
        "cells": int(grid.num_cells),
        "live_cells": int(live.sum()),
        "entries": int(occ.sum()),
        "faces_per_live_cell": _hist_summary(occ[live]),
        "load_factor_pct": round(float(live.mean()) * 100, 2),
    }


def cluster_traversal_stats(cs: ClusterSet, eye, orient, rays, height: int,
                            width: int, tile_px: int = 16) -> dict:
    """Traversal-length distribution on a probe frame: survivors per tile
    after the frustum cull — exactly the work the sweep kernels execute
    per tile (each survivor costs one full G-wide segment sweep).

    The SURVEY §7 watch item ("traversal-length tails") made measurable:
    a heavy p99 here is the cluster path's equivalent of a deep-leaf tail
    in the reference's kd-tree dump."""
    from ..trace.dense import _cull_frustum, tile_frustum_planes, tile_pixels
    from ..trace.pipeline import rotate_rays

    dirs = rotate_rays(rays, jnp.asarray(orient))
    d_tiles = tile_pixels(dirs, height, width, tile_px)
    planes = tile_frustum_planes(d_tiles, tile_px)
    survive = _cull_frustum(planes, jnp.asarray(eye), cs.cmin, cs.cmax)
    counts = np.asarray(jnp.sum(survive, axis=1))
    return {
        "structure": "cluster-traversal",
        "tiles": int(counts.shape[0]),
        "clusters": int(cs.num_clusters),
        "survivors_per_tile": _hist_summary(counts),
        "sweep_segments_total": int(counts.sum()),
    }


def accel_stats(accel) -> dict:
    """Dispatch on structure type (the one-call introspection entry)."""
    if isinstance(accel, Bvh):
        return bvh_stats(accel)
    if isinstance(accel, ClusterSet):
        return cluster_stats(accel)
    if isinstance(accel, HashGrid):
        return grid_stats(accel)
    raise TypeError(f"no stats for {type(accel).__name__}")
