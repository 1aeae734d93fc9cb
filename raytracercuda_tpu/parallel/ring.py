"""Primitive-sharded ring traversal: scenes larger than one device's memory.

Everywhere else in the framework the scene and its acceleration structure
are REPLICATED per device and rays are sharded (`parallel/shard.py`) — the
right trade at reference scale, where the whole bunny is ~5 MB.  This
module covers the other axis of SURVEY.md §5 ("working-set bounds"): when
the triangle set itself outgrows a device's memory, shard the PRIMITIVES.

Design (ring pass-the-shard, the ray-tracing analog of ring attention):

  * 1-D mesh axis ``"ring"`` of ``n`` devices.  Device ``i`` permanently
    owns ray band ``i`` (pixels stay put — they are the "queries") and
    initially holds cluster shard ``i`` of the Morton-ordered
    `ClusterSet` (the "keys/values", ``C/n`` clusters ≈ ``1/n`` of scene
    HBM per device).
  * ``n`` ring steps: each device sweeps its resident rays against the
    cluster shard it currently holds (the same matrix-form
    Möller–Trumbore sweep as the single-device dense path,
    `trace/dense.py:trace_clusters_rays`), min-combines the closest hit
    into a running best, then forwards the shard to its ring neighbour
    with `jax.lax.ppermute` — a device-to-device transfer that XLA overlaps with
    the next step's compute.
  * After ``n`` steps every ray band has seen every cluster exactly once;
    no device ever materializes more than two shards (the one it sweeps
    and the one arriving).

Tie behavior matches the single-device sweep exactly, by construction:
within a shard the sweep resolves equal-``t`` ties to the lowest cluster
index (same code as the replicated path), and ACROSS shards the combine
carries the global shard index of the current best and breaks exact-``t``
ties toward the LOWER shard.  Shards are contiguous cluster ranges, so
lower shard == lower global cluster index — the replicated sweep's own
tie rule.  The result is therefore bit-identical to the replicated path
regardless of the order shards visit each device (asserted in
`tests/test_ring.py`, including a cross-shard duplicated-triangle tie).

The reference has no analog (single GPU, whole scene resident,
`SceneTree.cpp:61-67` prints the one-device memory budget); SURVEY.md §5
and §7 prescribe exactly this ring for the >HBM regime.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..accel.clusters import ClusterSet
from ..config import TraceConfig
from ..types import FLT_MAX, Hit
from ..trace.dense import trace_clusters_rays

RING_AXIS = "ring"


def make_ring_mesh(num_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh over the devices, axis ``"ring"``."""
    import numpy as np

    if devices is None:
        devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.array(devices), (RING_AXIS,))


def pad_clusters_for_ring(cs: ClusterSet, n: int) -> ClusterSet:
    """Pad the cluster count to a multiple of ``n`` with degenerate
    (all-miss) clusters so the leading axis shards evenly.

    Padding clusters carry a far-away POINT box (cmin == cmax == 3e37):
    the per-axis min/max slab test gives tnear > tfar for any ray not
    aimed exactly at that corner, so the cull rejects padding up front.
    (+/-inf boxes would invert to tnear=-inf/tfar=+inf under the same
    min/max and survive EVERY cull — correct results, but a full wasted
    cluster sweep per ring step.)  Zero triangles (degenerate det, miss
    every ray) and ``-1`` face ids keep the sweep itself all-miss —
    `build_clusters`' tail-padding conventions."""
    C, L = cs.num_clusters, cs.cluster_size
    rem = (-C) % n
    if rem == 0:
        return cs
    far = 3.0e37

    def pad0(x, fill):
        widths = [(0, rem)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, widths, constant_values=fill)

    return ClusterSet(
        cmin=pad0(cs.cmin, far),
        cmax=pad0(cs.cmax, far),
        tris=pad0(cs.tris, 0.0),
        normal=pad0(cs.normal, 0.0),
        face_order=jnp.pad(cs.face_order, (0, rem * L), constant_values=-1),
    )


def _combine(a: Hit, a_src: jnp.ndarray, b: Hit, b_src: jnp.ndarray):
    """Closest-of-two on disjoint triangle subsets.

    Strict ``<`` plus an exact-``t`` tie-break toward the LOWER global
    shard index: shards are contiguous cluster ranges, so this reproduces
    the replicated sweep's lowest-cluster-index tie rule bit-for-bit —
    independent of the order shards arrive on the ring."""
    tie = (b.t == a.t) & (b.face >= 0) & (b_src < a_src)
    closer = (b.t < a.t) | tie
    return Hit(
        t=jnp.where(closer, b.t, a.t),
        u=jnp.where(closer, b.u, a.u),
        v=jnp.where(closer, b.v, a.v),
        face=jnp.where(closer, b.face, a.face),
    ), jnp.where(closer, b_src, a_src)


def _ring_local(cs_shard: ClusterSet, origin: jnp.ndarray,
                dirs: jnp.ndarray, active: jnp.ndarray, *, n: int,
                trace_cfg: TraceConfig, ray_chunk: int,
                cluster_chunk: int) -> Hit:
    """Per-device body: sweep resident rays against each visiting shard."""
    perm = [(j, (j + 1) % n) for j in range(n)]
    # Device i receives from i-1, so at step k it holds shard (i-k) mod n.
    me = jax.lax.axis_index(RING_AXIS)
    best0 = Hit(
        t=jnp.full(origin.shape[:1], FLT_MAX, jnp.float32),
        u=jnp.zeros(origin.shape[:1], jnp.float32),
        v=jnp.zeros(origin.shape[:1], jnp.float32),
        face=jnp.full(origin.shape[:1], -1, jnp.int32),
    )
    src0 = jnp.full(origin.shape[:1], n, jnp.int32)

    def step(k, carry):
        best, best_src, shard = carry
        h = trace_clusters_rays(
            shard, origin, dirs, trace_cfg,
            ray_chunk=min(ray_chunk, origin.shape[0]),
            cluster_chunk=min(cluster_chunk, shard.num_clusters),
            active=active)
        s = jnp.broadcast_to((me - k) % n, best_src.shape).astype(jnp.int32)
        best, best_src = _combine(best, best_src, h, s)
        shard = jax.lax.ppermute(shard, RING_AXIS, perm)
        return best, best_src, shard

    if n == 1:
        best, _, _ = step(0, (best0, src0, cs_shard))
        return best
    best, _, _ = jax.lax.fori_loop(0, n, step, (best0, src0, cs_shard))
    return best


@partial(jax.jit,
         static_argnames=("mesh", "trace_cfg", "ray_chunk", "cluster_chunk"))
def trace_ring_sharded(
    cs: ClusterSet,
    origin: jnp.ndarray,
    dirs: jnp.ndarray,
    mesh: Mesh,
    trace_cfg: TraceConfig = TraceConfig(),
    active: jnp.ndarray | None = None,
    ray_chunk: int = 2048,
    cluster_chunk: int = 2048,
) -> Hit:
    """Closest hit with PRIMITIVES sharded across the mesh.

    ``origin``/``dirs``: ``[R,3]`` arbitrary ray bundle, ``R`` divisible
    by the mesh size (use `parallel.mesh.pad_rays_for_mesh`); the cluster
    count must divide evenly too (`pad_clusters_for_ring`).  Returns the
    same `Hit` as the replicated dense path, bit-identical."""
    n = mesh.devices.size
    if cs.num_clusters % n:
        raise ValueError(
            f"cluster count {cs.num_clusters} not divisible by mesh size "
            f"{n}; call pad_clusters_for_ring first")
    if origin.shape[0] % n:
        raise ValueError(
            f"ray count {origin.shape[0]} not divisible by mesh size {n}; "
            f"call pad_rays_for_mesh first")
    if active is None:
        active = jnp.ones(origin.shape[:1], bool)

    cs_specs = ClusterSet(
        cmin=P(RING_AXIS), cmax=P(RING_AXIS), tris=P(RING_AXIS),
        normal=P(RING_AXIS), face_order=P(RING_AXIS))
    body = partial(_ring_local, n=n, trace_cfg=trace_cfg,
                   ray_chunk=ray_chunk, cluster_chunk=cluster_chunk)
    # check_vma=False: the inner dense sweep seeds its fori_loop carries
    # with fresh (unvarying) constants that become ring-varying on the
    # first combine; there are no replicated-output collectives to check.
    f = jax.shard_map(
        body, mesh=mesh,
        in_specs=(cs_specs, P(RING_AXIS), P(RING_AXIS), P(RING_AXIS)),
        out_specs=Hit(t=P(RING_AXIS), u=P(RING_AXIS), v=P(RING_AXIS),
                      face=P(RING_AXIS)),
        check_vma=False)
    return f(cs, origin, dirs, active)


def any_hit_ring_sharded(
    cs: ClusterSet,
    origin: jnp.ndarray,
    dirs: jnp.ndarray,
    max_t: jnp.ndarray,
    mesh: Mesh,
    trace_cfg: TraceConfig = TraceConfig(),
    **kw,
) -> jnp.ndarray:
    """Occlusion over the primitive-sharded scene: ``[R]`` bool."""
    hit = trace_ring_sharded(cs, origin, dirs, mesh, trace_cfg, **kw)
    return hit.hit_mask & (hit.t < max_t)
