"""Primitive-sharded ring traversal (`parallel/ring.py`) on the virtual
8-device CPU mesh: each device holds 1/8 of the clusters and passes its
shard around the ring; the result must be BIT-IDENTICAL to the
replicated single-device dense sweep (same fp ops on disjoint subsets,
strict-< combine preserves the lowest-cluster-index tie rule)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracercuda_tpu.accel.clusters import build_clusters
from raytracercuda_tpu.config import ClusterConfig, TraceConfig
from raytracercuda_tpu.models.camera import camera_ray_grid
from raytracercuda_tpu.parallel.mesh import pad_rays_for_mesh
from raytracercuda_tpu.parallel.ring import (
    any_hit_ring_sharded,
    make_ring_mesh,
    pad_clusters_for_ring,
    trace_ring_sharded,
)
from raytracercuda_tpu.trace.dense import trace_clusters_rays
from raytracercuda_tpu.trace.pipeline import rotate_rays

@pytest.fixture(autouse=True)
def _eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")


def random_tri_soup(n=600, seed=3):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    base[:, 2] += 4.0
    offs = rng.normal(scale=0.3, size=(n, 2, 3)).astype(np.float32)
    verts = np.concatenate(
        [base[:, None], base[:, None] + offs], axis=1
    ).reshape(-1, 3)
    faces = np.concatenate(
        [np.arange(3 * n, dtype=np.int32).reshape(-1, 3),
         np.zeros((n, 1), np.int32)],
        axis=1,
    )
    return jnp.asarray(verts), jnp.asarray(faces)


@pytest.fixture(scope="module")
def setup():
    positions, faces = random_tri_soup()
    cs = build_clusters(positions, faces, ClusterConfig(cluster_size=16))
    mesh = make_ring_mesh(8)
    cs8 = pad_clusters_for_ring(cs, 8)
    rays = camera_ray_grid(32, 32)
    dirs = rotate_rays(rays, jnp.eye(3))
    eye = jnp.asarray([0.1, -0.2, 0.0], jnp.float32)
    origin = jnp.broadcast_to(eye[None, :], dirs.shape)
    return cs, cs8, mesh, origin, dirs


def test_ring_matches_replicated(setup):
    cs, cs8, mesh, origin, dirs = setup
    ref = trace_clusters_rays(cs, origin, dirs, TraceConfig())
    got = trace_ring_sharded(cs8, origin, dirs, mesh, TraceConfig())
    assert bool(jnp.any(ref.face >= 0)), "degenerate fixture: no hits"
    np.testing.assert_array_equal(np.asarray(got.face), np.asarray(ref.face))
    np.testing.assert_array_equal(np.asarray(got.t), np.asarray(ref.t))
    np.testing.assert_array_equal(np.asarray(got.u), np.asarray(ref.u))


def test_ring_memory_is_sharded(setup):
    """Each device's addressable shard of the cluster table is 1/8 of the
    global table — the point of the ring (>HBM scenes)."""
    cs, cs8, mesh, origin, dirs = setup
    from jax.sharding import NamedSharding, PartitionSpec as P

    tris = jax.device_put(cs8.tris, NamedSharding(mesh, P("ring")))
    shard = tris.addressable_shards[0]
    assert shard.data.shape[0] == cs8.num_clusters // 8


def test_ring_active_mask_and_occlusion(setup):
    cs, cs8, mesh, origin, dirs = setup
    active = (jnp.arange(origin.shape[0]) % 2) == 0
    ref = trace_clusters_rays(cs, origin, dirs, TraceConfig(), active=active)
    got = trace_ring_sharded(cs8, origin, dirs, mesh, TraceConfig(),
                             active=active)
    np.testing.assert_array_equal(np.asarray(got.face), np.asarray(ref.face))
    max_t = jnp.full(origin.shape[:1], 1e6, jnp.float32)
    occ = any_hit_ring_sharded(cs8, origin, dirs, max_t, mesh, TraceConfig())
    ref_all = trace_clusters_rays(cs, origin, dirs, TraceConfig())
    np.testing.assert_array_equal(np.asarray(occ),
                                  np.asarray(ref_all.face >= 0))


def test_ring_pads_uneven_rays():
    positions, faces = random_tri_soup(n=64, seed=5)
    cs = pad_clusters_for_ring(
        build_clusters(positions, faces, ClusterConfig(cluster_size=16)), 8)
    mesh = make_ring_mesh(8)
    rays = camera_ray_grid(10, 10)  # 100 rays: not divisible by 8
    dirs = rotate_rays(rays, jnp.eye(3))
    eye = jnp.zeros(3, jnp.float32)
    padded, r = pad_rays_for_mesh(dirs, mesh)
    origin = jnp.broadcast_to(eye[None, :], padded.shape)
    got = trace_ring_sharded(cs, origin, padded, mesh, TraceConfig())
    ref = trace_clusters_rays(cs, origin[:r], dirs, TraceConfig())
    np.testing.assert_array_equal(np.asarray(got.face[:r]),
                                  np.asarray(ref.face))


def test_ring_cross_shard_exact_tie_matches_replicated():
    """The SAME triangle planted in shard 0 and shard 7 produces an exact
    t tie across shards; the ring's combine must resolve it toward the
    lower global shard index — the replicated sweep's lowest-cluster-index
    rule — regardless of the order shards visit each device."""
    L = 8
    tri = np.array([[-1.0, -1.0, 3.0, 2.0, -1.0, 3.0, -1.0, 2.0, 3.0]],
                   np.float32)
    tris = np.zeros((8, L, 9), np.float32)
    tris[0, 0] = tri  # face id 5, cluster 0
    tris[7, 0] = tri  # face id 9, cluster 7 — identical geometry
    v = tri.reshape(3, 3)
    nrm = np.cross(v[1] - v[0], v[2] - v[0]).astype(np.float32)
    normal = np.zeros((8, L, 3), np.float32)
    normal[0, 0] = nrm
    normal[7, 0] = nrm
    cmin = np.full((8, 3), 3.0e37, np.float32)
    cmax = np.full((8, 3), 3.0e37, np.float32)
    cmin[0] = cmax[0] = 0  # real boxes for the two live clusters
    cmin[[0, 7]] = v.min(axis=0)
    cmax[[0, 7]] = v.max(axis=0)
    face_order = np.full(8 * L, -1, np.int32)
    face_order[0] = 5
    face_order[7 * L] = 9
    from raytracercuda_tpu.accel.clusters import ClusterSet

    cs = ClusterSet(cmin=jnp.asarray(cmin), cmax=jnp.asarray(cmax),
                    tris=jnp.asarray(tris), normal=jnp.asarray(normal),
                    face_order=jnp.asarray(face_order))
    rays = camera_ray_grid(8, 8)
    dirs = rotate_rays(rays, jnp.eye(3))
    origin = jnp.zeros_like(dirs)
    ref = trace_clusters_rays(cs, origin, dirs, TraceConfig())
    assert bool(jnp.any(ref.face == 5)) and not bool(jnp.any(ref.face == 9))
    mesh = make_ring_mesh(8)
    got = trace_ring_sharded(cs, origin, dirs, mesh, TraceConfig())
    np.testing.assert_array_equal(np.asarray(got.face), np.asarray(ref.face))
    np.testing.assert_array_equal(np.asarray(got.t), np.asarray(ref.t))


def test_ring_padding_clusters_get_culled():
    """`pad_clusters_for_ring` pads with far-away point boxes that the
    slab cull rejects — not inverted +/-inf boxes that survive every
    cull (r3 advisor finding)."""
    positions, faces = random_tri_soup(n=10, seed=7)
    cs = build_clusters(positions, faces, ClusterConfig(cluster_size=16))
    cs8 = pad_clusters_for_ring(cs, 8)
    pad = cs8.num_clusters - cs.num_clusters
    assert pad > 0
    # The padding boxes are point boxes far outside any scene.
    assert bool(jnp.all(cs8.cmin[cs.num_clusters:] == 3.0e37))
    assert bool(jnp.all(cs8.cmax[cs.num_clusters:] == 3.0e37))
    # And a frame's rays cull them: slab entry test fails for every ray.
    rays = camera_ray_grid(4, 4)
    d = np.asarray(rotate_rays(rays, jnp.eye(3)))
    inv = np.where(d == 0.0, 3.0e37, 1.0 / d)
    t0 = (3.0e37 - 0.0) * inv
    tnear = np.max(np.minimum(t0, t0), axis=-1)
    tfar = np.min(np.maximum(t0, t0), axis=-1)
    assert not np.any(tfar >= np.maximum(tnear, 0.0))
