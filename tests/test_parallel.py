"""Distributed tests on the virtual 8-device CPU mesh: sharded render
equals single-device render; the distributed training step reduces loss
and keeps parameters replicated-consistent."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracercuda_tpu import AccelKind, RenderConfig
from raytracercuda_tpu.accel.bvh import build_bvh
from raytracercuda_tpu.diff.render_grad import render_rgb
from raytracercuda_tpu.models.camera import camera_ray_grid
from raytracercuda_tpu.models.scene import SceneData
from raytracercuda_tpu.parallel.mesh import (
    make_ray_mesh,
    pad_rays_for_mesh,
)
from raytracercuda_tpu.parallel.shard import make_train_step, render_sharded

@pytest.fixture(autouse=True)
def _eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")

BVH = RenderConfig(accel=AccelKind.BVH)


def scene_16tris(seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1.5, 1.5, (16, 3)).astype(np.float32)
    base[:, 2] = np.abs(base[:, 2]) + 2.0
    offs = rng.normal(scale=0.4, size=(16, 2, 3)).astype(np.float32)
    verts = np.concatenate([base[:, None], base[:, None] + offs], axis=1).reshape(-1, 3)
    faces_np = np.arange(48, dtype=np.int32).reshape(-1, 3)
    faces = np.concatenate([faces_np, np.zeros((16, 1), np.int32)], axis=1)
    normals = rng.normal(size=(48, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    return SceneData(
        positions=jnp.asarray(verts),
        faces=jnp.asarray(faces),
        attrs={1: jnp.asarray(normals)},
        mesh_material=jnp.zeros(1, jnp.int32),
        albedo=jnp.asarray([[0.7, 0.7, 0.7]], jnp.float32),
        texture_id=jnp.asarray([-1], jnp.int32),
        textures=jnp.zeros((1, 1, 1, 3), jnp.float32),
    )


EYE = jnp.zeros(3)
ORIENT = jnp.eye(3)


def test_sharded_render_matches_single_device():
    scene = scene_16tris()
    accel = build_bvh(scene.positions, scene.faces, BVH.bvh)
    rays = camera_ray_grid(32, 32)  # 1024 rays / 8 devices
    mesh = make_ray_mesh(8)
    out = render_sharded(scene, accel, rays, EYE, ORIENT, BVH, mesh)
    ref = render_rgb(scene, accel, rays, EYE, ORIENT, BVH)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-6)


def test_sharded_render_visible_on_all_shards():
    scene = scene_16tris()
    accel = build_bvh(scene.positions, scene.faces, BVH.bvh)
    rays = camera_ray_grid(32, 32)
    mesh = make_ray_mesh(8)
    out = np.asarray(render_sharded(scene, accel, rays, EYE, ORIENT, BVH, mesh))
    # Hits spread across the frame -> every device shard produced output.
    shards = out.reshape(8, -1, 3)
    assert all(np.isfinite(s).all() for s in shards)


def test_pad_rays_for_mesh():
    mesh = make_ray_mesh(8)
    rays = jnp.ones((13, 3))
    padded, n = pad_rays_for_mesh(rays, mesh)
    assert padded.shape == (16, 3) and n == 13


def test_distributed_train_step_reduces_loss():
    scene = scene_16tris()
    accel = build_bvh(scene.positions, scene.faces, BVH.bvh)
    rays = camera_ray_grid(32, 32)
    mesh = make_ray_mesh(8)

    # Target: the render of a slightly shifted scene.
    true_positions = scene.positions + 0.03
    target = render_rgb(
        scene._replace(positions=true_positions),
        build_bvh(true_positions, scene.faces, BVH.bvh),
        rays, EYE, ORIENT, BVH,
    )

    import optax

    step, optimizer = make_train_step(BVH, mesh)
    params = {"positions": scene.positions}
    opt_state = optimizer.init(params)

    losses = []
    for _ in range(5):
        params, opt_state, loss = step(
            params, opt_state, scene, accel, rays, EYE, ORIENT, target
        )
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses
    assert np.isfinite(losses).all()


def test_train_step_grad_matches_single_device():
    """psum-reduced sharded gradient == single-device gradient."""
    scene = scene_16tris()
    accel = build_bvh(scene.positions, scene.faces, BVH.bvh)
    rays = camera_ray_grid(16, 16)
    target = jnp.zeros((256, 3))
    mesh = make_ray_mesh(8)

    import optax

    opt = optax.sgd(1.0)
    step, _ = make_train_step(BVH, mesh, optimizer=opt)
    params = {"positions": scene.positions}
    new_params, _, _ = step(
        params, opt.init(params), scene, accel, rays, EYE, ORIENT, target
    )
    # SGD(lr=1): params_new = params - grad  =>  grad = params - params_new.
    g_sharded = np.asarray(params["positions"] - new_params["positions"])

    def single_loss(p):
        img = render_rgb(
            scene._replace(positions=p), accel, rays, EYE, ORIENT, BVH
        )
        return jnp.sum((img - target) ** 2) / (256 * 3)

    g_single = np.asarray(jax.grad(single_loss)(scene.positions))
    # atol covers f32 reduction-order noise: 8 psum partials vs one sum.
    np.testing.assert_allclose(g_sharded, g_single, rtol=2e-4, atol=3e-7)


def reflective_scene(seed=2, num=24):
    """Two 'meshes' worth of triangles with reflective materials."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1.5, 1.5, (num, 3)).astype(np.float32)
    base[:, 2] = np.abs(base[:, 2]) + 2.0
    offs = rng.normal(scale=0.5, size=(num, 2, 3)).astype(np.float32)
    verts = np.concatenate([base[:, None], base[:, None] + offs],
                           axis=1).reshape(-1, 3)
    faces_np = np.arange(num * 3, dtype=np.int32).reshape(-1, 3)
    mesh_ids = (np.arange(num, dtype=np.int32) % 2)[:, None]
    faces = np.concatenate([faces_np, mesh_ids], axis=1)
    normals = rng.normal(size=(num * 3, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    return SceneData(
        positions=jnp.asarray(verts),
        faces=jnp.asarray(faces),
        attrs={1: jnp.asarray(normals)},
        mesh_material=jnp.asarray([0, 1], jnp.int32),
        albedo=jnp.asarray([[0.7, 0.5, 0.3], [0.2, 0.6, 0.9]], jnp.float32),
        texture_id=jnp.asarray([-1, -1], jnp.int32),
        textures=jnp.zeros((1, 1, 1, 3), jnp.float32),
        reflectivity=jnp.asarray([0.5, 0.25], jnp.float32),
    )


@pytest.mark.slow
def test_sharded_multibounce_matches_single_device():
    """BASELINE config #5's composition: multi-mesh multi-bounce frame,
    rays sharded as pixel bands — identical to the single-device frame."""
    from raytracercuda_tpu.accel.clusters import build_clusters
    from raytracercuda_tpu.parallel.shard import render_bounces_sharded
    from raytracercuda_tpu.trace.bounce import render_bounces
    from raytracercuda_tpu.trace.pipeline import rotate_rays

    config = RenderConfig(accel=AccelKind.CLUSTER)
    scene = reflective_scene()
    accel = build_clusters(scene.positions, scene.faces, config.cluster)
    h, w = 128, 32
    dirs = rotate_rays(camera_ray_grid(w, h), ORIENT)
    mesh = make_ray_mesh(8)
    got = render_bounces_sharded(accel, scene, EYE, dirs, h, w, config, mesh,
                                 num_bounces=2)
    want = render_bounces(accel, scene, EYE, dirs, h, w, config,
                          num_bounces=2)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-6)
    hitish = np.abs(np.asarray(want) - np.asarray(want)[0]).max(axis=1) > 0
    assert hitish.any()


@pytest.mark.slow
def test_sharded_progressive_bit_identical():
    from raytracercuda_tpu.accel.clusters import build_clusters
    from raytracercuda_tpu.parallel.shard import progressive_step_sharded
    from raytracercuda_tpu.trace.progressive import (init_progressive,
                                                     progressive_step)

    config = RenderConfig(accel=AccelKind.CLUSTER)
    scene = scene_16tris()
    accel = build_clusters(scene.positions, scene.faces, config.cluster)
    h = w = 32
    mesh = make_ray_mesh(8)
    s_single = init_progressive(h * w)
    s_shard = init_progressive(h * w)
    for _ in range(2):
        s_single = progressive_step(s_single, scene, accel, EYE, ORIENT,
                                    w, h, config)
        s_shard = progressive_step_sharded(s_shard, scene, accel, EYE,
                                           ORIENT, w, h, config, mesh)
    # Per-band accumulation order is fixed -> bit identical.
    np.testing.assert_array_equal(np.asarray(s_single.accum),
                                  np.asarray(s_shard.accum))
    assert int(s_shard.count) == 2
