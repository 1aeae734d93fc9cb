"""The differentiable route's row gather and its backward.

`_rows_recompute_shade` gathers one face row per ray
(``rows[max(ids, 0)]``); its backward is XLA's scatter-add of the ray
cotangents into the face rows.  Checked against an explicit
``np.add.at`` reference — misses (``id < 0``) gather row 0 but are masked
downstream, so they must contribute nothing — and the whole fused route's
gradient against the generic recompute + shade route."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracercuda_tpu import AccelKind, RenderConfig
from raytracercuda_tpu.diff.render_grad import (_rows_recompute_shade,
                                                hit_nondiff, recompute_hit)
from raytracercuda_tpu.models.camera import camera_ray_grid
from raytracercuda_tpu.trace.pipeline import rotate_rays
from raytracercuda_tpu.trace.shade import shade_lambert_rgb

from helpers import make_scene


def _masked_gather(rows, ids):
    r = rows[jnp.maximum(ids, 0)]
    return jnp.where((ids >= 0)[:, None], r, 0.0)


@pytest.mark.parametrize("num_rays,num_faces,width,miss", [
    (512, 64, 22, 0.0),
    (1000, 300, 28, 0.3),
    (4096, 17, 12, 0.9),
])
def test_row_gather_backward_is_scatter_add(num_rays, num_faces, width, miss):
    rng = np.random.default_rng(num_rays)
    rows = rng.standard_normal((num_faces, width)).astype(np.float32)
    ids = rng.integers(0, num_faces, num_rays).astype(np.int32)
    ids[rng.random(num_rays) < miss] = -1
    g = rng.standard_normal((num_rays, width)).astype(np.float32)

    out, vjp = jax.vjp(lambda r: _masked_gather(r, jnp.asarray(ids)),
                       jnp.asarray(rows))
    (got,) = jax.jit(vjp)(jnp.asarray(g))

    hit = ids >= 0
    np.testing.assert_array_equal(np.asarray(out)[hit], rows[ids[hit]])
    assert not np.asarray(out)[~hit].any()
    want = np.zeros_like(rows)
    np.add.at(want, ids[hit], g[hit])
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("textured", [False, True])
def test_fused_route_gradient_matches_generic(textured):
    """Positions gradient through the fused row gather equals the generic
    route's, on a frame with misses (background pixels)."""
    scene = make_scene(num_faces=200, seed=29)
    if textured:
        rng = np.random.default_rng(4)
        nv = scene.positions.shape[0]
        scene = scene._replace(
            attrs={**scene.attrs,
                   2: jnp.asarray(rng.random((nv, 2), np.float32))},
            texture_id=jnp.asarray([0], jnp.int32),
            textures=jnp.asarray(rng.random((1, 8, 8, 3), np.float32)))
    side = 24
    rays = camera_ray_grid(side, side)
    eye, orient = jnp.zeros(3), jnp.eye(3)
    dirs = rotate_rays(rays, orient)
    origin = jnp.broadcast_to(eye[None, :], dirs.shape)
    ids = hit_nondiff(scene, None, origin, dirs,
                      RenderConfig(accel=AccelKind.BRUTE)).face
    n_hit = int((ids >= 0).sum())
    assert 0 < n_hit < side * side  # hits and misses

    def fused(pos):
        img, _, _ = _rows_recompute_shade(
            scene._replace(positions=pos), ids, eye, dirs,
            (0.4, 0.8, -0.45), rays=rays, orient=orient)
        return jnp.sum(img ** 2)

    def generic(pos):
        sc = scene._replace(positions=pos)
        h = recompute_hit(sc, ids, origin, dirs)
        return jnp.sum(shade_lambert_rgb(sc, h, origin, dirs) ** 2)

    gf = np.asarray(jax.jit(jax.grad(fused))(scene.positions))
    gg = np.asarray(jax.jit(jax.grad(generic))(scene.positions))
    assert np.abs(gf).max() > 0
    np.testing.assert_allclose(gf, gg, rtol=1e-3,
                               atol=1e-5 * np.abs(gg).max())
