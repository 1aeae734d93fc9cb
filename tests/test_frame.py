"""FrameRenderer product path against the frame composed from the
brute-force oracle (`FrameRenderer.oracle`): same face ids, same shadow
mask, packed channels within one quantization step."""

import numpy as np
import jax.numpy as jnp
import pytest

from raytracercuda_tpu.accel.clusters import build_clusters
from raytracercuda_tpu.config import AccelKind, ClusterConfig, RenderConfig
from raytracercuda_tpu.models.camera import camera_ray_grid
from raytracercuda_tpu.trace.frame import FrameRenderer

from helpers import make_scene

CONFIG = RenderConfig(accel=AccelKind.CLUSTER)


def _check_against_oracle(scene, height, width, shadows, cluster_size=128):
    accel = build_clusters(scene.positions, scene.faces,
                           ClusterConfig(cluster_size=cluster_size))
    eye = jnp.zeros(3, jnp.float32)
    orient = jnp.eye(3)
    rays = camera_ray_grid(width, height)
    renderer = FrameRenderer(scene, accel, CONFIG, height, width,
                             shadows=shadows)
    img = np.asarray(renderer.render(eye, orient, rays))
    hit, shadow = renderer.hits(eye, orient, rays)
    ohit, oshadow, oimg = renderer.oracle(eye, orient, rays)
    assert img.shape == (height * width,)
    np.testing.assert_array_equal(np.asarray(hit.face),
                                  np.asarray(ohit.face))
    if shadows:
        np.testing.assert_array_equal(np.asarray(shadow),
                                      np.asarray(oshadow))
        assert np.asarray(oshadow).any()  # the light is actually blocked
    else:
        assert shadow is None and oshadow is None
    # Packed u8 channels may differ by 1 where the two routes' fp rounding
    # straddles a quantization boundary (face tables vs vertex gathers).
    a = img.view(np.uint8).reshape(-1, 4).astype(np.int32)
    b = np.asarray(oimg).view(np.uint8).reshape(-1, 4).astype(np.int32)
    np.testing.assert_allclose(a, b, atol=1)
    assert (img != img[0]).any()  # scene actually visible


@pytest.mark.parametrize("shadows", [True, False])
@pytest.mark.parametrize("seed", [17, 23, 31, 47])
def test_frame_matches_oracle(seed, shadows):
    _check_against_oracle(make_scene(seed=seed), 64, 64, shadows)


@pytest.mark.parametrize("height,width", [(40, 56), (24, 64)])
def test_frame_edge_pads_partial_tiles(height, width):
    """1080p-shaped frames (height or width not a multiple of the 16 px
    tile, like 1080 = 67*16 + 8) are edge-padded and cropped."""
    assert height % CONFIG.trace.dense_tile_px
    _check_against_oracle(make_scene(seed=5), height, width, shadows=True)


def test_frame_small_clusters():
    """Any cluster size serves the frame (no lane-alignment rule)."""
    _check_against_oracle(make_scene(seed=9), 48, 48, shadows=True,
                          cluster_size=16)
