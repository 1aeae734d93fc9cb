"""GPU tier (`pytest -m gpu tests/`, run on the card): the trace path's
f32 contractions stay at full precision there (TF32 would change which
clusters survive the cull and which triangle is closest), checked against
float64 and the brute-force oracle.  Skips on any other platform."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracercuda_tpu import AccelKind, RenderConfig
from raytracercuda_tpu.accel.clusters import build_clusters
from raytracercuda_tpu.models.camera import camera_ray_grid, framing_eye
from raytracercuda_tpu.models.procedural import bunny_scene
from raytracercuda_tpu.trace.frame import FrameRenderer
from raytracercuda_tpu.trace.pipeline import rotate_rays

pytestmark = pytest.mark.gpu


def test_rotate_rays_is_full_precision(gpu):
    rng = np.random.default_rng(0)
    rays = rng.standard_normal((4096, 3)).astype(np.float32)
    orient = rng.standard_normal((3, 3)).astype(np.float32)
    got = np.asarray(jax.device_put(rotate_rays(jnp.asarray(rays),
                                                jnp.asarray(orient)), gpu))
    want = rays.astype(np.float64) @ orient.T.astype(np.float64)
    # f32 with exact products: ~1e-7 relative; TF32 would be ~1e-3.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shadows", [True, False])
def test_frame_matches_oracle_on_gpu(gpu, shadows):
    import chip_smoke

    config = RenderConfig(accel=AccelKind.CLUSTER)
    with jax.default_device(gpu):
        data = bunny_scene(config).data()
        accel = build_clusters(data.positions, data.faces, config.cluster)
        eye = framing_eye(data.positions)
        rays = camera_ray_grid(256, 256)
        orient = jnp.eye(3, dtype=jnp.float32)
        r = FrameRenderer(data, accel, config, 256, 256, shadows=shadows)
        hit, shadow = r.hits(eye, orient, rays)
        ohit, oshadow, _ = r.oracle(eye, orient, rays,
                                    chip_smoke.ORACLE_TRACE)
        lit = (np.asarray(chip_smoke.facing_ndotl(r, ohit, orient, rays))
               > chip_smoke.GRAZING_NDOTL)
    chip_smoke.compare_hits(hit, ohit, "gpu frame")
    if shadows:
        cand = lit & (np.asarray(hit.face) == np.asarray(ohit.face))
        agree = np.asarray(shadow)[cand] == np.asarray(oshadow)[cand]
        assert agree.mean() >= chip_smoke.MATCH_SHARE
