#!/usr/bin/env python
"""Time every BASELINE.json config at its full scale on one GPU.

Configs (BASELINE.json "configs"), each on a seeded stand-in scene with the
reference mesh's face count (`models/procedural.py`):
  1. RTClear + Gradient full-frame fill, 256x256, no geometry
  2. Quad + suzanne stand-in (15,488 faces), 256x256 primary, brute force
  3. Bunny stand-in 512x512 cluster build + traversal + Lambert + shadows
     (== bench.py's headline number)
  4. Textured f16 stand-in + armadillo stand-in (350,000 faces),
     1024x1024, progressive accumulation, texture + vertex gradients
  5. Bunny + armadillo + tyra stand-ins (515,576 faces), 1080p, two
     mirror bounces

    python scripts/bench_configs.py [N ...]   # all configs, or only N...

Prints the card's name and power limit, then one JSON line per config.
Any failure raises and exits non-zero; so does a run without a GPU.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from raytracercuda_tpu import AccelKind, RenderConfig  # noqa: E402
from raytracercuda_tpu.accel.clusters import build_clusters  # noqa: E402
from raytracercuda_tpu.models import procedural  # noqa: E402
from raytracercuda_tpu.models.camera import (  # noqa: E402
    camera_ray_grid, framing_eye)


def timed(fn, *a, iters=5, **kw):
    out = fn(*a, **kw)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*a, **kw)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1e3, out


def record(name, **kv):
    print(json.dumps({"config": name, **kv}), flush=True)


# --- 1: full-frame fill -------------------------------------------------------
def config1():
    from raytracercuda_tpu.ops.clear import clear_buffer
    from raytracercuda_tpu.ops.gradient import color_gradient

    ms_c, _ = timed(lambda: clear_buffer(256 * 256, 0xFF00FF00), iters=20)
    ms_g, _ = timed(lambda: color_gradient(256, 256), iters=20)
    record("1 clear+gradient 256x256", clear_ms=ms_c, gradient_ms=ms_g)


# --- 2: quad + suzanne stand-in, brute force ----------------------------------
def config2():
    import raytracercuda_tpu as rt

    scene = rt.Scene.create(rt.RenderConfig(accel=rt.AccelKind.BRUTE))
    scene.add_mesh(procedural.bumpy_sphere_mesh(15488, radius=0.8,
                                                center=(0.0, 0.0, 0.0),
                                                seed=5))
    scene.add_mesh(procedural.quad_mesh(z=2.5))
    cam = rt.Camera.create()
    cam.set_initial_rays(256, 256, -1, 1, -1, 1, 1)
    rtg = rt.RenderTarget.create(256, 256)
    rtg.lock()
    eye = np.array([0, 0, -2.1], np.float32)
    orient = rt.orient_from_pan_pitch(0, 0)

    def frame():
        err = cam.trace_scene(eye, orient, scene, rtg)
        if err != 0:
            raise RuntimeError(f"trace_scene returned {err}")
        return rtg.buffer

    ms, buf = timed(frame, iters=3)
    frac = float(np.asarray((buf != np.uint32(255 << 8))).mean())
    record("2 quad+suzanne stand-in 256x256 brute", frame_ms=ms,
           rays_per_s=256 * 256 / ms * 1e3, hit_frac=frac)


# --- 3: bunny stand-in 512x512 (the headline bench) ---------------------------
def config3():
    from bench import measure

    record("3 bunny stand-in 512x512 primary+shadow", **measure())


# --- 4: textured f16 + armadillo stand-ins, 1024^2, progressive + grads -------
def config4():
    from raytracercuda_tpu.diff.render_grad import l2_image_loss
    from raytracercuda_tpu.trace.progressive import (
        init_progressive, progressive_step)

    config = RenderConfig(accel=AccelKind.CLUSTER)
    data = procedural.textured_scene(config).data()
    accel = build_clusters(data.positions, data.faces, config.cluster)
    eye = framing_eye(data.positions, dist=1.0)
    orient = jnp.eye(3, dtype=jnp.float32)

    W = H = 1024
    state = init_progressive(W * H)
    step = lambda s: progressive_step(s, data, accel, eye, orient, W, H,
                                      config, with_shadows=True)
    ms, state = timed(step, state, iters=3)

    rays = camera_ray_grid(W, H)
    target = jnp.zeros((W * H, 3), jnp.float32)

    def loss_fn(positions, textures):
        s = data._replace(positions=positions, textures=textures)
        return l2_image_loss(s, accel, rays, eye, orient, target, config,
                             frame_hw=(H, W), with_shadows=True)

    gfn = jax.jit(jax.grad(loss_fn, argnums=(0, 1)))
    ms_g, (gp, gt) = timed(gfn, data.positions, data.textures, iters=2)
    gp, gt = np.asarray(gp), np.asarray(gt)
    record("4 f16+armadillo stand-ins 1024x1024 progressive+grads",
           progressive_step_ms=ms, rays_per_s=W * H / ms * 1e3,
           grad_step_ms=ms_g,
           grad_pos_finite=bool(np.isfinite(gp).all()),
           grad_pos_nonzero=bool((gp != 0).any()),
           grad_tex_finite=bool(np.isfinite(gt).all()),
           grad_tex_nonzero=bool((gt != 0).any()),
           faces=int(data.faces.shape[0]))


# --- 5: multi-mesh stand-ins, 1080p, two bounces ------------------------------
def config5():
    from raytracercuda_tpu.trace.bounce import render_bounces
    from raytracercuda_tpu.trace.pipeline import rotate_rays

    config = RenderConfig(accel=AccelKind.CLUSTER)
    data = procedural.multi_mesh_scene(config).data()
    accel = build_clusters(data.positions, data.faces, config.cluster)
    eye = framing_eye(data.positions, dist=1.2)
    W, H = 1920, 1080
    dirs = rotate_rays(camera_ray_grid(W, H), jnp.eye(3, dtype=jnp.float32))

    fn = lambda d: render_bounces(accel, data, eye, d, H, W, config,
                                  num_bounces=2)
    ms, img = timed(fn, dirs, iters=3)
    img0 = render_bounces(accel, data, eye, dirs, H, W, config,
                          num_bounces=0)
    changed = float(jnp.mean(jnp.any(jnp.abs(img - img0) > 1e-6, axis=-1)))
    record("5 multi-mesh stand-ins 1080p 2-bounce", frame_ms=ms,
           rays_per_s=W * H / ms * 1e3, bounce_changed_px_frac=changed,
           faces=int(data.faces.shape[0]))


def main():
    from raytracercuda_tpu.utils.compile_cache import configure_compile_cache
    from raytracercuda_tpu.utils.device import card_line, require_gpu

    configure_compile_cache()
    device = require_gpu()
    print("card:", card_line(), "| device:", json.dumps(device), flush=True)
    only = set(sys.argv[1:])
    for i, fn in enumerate((config1, config2, config3, config4, config5), 1):
        if not only or str(i) in only:
            fn()


if __name__ == "__main__":
    main()
