#!/usr/bin/env python
"""Benchmark: pixels/sec of the 512² primary+shadow frame on one GPU.

The machine-readable successor to the reference's Nsight export
(`aa.xml`: bmMarchKernel 38.41 ms for 250k rays on a GTX 660 Ti ~ 6.5 M
primary rays/s — see BASELINE.md).  The scene is the seeded 69,630-face
bunny stand-in (`models/procedural.bunny_scene`), rendered through the
library product path (`trace/frame.py` FrameRenderer).

Prints the card's name and power limit, then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "scene", "device", "card"},
where vs_baseline is the multiple of the reference's 6.5 M rays/s.  Exits
non-zero without a GPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REFERENCE_RAYS_PER_SEC = 6.5e6  # aa.xml-derived (BASELINE.md)
WIDTH = HEIGHT = 512
ITERS = 50


def measure() -> dict:
    """Time the frame on the default device; the benchmark record."""
    import jax
    import jax.numpy as jnp

    from raytracercuda_tpu import AccelKind, RenderConfig
    from raytracercuda_tpu.accel.clusters import build_clusters
    from raytracercuda_tpu.models.camera import camera_ray_grid, framing_eye
    from raytracercuda_tpu.models.procedural import bunny_scene
    from raytracercuda_tpu.trace.frame import FrameRenderer

    config = RenderConfig(accel=AccelKind.CLUSTER)
    data = bunny_scene(config).data()
    accel = build_clusters(data.positions, data.faces, config.cluster)
    eye = framing_eye(data.positions)
    orient = jnp.eye(3, dtype=jnp.float32)
    rays = camera_ray_grid(WIDTH, HEIGHT)
    renderer = FrameRenderer(data, accel, config, HEIGHT, WIDTH)

    renderer.render(eye, orient, rays).block_until_ready()  # compile+warm
    t0 = time.perf_counter()
    for _ in range(ITERS):
        out = renderer.render(eye, orient, rays)
    out.block_until_ready()
    dt = (time.perf_counter() - t0) / ITERS

    rays_per_sec = WIDTH * HEIGHT / dt
    return {
        "metric": "primary+shadow pixels/sec (512x512 frame)",
        "value": rays_per_sec,
        "unit": "pixels/s",
        "vs_baseline": rays_per_sec / REFERENCE_RAYS_PER_SEC,
        "scene": f"bunny stand-in {data.num_faces} faces",
    }


def main() -> None:
    from raytracercuda_tpu.utils.compile_cache import configure_compile_cache
    from raytracercuda_tpu.utils.device import card_line, require_gpu

    configure_compile_cache()
    device = require_gpu()
    card = card_line()
    print("card:", card, flush=True)
    rec = measure()
    rec.update(device=device, card=card)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
