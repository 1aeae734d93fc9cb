"""Viewer-less render CLI — the TestProgram replacement.

The reference's app (`TestProgram/Program.cpp`) opens an SDL window, flies
a WASD camera and blits frames through CUDA-GL interop.  Without a
display, this CLI renders N frames of an orbit/fly path to
PNG files, with the same per-phase profiler output (Scene/Trace/...)
the reference prints once per second.

    python -m raytracercuda_tpu.apps.render_cli suzanne.obj -o out/ \
        --size 512 --frames 8 --accel bvh --shading lambert
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("model", help="OBJ path or a Content mesh name (suzanne.obj, f16.obj, bunny.obj)")
    p.add_argument("-o", "--out", default="out", help="output directory for PNG frames")
    p.add_argument("--size", type=int, default=512, help="square frame size (reference window: 500)")
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--accel",
                   choices=["cluster", "bvh", "grid", "wavefront", "brute"],
                   default="cluster")
    p.add_argument("--shading", choices=["parity", "lambert", "lambert-shadow"], default="parity")
    p.add_argument("--eye", type=float, nargs=3, default=None,
                   help="camera position (default: auto-framed like Model.cpp stats)")
    p.add_argument("--pan", type=float, default=0.0)
    p.add_argument("--pitch", type=float, default=0.0)
    p.add_argument("--orbit", type=float, default=0.0,
                   help="degrees of yaw orbit per frame (animates the fly camera)")
    p.add_argument("--zoom", type=float, default=1.0)
    p.add_argument("--profile", action="store_true", help="print per-phase timings")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax.numpy as jnp

    from raytracercuda_tpu import (
        AccelKind, Camera, RenderConfig, RenderTarget, Scene,
    )
    from raytracercuda_tpu.models.camera import (framing_eye,
                                                 orient_from_pan_pitch)
    from raytracercuda_tpu.models.loader import load_model
    from raytracercuda_tpu.utils import content
    from raytracercuda_tpu.utils.png import write_packed_png
    from raytracercuda_tpu.utils.profiler import Profiler

    model_path = args.model if os.path.exists(args.model) else content.find(args.model)
    if not model_path:
        print(f"model not found: {args.model}", file=sys.stderr)
        return 1

    config = RenderConfig(accel=AccelKind(args.accel))
    prof = Profiler()

    scene = Scene.create(config)
    with prof.phase("Scene"):
        if not load_model(model_path, scene):
            print(f"failed to load {model_path}", file=sys.stderr)
            return 1
        data = scene.data()
        scene.update_gpu_scene()  # build acceleration structure

    # Auto-frame: back the eye off the AABB like the bench does.
    eye = np.asarray(args.eye if args.eye else framing_eye(data.positions),
                     np.float32)

    cam = Camera.create()
    err = cam.set_initial_rays(args.size, args.size, -1, 1, -1, 1, args.zoom)
    assert err == 0, f"camera error {err}"
    rt = RenderTarget.create(args.size, args.size)
    assert rt.lock() == 0

    os.makedirs(args.out, exist_ok=True)
    shading = args.shading

    # Product fast path: cluster accel + lambert shading renders through
    # FrameRenderer — the same frame bench.py measures.
    renderer = None
    if args.accel == "cluster" and shading != "parity":
        from raytracercuda_tpu.trace.frame import FrameRenderer

        renderer = FrameRenderer(
            data, scene.accel, config, args.size, args.size,
            shadows=(shading == "lambert-shadow"))

    # try/finally: the unlock must run even when a frame raises (trace
    # error, PNG write failure, Ctrl-C mid-orbit) — otherwise an
    # in-process caller (tests, notebooks) is left with a locked
    # process-global RenderTarget.  The reference unlocks before
    # presenting each frame (`Program.cpp:302-311`).
    try:
        for frame in range(args.frames):
            pan = args.pan + np.deg2rad(args.orbit) * frame
            orient = orient_from_pan_pitch(pan, args.pitch)
            if shading == "parity":
                with prof.phase("Trace", sync=None):
                    err = cam.trace_scene(eye, orient, scene, rt)
                    assert err == 0, f"trace error {err}"
                    buf = np.asarray(rt.buffer)
            elif renderer is not None:
                with prof.phase("Trace"):
                    buf = np.asarray(renderer.render(
                        jnp.asarray(eye), jnp.asarray(orient),
                        cam.initial_rays))
            else:
                from raytracercuda_tpu.diff.render_grad import render_rgb
                from raytracercuda_tpu.trace.shade import pack_shaded

                with prof.phase("Trace"):
                    rgb = render_rgb(
                        data, scene.accel, cam.initial_rays,
                        jnp.asarray(eye), jnp.asarray(orient), config,
                        with_shadows=(shading == "lambert-shadow"),
                    )
                    buf = np.asarray(pack_shaded(rgb))
            with prof.phase("Present"):
                path = os.path.join(args.out, f"frame_{frame:04d}.png")
                write_packed_png(path, buf, args.size, args.size)
            if args.profile:
                prof.report(force=True)
            print(f"wrote {path}")
    finally:
        rt.unlock()
    return 0


if __name__ == "__main__":
    sys.exit(main())
