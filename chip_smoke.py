#!/usr/bin/env python
"""Bring-up smoke run: the renderer's main paths on a GPU at full size,
each checked against the brute-force oracle or the CPU.

    python chip_smoke.py               # one card (the default)
    python chip_smoke.py --four-cards  # the multi-device paths, four cards

One card, in one process, after a child process has run the GPU test tier
(``pytest -m gpu tests/``) so that only one JAX process holds the card at
a time.  Phases, one result line each:

  device  — JAX's devices and the card's name and power limit;
  gpu-tests — the GPU test tier;
  frame   — 512² bunny stand-in through `FrameRenderer` (cluster accel,
            shadows), timed, against `FrameRenderer.oracle`;
  api     — Scene/Camera/RenderTarget, the render CLI, and the default
            (BVH) config against `trace_brute`;
  grad    — 1024² textured scene: progressive step, loss+gradient and
            `make_train_step`; a 256² gradient against the CPU's;
  bounce  — 1080p two-bounce frame of ~515k faces against the oracle on
            a seeded pixel sample;
  fill    — clear, color gradient and blob against scalar references.

Times are host-clock ``block_until_ready`` after a warm-up call, whose
time (compile plus one run) is printed apart.  Peak memory is the
device's ``peak_bytes_in_use`` since the process started.  Any failure
raises and exits non-zero; without a GPU the script exits non-zero
before printing a result.  The last line of stdout is
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from raytracercuda_tpu import (  # noqa: E402
    AccelKind, Camera, RenderConfig, RenderTarget, TraceConfig)
from raytracercuda_tpu.accel.clusters import build_clusters  # noqa: E402
from raytracercuda_tpu.models import procedural  # noqa: E402
from raytracercuda_tpu.models.camera import (  # noqa: E402
    camera_ray_grid, framing_eye)
from raytracercuda_tpu.trace.bruteforce import trace_brute  # noqa: E402
from raytracercuda_tpu.trace.frame import FrameRenderer  # noqa: E402
from raytracercuda_tpu.trace.pipeline import (  # noqa: E402
    rotate_rays, trace_hit)
from raytracercuda_tpu.utils.compile_cache import (  # noqa: E402
    configure_compile_cache)
from raytracercuda_tpu.utils.device import (  # noqa: E402
    card_line, device_record, peak_bytes, require_gpu)

#: Face ids (and shadow masks) of the fast path must equal the oracle's on
#: at least this share of pixels; the rest are ties on shared edges.
MATCH_SHARE = 0.9999
#: Where face ids differ, both hits' t agree to this relative tolerance.
TIE_RTOL = 1e-5
#: Packed 8-bit channels may differ by this much (fp rounding of shading).
CHANNEL_ATOL = 1
#: Shadow masks are compared where the light stands more than ~3 degrees
#: above the shading surface.  Below that the shadow ray starts within
#: eps * N.L (~1e-5 of the scene extent) of its own surface and skims it,
#: so the fast path and the oracle may round either way.
GRAZING_NDOTL = 0.05
#: Brute-force tiling for oracle runs (results do not depend on it).
ORACLE_TRACE = TraceConfig(tile_rays_brute=8192)


class SmokeFailure(AssertionError):
    """A phase's result is outside its tolerance."""


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Every size the phases run at (the defaults are the full ones)."""

    frame_px: int = 512
    frame_faces: int = procedural.BUNNY_FACES
    frame_iters: int = 20
    api_px: int = 512
    cli_frames: int = 4
    bvh_px: int = 256
    grad_px: int = 1024
    f16_faces: int = procedural.F16_FACES
    armadillo_faces: int = procedural.ARMADILLO_FACES
    train_steps: int = 3
    ref_px: int = 256
    ref_faces: int = 20000
    bounce_hw: tuple = (1080, 1920)
    bounce_scale: int = 1
    bounce_iters: int = 3
    bounce_samples: int = 16384
    fill_px: int = 256


def emit(phase: str, **result) -> dict:
    print(f"[{phase}] " + json.dumps(result, default=float), flush=True)
    return result


def timed(fn, iters: int):
    """(first-call seconds, steady ms per call, last output)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    return first_s, (time.perf_counter() - t0) / iters * 1e3, out


def channels(packed) -> np.ndarray:
    """Packed u32 framebuffer -> ``[N, 4]`` int 8-bit channels."""
    return np.asarray(packed, np.uint32).view(np.uint8).reshape(-1, 4) \
        .astype(np.int32)


def compare_hits(fast, oracle, what: str) -> dict:
    """Frame tolerance on face ids: equal on `MATCH_SHARE` of the rays;
    where they differ, both hit and their t agree within `TIE_RTOL`."""
    ff, fo = np.asarray(fast.face), np.asarray(oracle.face)
    tf, to = np.asarray(fast.t), np.asarray(oracle.t)
    diff = ff != fo
    share = 1.0 - diff.mean()
    both = (ff[diff] >= 0) & (fo[diff] >= 0)
    rel = np.abs(tf[diff] - to[diff]) / np.maximum(np.abs(to[diff]), 1e-30)
    worst = float(rel.max()) if diff.any() else 0.0
    require(share >= MATCH_SHARE,
            f"{what}: face ids match on {share:.6f} < {MATCH_SHARE}")
    require(both.all() and worst <= TIE_RTOL,
            f"{what}: {int(diff.sum())} differing ids, hit on both "
            f"{int(both.sum())}, worst relative dt {worst:.3g}")
    return {"face_match": share, "face_mismatch": int(diff.sum()),
            "tie_max_rel_dt": worst,
            "hit_share": float((fo >= 0).mean())}


@jax.jit
def _facing_ndotl(scene, hit, dirs, light):
    from raytracercuda_tpu.models.mesh import VERTEX_DATA_NORMAL
    from raytracercuda_tpu.ops.math import normalize
    from raytracercuda_tpu.trace.shade import interpolate_slot

    n = normalize(interpolate_slot(scene, hit, VERTEX_DATA_NORMAL),
                  eps=1e-30)
    n = jnp.where((jnp.sum(n * dirs, axis=-1) > 0.0)[:, None], -n, n)
    return jnp.sum(n * light, axis=-1)


def facing_ndotl(renderer, hit, orient, rays):
    """Per-pixel N.L of the eye-facing shading normal — `FrameRenderer`'s
    Lambert term before the shadow (0 or less: a shadow changes nothing)."""
    dirs = rotate_rays(rays, orient)
    return _facing_ndotl(renderer.scene, hit, dirs, renderer.light)


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------


def phase_frame(dev, sizes: Sizes) -> dict:
    """The `bench.py` frame: bunny stand-in, cluster accel, shadows."""
    t_phase = time.perf_counter()
    config = RenderConfig(accel=AccelKind.CLUSTER)
    px = sizes.frame_px
    with jax.default_device(dev):
        data = procedural.bunny_scene(config, sizes.frame_faces).data()
        accel = build_clusters(data.positions, data.faces, config.cluster)
        eye = framing_eye(data.positions)
        orient = jnp.eye(3, dtype=jnp.float32)
        rays = camera_ray_grid(px, px)
        renderer = FrameRenderer(data, accel, config, px, px)
        first_s, ms, img = timed(lambda: renderer.render(eye, orient, rays),
                                 sizes.frame_iters)
        hit, shadow = renderer.hits(eye, orient, rays)
        ohit, oshadow, oimg = renderer.oracle(eye, orient, rays, ORACLE_TRACE)
        ndotl = np.asarray(facing_ndotl(renderer, ohit, orient, rays))
    res = compare_hits(hit, ohit, "frame")
    same = np.asarray(hit.face) == np.asarray(ohit.face)
    sh, osh = np.asarray(shadow), np.asarray(oshadow)
    lit = np.asarray(ohit.face >= 0) & (ndotl > GRAZING_NDOTL)
    cand = same & lit
    flips = (sh != osh) & same
    sh_share = 1.0 - float(flips[cand].mean()) if cand.any() else 1.0
    require(sh_share >= MATCH_SHARE,
            f"frame: shadow mask matches on {sh_share:.6f} of lit pixels "
            f"({int(flips[cand].sum())} of {int(cand.sum())}; N.L there "
            f"{np.round(ndotl[flips & cand], 4).tolist()})")
    dch = np.abs(channels(img) - channels(oimg))[same & ~flips]
    require(dch.max(initial=0) <= CHANNEL_ATOL,
            f"frame: packed channels differ by {dch.max()} where the face "
            f"ids and shadows agree")
    return emit("frame", scene=f"bunny stand-in {data.num_faces} faces",
                px=f"{px}x{px}", accel="cluster", shadows=True,
                first_call_s=first_s, ms_per_frame=ms,
                rays_per_s=px * px / ms * 1e3, **res,
                lit_pixels=int(cand.sum()), shadow_match_lit=sh_share,
                shadow_flips_grazing=int((flips & ~lit).sum()),
                shadow_flip_max_ndotl=float(ndotl[flips].max(initial=0.0)),
                max_channel_diff=int(dch.max(initial=0)),
                peak_bytes=peak_bytes(dev),
                wall_s=time.perf_counter() - t_phase)


def phase_api(dev, sizes: Sizes, out_dir: str) -> dict:
    """The README flow, the render CLI, and the default config."""
    import raytracercuda_tpu as rt
    from raytracercuda_tpu.apps import render_cli
    from raytracercuda_tpu.models.loader import write_obj

    t_phase = time.perf_counter()
    px = sizes.api_px
    with jax.default_device(dev):
        scene = procedural.bunny_scene(RenderConfig(accel=AccelKind.CLUSTER),
                                       sizes.frame_faces)
        eye = np.asarray(framing_eye(scene.data().positions))
        orient = rt.orient_from_pan_pitch(0.0, 0.0)
        cam = Camera.create()
        require(cam.set_initial_rays(px, px, -1, 1, -1, 1, 1) == 0,
                "api: set_initial_rays failed")
        target = RenderTarget.create(px, px)
        target.lock()
        try:
            require(cam.clear(target, 0x00FF00FF) == 0, "api: clear failed")
            t0 = time.perf_counter()
            err = cam.trace_scene(eye, orient, scene, target)
            buf = np.asarray(target.buffer)
            trace_s = time.perf_counter() - t0
        finally:
            target.unlock()
        require(err == 0, f"api: trace_scene returned {err}")
        hit_share = float((buf != np.uint32(255 << 8)).mean())
        require(buf.shape == (px * px,) and 0.0 < hit_share < 1.0,
                f"api: framebuffer {buf.shape}, hit share {hit_share}")

        # The render CLI on an OBJ written from the same seeded mesh.
        os.makedirs(out_dir, exist_ok=True)
        obj = os.path.join(out_dir, "bunny_standin.obj")
        write_obj(obj, [("", scene.meshes[0])])
        t0 = time.perf_counter()
        rc = render_cli.main([obj, "-o", out_dir, "--size", str(px),
                              "--accel", "cluster", "--shading",
                              "lambert-shadow", "--frames",
                              str(sizes.cli_frames), "--orbit", "15"])
        cli_s = time.perf_counter() - t0
        pngs = [os.path.join(out_dir, f"frame_{i:04d}.png")
                for i in range(sizes.cli_frames)]
        require(rc == 0 and all(os.path.getsize(p) > 0 for p in pngs),
                f"api: render CLI rc {rc}")

        # The default RenderConfig (BVH beam walk) against the oracle.
        config = RenderConfig()
        bscene = procedural.bunny_scene(config, sizes.frame_faces)
        data = bscene.data()
        bpx = sizes.bvh_px
        dirs = rotate_rays(camera_ray_grid(bpx, bpx), jnp.asarray(orient))
        e = jnp.asarray(eye)
        origin = jnp.broadcast_to(e[None, :], dirs.shape)
        hit = trace_hit(data, bscene.accel, origin, dirs, config,
                        frame_hw=(bpx, bpx), common_origin=e)
        ohit = jax.jit(trace_brute, static_argnums=4)(
            data.positions, data.faces, e, dirs, ORACLE_TRACE)
    res = compare_hits(hit, ohit, "api default config")
    return emit("api", scene=f"bunny stand-in {data.num_faces} faces",
                trace_scene=f"{px}x{px} cluster err=0",
                trace_scene_s=trace_s, trace_scene_hit_share=hit_share,
                cli=f"{sizes.cli_frames} frames lambert-shadow rc=0",
                cli_s=cli_s, default_config=f"bvh {bpx}x{bpx}", **res,
                peak_bytes=peak_bytes(dev),
                wall_s=time.perf_counter() - t_phase)


def _textured_loss(config, px, with_shadows=True):
    from raytracercuda_tpu.diff.render_grad import l2_image_loss

    def loss(positions, textures, data, accel, rays, eye, orient, target):
        s = data._replace(positions=positions, textures=textures)
        return l2_image_loss(s, accel, rays, eye, orient, target, config,
                             frame_hw=(px, px), with_shadows=with_shadows)

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))


def phase_grad(dev, sizes: Sizes, cpu=None) -> dict:
    """BASELINE config 4: progressive step, gradient, train step; and the
    gradient against the same function on ``cpu``."""
    import optax

    from raytracercuda_tpu.parallel.mesh import make_ray_mesh
    from raytracercuda_tpu.parallel.shard import make_train_step
    from raytracercuda_tpu.trace.progressive import (init_progressive,
                                                     progressive_step)

    t_phase = time.perf_counter()
    config = RenderConfig(accel=AccelKind.CLUSTER)
    px = sizes.grad_px
    with jax.default_device(dev):
        data = procedural.textured_scene(config, sizes.f16_faces,
                                         sizes.armadillo_faces).data()
        accel = build_clusters(data.positions, data.faces, config.cluster)
        eye = framing_eye(data.positions, dist=1.0)
        orient = jnp.eye(3, dtype=jnp.float32)
        rays = camera_ray_grid(px, px)
        target = jnp.zeros((px * px, 3), jnp.float32)

        state0 = init_progressive(px * px)
        prog_first_s, prog_ms, state = timed(
            lambda: progressive_step(state0, data, accel, eye, orient, px,
                                     px, config, with_shadows=True), 2)
        img = np.asarray(state.image)
        require(np.isfinite(img).all(), "grad: non-finite progressive image")

        vg = _textured_loss(config, px)
        grad_first_s, grad_ms, (loss, (gp, gt)) = timed(
            lambda: vg(data.positions, data.textures, data, accel, rays, eye,
                       orient, target), 2)
        gp, gt = np.asarray(gp), np.asarray(gt)
        require(np.isfinite(float(loss)) and np.isfinite(gp).all()
                and np.isfinite(gt).all(), "grad: non-finite loss/gradient")
        require((gp != 0).any() and (gt != 0).any(),
                "grad: all-zero position or texture gradient")

        mesh = make_ray_mesh(devices=[dev])
        step, opt = make_train_step(config, mesh, optimizer=optax.adam(1e-3),
                                    with_shadows=True, frame_hw=(px, px))
        params = {"positions": data.positions, "textures": data.textures}
        opt_state = opt.init(params)
        # Two warm-up steps: the first step's outputs carry the mesh's
        # sharding, so the second call compiles once more.
        warm_s, losses = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            params, opt_state, loss_k = jax.block_until_ready(step(
                params, opt_state, data, accel, rays, eye, orient, target))
            warm_s.append(time.perf_counter() - t0)
            losses.append(float(loss_k))
        t0 = time.perf_counter()
        for _ in range(sizes.train_steps):
            params, opt_state, loss_k = step(params, opt_state, data, accel,
                                             rays, eye, orient, target)
            losses.append(float(loss_k))
        jax.block_until_ready(params)
        step_ms = (time.perf_counter() - t0) / sizes.train_steps * 1e3
        require(all(np.isfinite(losses)) and all(
            np.isfinite(np.asarray(v)).all() for v in params.values()),
            "grad: non-finite train step")
        moved = float(np.abs(np.asarray(params["positions"])
                             - np.asarray(data.positions)).max())
        require(moved > 0, "grad: train steps left the positions unchanged")

    ref = _grad_vs_cpu(dev, cpu or jax.devices("cpu")[0], sizes)
    return emit("grad", scene=f"textured f16 stand-in {sizes.f16_faces} + "
                f"armadillo stand-in {sizes.armadillo_faces} faces",
                px=f"{px}x{px}", shadows=True,
                progressive_first_s=prog_first_s, progressive_ms=prog_ms,
                grad_first_s=grad_first_s, grad_ms=grad_ms,
                train_warmup_s=warm_s, train_step_ms=step_ms,
                train_losses=losses, **ref, peak_bytes=peak_bytes(dev),
                wall_s=time.perf_counter() - t_phase)


def _grad_vs_cpu(dev, cpu, sizes: Sizes) -> dict:
    """Loss to rtol 1e-5 and gradients to 1e-3 of their max-abs value:
    on the card the gather's backward is an atomic scatter-add, whose sum
    order varies."""
    config = RenderConfig(accel=AccelKind.CLUSTER)
    px = sizes.ref_px
    with jax.default_device(dev):
        data = procedural.textured_scene(config, sizes.ref_faces, 0).data()
        accel = build_clusters(data.positions, data.faces, config.cluster)
        args = (data.positions, data.textures, data, accel,
                camera_ray_grid(px, px), framing_eye(data.positions),
                jnp.eye(3, dtype=jnp.float32),
                jnp.zeros((px * px, 3), jnp.float32))
    vg = _textured_loss(config, px)
    loss_d, grads_d = vg(*jax.device_put(args, dev))
    loss_c, grads_c = vg(*jax.device_put(args, cpu))
    loss_d, loss_c = float(loss_d), float(loss_c)
    require(abs(loss_d - loss_c) <= 1e-5 * abs(loss_c),
            f"grad: loss {loss_d} on {dev.platform} vs {loss_c} on cpu")
    errs = []
    for gd, gc in zip(grads_d, grads_c):
        gd, gc = np.asarray(gd), np.asarray(gc)
        scale = float(np.abs(gc).max())
        err = float(np.abs(gd - gc).max())
        require(scale > 0 and err <= 1e-3 * scale,
                f"grad: max |d - cpu| {err} vs max-abs {scale}")
        errs.append(err / scale)
    return {"ref": f"{sizes.ref_faces} faces {px}x{px} vs cpu",
            "ref_loss_rel": abs(loss_d - loss_c) / abs(loss_c),
            "ref_grad_rel_pos": errs[0], "ref_grad_rel_tex": errs[1]}


def phase_bounce(dev, sizes: Sizes) -> dict:
    """BASELINE config 5: multi-mesh two-bounce frame."""
    from raytracercuda_tpu.ops.math import pack_rgb_vec
    from raytracercuda_tpu.trace.bounce import render_bounces

    t_phase = time.perf_counter()
    config = RenderConfig(accel=AccelKind.CLUSTER)
    h, w = sizes.bounce_hw
    with jax.default_device(dev):
        data = procedural.multi_mesh_scene(config, sizes.bounce_scale).data()
        accel = build_clusters(data.positions, data.faces, config.cluster)
        eye = framing_eye(data.positions, dist=1.2)
        dirs = rotate_rays(camera_ray_grid(w, h), jnp.eye(3, dtype=jnp.float32))
        first_s, ms, rgb = timed(
            lambda: render_bounces(accel, data, eye, dirs, h, w, config,
                                   num_bounces=2), sizes.bounce_iters)
        rgb0 = render_bounces(accel, data, eye, dirs, h, w, config,
                              num_bounces=0)
        changed = float(jnp.mean(jnp.any(jnp.abs(rgb - rgb0) > 1e-6,
                                          axis=-1)))
        require(changed > 0, "bounce: the bounces changed no pixel")
        n = min(sizes.bounce_samples, h * w)
        idx = np.random.default_rng(0).choice(h * w, n, replace=False)
        oracle_cfg = dataclasses.replace(config, trace=ORACLE_TRACE)
        orgb = render_bounces(accel, data, eye, dirs[idx], 1, n, oracle_cfg,
                              num_bounces=2, use_brute=True)
        got = channels(pack_rgb_vec(rgb[idx]))
        want = channels(pack_rgb_vec(orgb))
    bad = (np.abs(got - want) > CHANNEL_ATOL).any(axis=1)
    share = 1.0 - float(bad.mean())
    require(share >= MATCH_SHARE,
            f"bounce: {int(bad.sum())} of {n} sampled pixels differ from the "
            f"oracle by more than {CHANNEL_ATOL}")
    return emit("bounce", scene=f"bunny+armadillo+tyra stand-ins "
                f"{data.num_faces} faces, reflectivity 0.3/0.45/0.6",
                px=f"{w}x{h}", bounces=2, first_call_s=first_s,
                ms_per_frame=ms, bounce_changed_px_share=changed,
                oracle_samples=n, oracle_match=share,
                oracle_mismatch=int(bad.sum()), peak_bytes=peak_bytes(dev),
                wall_s=time.perf_counter() - t_phase)


def phase_fill(dev, sizes: Sizes) -> dict:
    """Clear, gradient and blob against the scalar references the tests
    keep (`tests/test_frame_kernels.py`)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_frame_kernels import scalar_blob, scalar_gradient

    from raytracercuda_tpu.ops.blob import blob
    from raytracercuda_tpu.ops.gradient import color_gradient

    t_phase = time.perf_counter()
    px = sizes.fill_px
    with jax.default_device(dev):
        target = RenderTarget.create(px, px)
        require(Camera.create().clear(target, 0x00FF00FF) == 0,
                "fill: clear failed")
        clear = np.asarray(target.buffer)
        grad = np.asarray(color_gradient(px, px))
        bl = np.asarray(blob(px, px, 1.25))
    require((clear == 0x00FF00FF).all(), "fill: clear value")
    dg = np.abs(channels(grad) - channels(scalar_gradient(px * px))).max()
    db = np.abs(channels(bl) - channels(scalar_blob(px, px, 1.25))).max()
    require(dg <= 1 and db <= 1,
            f"fill: gradient/blob channels differ by {dg}/{db}")
    return emit("fill", px=f"{px}x{px}", clear="exact",
                gradient_max_channel_diff=int(dg),
                blob_max_channel_diff=int(db), peak_bytes=peak_bytes(dev),
                wall_s=time.perf_counter() - t_phase)


def phase_four_cards(devices, sizes: Sizes) -> dict:
    """The multi-device paths over a 1-D ``"rays"`` mesh of ``devices``,
    each against the single-device result on ``devices[0]``."""
    import optax

    from raytracercuda_tpu.diff.render_grad import render_rgb
    from raytracercuda_tpu.ops.math import pack_rgb_vec
    from raytracercuda_tpu.parallel.mesh import make_ray_mesh
    from raytracercuda_tpu.parallel.ring import (make_ring_mesh,
                                                 pad_clusters_for_ring,
                                                 trace_ring_sharded)
    from raytracercuda_tpu.parallel.shard import (make_train_step,
                                                  render_bounces_sharded,
                                                  render_sharded)
    from raytracercuda_tpu.trace.bounce import render_bounces
    from raytracercuda_tpu.trace.dense import trace_clusters_rays

    t_phase = time.perf_counter()
    n = len(devices)
    dev0 = devices[0]
    mesh = make_ray_mesh(devices=devices)
    config = RenderConfig(accel=AccelKind.CLUSTER)
    res = {"devices": n}
    with jax.default_device(dev0):
        # Pixel-band render.
        px = sizes.frame_px
        data = procedural.bunny_scene(config, sizes.frame_faces).data()
        accel = build_clusters(data.positions, data.faces, config.cluster)
        eye = framing_eye(data.positions)
        orient = jnp.eye(3, dtype=jnp.float32)
        rays = camera_ray_grid(px, px)
        t0 = time.perf_counter()
        img = render_sharded(data, accel, rays, eye, orient, config, mesh,
                             with_shadows=True, frame_hw=(px, px))
        img = np.asarray(pack_rgb_vec(img))
        res["render_sharded_s"] = time.perf_counter() - t0
        want = np.asarray(pack_rgb_vec(render_rgb(
            data, accel, rays, eye, orient, config, with_shadows=True,
            frame_hw=(px, px))))
        d = int(np.abs(channels(img) - channels(want)).max())
        require(d <= CHANNEL_ATOL,
                f"four-cards: sharded frame channels differ by {d}")
        res["render_max_channel_diff"] = d

        # Ring traversal with the primitives sharded.
        origin = jnp.broadcast_to(eye[None, :], rays.shape)
        dirs = rotate_rays(rays, orient)
        ring_cs = pad_clusters_for_ring(accel, n)
        t0 = time.perf_counter()
        rh = trace_ring_sharded(ring_cs, origin, dirs, make_ring_mesh(
            devices=devices), config.trace)
        rf = np.asarray(rh.face)
        res["ring_s"] = time.perf_counter() - t0
        wf = np.asarray(trace_clusters_rays(accel, origin, dirs,
                                            config.trace).face)
        require(np.array_equal(rf, wf), "four-cards: ring face ids differ "
                f"at {int((rf != wf).sum())} rays")
        res["ring_face_ids"] = "equal"

        # One psum train step, n cards against one.
        tdata = procedural.textured_scene(config, sizes.ref_faces, 0).data()
        taccel = build_clusters(tdata.positions, tdata.faces, config.cluster)
        tpx = sizes.ref_px
        trays = camera_ray_grid(tpx, tpx)
        teye = framing_eye(tdata.positions)
        target = jnp.zeros((tpx * tpx, 3), jnp.float32)
        params = {"positions": tdata.positions, "textures": tdata.textures}
        out = []
        for m in (mesh, make_ray_mesh(devices=[dev0])):
            step, opt = make_train_step(config, m, optimizer=optax.adam(1e-3),
                                        frame_hw=(tpx, tpx))
            out.append(jax.block_until_ready(step(
                params, opt.init(params), tdata, taccel, trays, teye, orient,
                target)))
        (p4, _, l4), (p1, _, l1) = out
        require(abs(float(l4) - float(l1)) <= 1e-5 * abs(float(l1)),
                f"four-cards: psum loss {float(l4)} vs {float(l1)}")
        for k in params:
            np.testing.assert_allclose(np.asarray(p4[k]), np.asarray(p1[k]),
                                       rtol=1e-4, err_msg=k)
        res["train_step"] = "loss rtol 1e-5, params rtol 1e-4"

        # Two-bounce frame in pixel bands.
        h, w = sizes.bounce_hw
        bdata = procedural.multi_mesh_scene(config, sizes.bounce_scale).data()
        baccel = build_clusters(bdata.positions, bdata.faces, config.cluster)
        beye = framing_eye(bdata.positions, dist=1.2)
        bdirs = rotate_rays(camera_ray_grid(w, h), orient)
        t0 = time.perf_counter()
        got = np.asarray(pack_rgb_vec(render_bounces_sharded(
            baccel, bdata, beye, bdirs, h, w, config, mesh, num_bounces=2)))
        res["bounces_sharded_s"] = time.perf_counter() - t0
        want = np.asarray(pack_rgb_vec(render_bounces(
            baccel, bdata, beye, bdirs, h, w, config, num_bounces=2)))
        bad = (np.abs(channels(got) - channels(want)) > CHANNEL_ATOL).any(1)
        share = 1.0 - float(bad.mean())
        require(share >= MATCH_SHARE, f"four-cards: sharded bounce frame "
                f"differs at {int(bad.sum())} pixels")
        res["bounce_match"] = share
    return emit("four-cards", **res, bounce_px=f"{w}x{h}",
                peak_bytes=[peak_bytes(d) for d in devices],
                wall_s=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------------
# Driver.
# ---------------------------------------------------------------------------


_PROBE = ("import jax, json; d = jax.devices(); print(json.dumps("
          "{'devices': [str(x) for x in d], 'platform': d[0].platform, "
          "'kind': d[0].device_kind, 'count': len(d)}))")


def probe_devices(cards: int) -> dict:
    """JAX's devices as a child process sees them; SystemExit unless they
    are at least ``cards`` GPUs.  The child exits before this process
    touches a device."""
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, timeout=600)
    if out.returncode != 0:
        raise SystemExit(f"device probe failed:\n{out.stderr[-4000:]}")
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    if rec["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default platform is {rec['platform']!r} "
            f"({rec['kind']}); chip_smoke.py measures the card and does not "
            "fall back to another platform")
    if rec["count"] < cards:
        raise SystemExit(f"need {cards} GPUs, JAX sees {rec['count']}")
    return rec


def run_gpu_tests() -> dict:
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "tests/", "-q",
         "-p", "no:cacheprovider"],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    tail = out.stdout.strip().splitlines()[-1:] or [""]
    if out.returncode != 0:
        sys.stdout.write(out.stdout[-8000:])
        sys.stderr.write(out.stderr[-4000:])
        raise SmokeFailure(f"gpu tests failed (rc {out.returncode})")
    return emit("gpu-tests", result=tail[0],
                wall_s=time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device paths, over four GPUs")
    args = ap.parse_args(argv)
    cards = 4 if args.four_cards else 1

    t_all = time.perf_counter()
    rec = probe_devices(cards)
    emit("device", **rec)
    print("card:", card_line(), flush=True)
    configure_compile_cache()
    # The grad phase compares against the CPU in the same process.
    plats = jax.config.jax_platforms
    if plats and "cpu" not in plats.split(","):
        jax.config.update("jax_platforms", plats + ",cpu")

    sizes = Sizes()
    if args.four_cards:
        require_gpu()
        phase_four_cards(jax.devices()[:4], sizes)
    else:
        run_gpu_tests()
        require_gpu()
        dev = jax.devices()[0]
        phase_frame(dev, sizes)
        phase_api(dev, sizes, os.path.join(REPO, "out", "chip_smoke"))
        phase_grad(dev, sizes)
        phase_bounce(dev, sizes)
        phase_fill(dev, sizes)
    rec = device_record()
    print(f"total wall {time.perf_counter() - t_all:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
