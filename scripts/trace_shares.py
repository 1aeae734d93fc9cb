#!/usr/bin/env python
"""Where the device time goes: one `jax.profiler` trace of the 512² frame
and of the 1024² gradient step, reduced to shares of device kernel time.

    python scripts/trace_shares.py [--out DIR]

Runs on one GPU (exits non-zero otherwise).  Warms each program up, then
traces a few calls of it, and prints one JSON line per program:

  - ``frame`` (`chip_smoke.phase_frame`'s scene and renderer): the shares
    of the primary cull, compaction and sweep and of the shadow cull,
    compaction and sweep (the ``jax.named_scope`` spans of
    `trace/dense.py`), and the rest;
  - ``grad`` (`chip_smoke.phase_grad`'s loss + gradient): the share of
    kernels that scatter (the row gather's backward is a scatter-add).

Each line also gives the window, the device busy time (union of kernel
intervals) and the idle share.  XLA's command buffers (CUDA graphs) are
turned off for this process (``--xla_gpu_enable_command_buffer=``): a
graph shows in the trace as one event, which hides the kernels inside it
from the attribution; launches cost more without them, so read the idle
share here as an upper bound.  ``DIR`` (default ``chiprun_out/trace``)
keeps the 60 longest ops of each program with their opcodes and scopes;
the raw traces go to a temporary directory.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import tempfile
from collections import defaultdict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

#: Named scopes (innermost match wins) -> category.
SCOPES = ("shadow_cull", "shadow_compact", "shadow_sweep", "cull", "compact",
          "sweep")

_INSTR = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*.*?\s([a-z][\w\-]*)\((?:%|\)|-?\d)")
_CALLS = re.compile(r"calls=%?([\w.\-]+)")
_OPNAME = re.compile(r'op_name="([^"]*)"')


def parse_hlo(text: str) -> dict:
    """HLO instruction name -> (opcodes it runs, op_name metadata).

    A fusion's opcodes are those of its fused computation."""
    comps: dict[str, list[str]] = {}
    instrs: dict[str, tuple[str, str | None, str]] = {}
    cur = None
    for line in text.splitlines():
        if line.startswith("}"):
            cur = None
            continue
        m = _INSTR.match(line)
        if m and cur is not None:
            name, opcode = m.group(1), m.group(2)
            calls = _CALLS.search(line)
            op_name = _OPNAME.search(line)
            comps[cur].append(opcode)
            instrs[name] = (opcode, calls.group(1) if calls else None,
                            op_name.group(1) if op_name else "")
            continue
        if line.rstrip().endswith("{"):  # a computation's header
            cur = line.split()[0].lstrip("%")
            if cur == "ENTRY":
                cur = line.split()[1].lstrip("%")
            comps.setdefault(cur, [])
    out = {}
    for name, (opcode, called, op_name) in instrs.items():
        ops = {opcode} | set(comps.get(called, []) if opcode == "fusion"
                             else [])
        out[name] = (ops, op_name)
    return out


def kernel_events(trace_dir: str):
    """(hlo_op, start_ns, duration_ns) of every kernel on the first GPU."""
    from jax.profiler import ProfileData

    path = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                     recursive=True)[-1]
    events, lines = [], []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU:0"):
            continue
        for line in plane.lines:
            lines.append(line.name)
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                stats = dict(ev.stats)
                events.append((str(stats.get("hlo_op", ev.name)),
                               ev.start_ns, ev.duration_ns))
    return events, lines


def busy_ns(events) -> float:
    """Length of the union of the kernel intervals."""
    total, end = 0.0, None
    for _, s, d in sorted(events, key=lambda e: e[1]):
        if end is None or s > end:
            total += d
            end = s + d
        elif s + d > end:
            total += s + d - end
            end = s + d
    return total


def reduce_trace(name: str, trace_dir: str, hlo_text: str, classify,
                 out_dir: str) -> dict:
    events, lines = kernel_events(trace_dir)
    if not events:
        raise SystemExit(f"{name}: no kernel events on /device:GPU:0 "
                         f"(lines: {lines})")
    table = parse_hlo(hlo_text)
    per_op = defaultdict(float)
    per_cat = defaultdict(float)
    for op, _, dur in events:
        per_op[op] += dur
    for op, dur in per_op.items():
        ops, op_name = table.get(op, (set(), ""))
        per_cat[classify(ops, op_name)] += dur
    total = sum(per_cat.values())
    start = min(s for _, s, _ in events)
    stop = max(s + d for _, s, d in events)
    busy = busy_ns(events)
    top = sorted(per_op.items(), key=lambda r: -r[1])[:60]
    hlo_lines = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if m:
            hlo_lines.setdefault(m.group(1), line.strip()[:400])
    with open(os.path.join(out_dir, f"{name}_ops.json"), "w") as f:
        json.dump({"lines": lines,
                   "top_ops": [{"op": op, "ns": dur,
                                "category": classify(*table.get(op, (set(),
                                                                     ""))),
                                "hlo": hlo_lines.get(op)}
                               for op, dur in top]}, f, indent=1)
    return {"program": name, "kernels": len(events),
            "kernel_ms": total / 1e6, "window_ms": (stop - start) / 1e6,
            "busy_ms": busy / 1e6, "idle_share": 1 - busy / (stop - start),
            "unmatched_ops": sum(1 for op in per_op if op not in table),
            "shares": {k: v / total for k, v in sorted(per_cat.items())}}


def classify_frame(ops, op_name: str) -> str:
    parts = op_name.split("/")
    for part in reversed(parts):
        if part in SCOPES:
            return part
    return "other"


def classify_grad(ops, op_name: str) -> str:
    return "scatter" if "scatter" in ops else "other"


def traced(fn, args, iters: int, trace_dir: str) -> str:
    jax.block_until_ready(fn(*args))
    jax.block_until_ready(fn(*args))
    with jax.profiler.trace(trace_dir):
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
    return fn.lower(*args).compile().as_text()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "trace"))
    args = ap.parse_args(argv)

    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_gpu_enable_command_buffer=").strip()
    from chip_smoke import Sizes, _textured_loss
    from raytracercuda_tpu import AccelKind, RenderConfig
    from raytracercuda_tpu.accel.clusters import build_clusters
    from raytracercuda_tpu.models import procedural
    from raytracercuda_tpu.models.camera import camera_ray_grid, framing_eye
    from raytracercuda_tpu.trace.frame import FrameRenderer
    from raytracercuda_tpu.utils.compile_cache import configure_compile_cache
    from raytracercuda_tpu.utils.device import card_line, require_gpu

    configure_compile_cache()
    device = require_gpu()
    print("card:", card_line(), "| device:", json.dumps(device), flush=True)
    os.makedirs(args.out, exist_ok=True)
    sizes = Sizes()
    config = RenderConfig(accel=AccelKind.CLUSTER)
    orient = jnp.eye(3, dtype=jnp.float32)

    px = sizes.frame_px
    data = procedural.bunny_scene(config, sizes.frame_faces).data()
    accel = build_clusters(data.positions, data.faces, config.cluster)
    renderer = FrameRenderer(data, accel, config, px, px)
    rays = camera_ray_grid(px, px)
    frame = jax.jit(lambda eye: renderer.render(eye, orient, rays))
    with tempfile.TemporaryDirectory() as d:
        hlo = traced(frame, (framing_eye(data.positions),), 5, d)
        print(json.dumps(reduce_trace("frame", d, hlo, classify_frame,
                                      args.out)), flush=True)

    px = sizes.grad_px
    data = procedural.textured_scene(config, sizes.f16_faces,
                                     sizes.armadillo_faces).data()
    accel = build_clusters(data.positions, data.faces, config.cluster)
    grad = _textured_loss(config, px)
    gargs = (data.positions, data.textures, data, accel,
             camera_ray_grid(px, px), framing_eye(data.positions, dist=1.0),
             orient, jnp.zeros((px * px, 3), jnp.float32))
    with tempfile.TemporaryDirectory() as d:
        hlo = traced(grad, gargs, 2, d)
        print(json.dumps(reduce_trace("grad", d, hlo, classify_grad,
                                      args.out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
