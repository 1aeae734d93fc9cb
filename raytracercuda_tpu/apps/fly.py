"""Input-driven fly-camera frame loop — the reference TestProgram's
interactive loop (`TestProgram/Program.cpp:196-263` SDL poll, WASD/QE +
mouse -> pose; `Program.cpp:302-311` render-target rotation over NUM_RT)
with the input stream made SCRIPTABLE: without a display,
so events come from a replay file (or live stdin lines), and frames go
to PNGs.  Per-frame semantics mirror the reference exactly:

  * key state machine over a/d/w/s/q/e (held keys, not edges),
  * ``move.x -= speed`` on a, ``+=`` on d; ``move.z += speed`` on w,
    ``-=`` on s (speed 0.3, `Program.cpp:207`),
  * mouse motion: ``pan += xrel*0.004``, ``pitch += yrel*0.004``,
  * ``orient = yaw(pan) @ pitch(pitch)``; ``pos += orient @ move``;
    q/e move world-space y (`Program.cpp:248-259`),
  * each frame advances the render-target index mod NUM_RT and performs
    the reference's unlock -> lock cycle on it before tracing.

Event-script format (one JSON object per line):
  {"frame": 3, "event": "keydown", "key": "w"}
  {"frame": 5, "event": "keyup",   "key": "w"}
  {"frame": 6, "event": "mouse", "xrel": 40, "yrel": -12}
  {"frame": 9, "event": "quit"}
Events fire at the START of their frame (same as an SDL poll).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

KEYS = ("a", "d", "w", "s", "q", "e")
SPEED = 0.3       # Program.cpp:207
MSPEED = 0.004    # Program.cpp:208
NUM_RT = 3        # reference ships NUM_RT=1; >1 exercises the rotation


class FlyState:
    """The reference Program's camera state machine, display-free."""

    def __init__(self, pos, pan: float = 0.0, pitch: float = 0.0):
        self.pos = np.asarray(pos, np.float32).copy()
        self.pan = float(pan)
        self.pitch = float(pitch)
        self.kds = {k: False for k in KEYS}
        self.quit = False

    def feed(self, ev: dict) -> None:
        kind = ev.get("event")
        if kind == "keydown":
            if ev.get("key") == "escape":
                self.quit = True
            elif ev.get("key") in self.kds:
                self.kds[ev["key"]] = True
        elif kind == "keyup":
            if ev.get("key") in self.kds:
                self.kds[ev["key"]] = False
        elif kind == "mouse":
            self.pan += float(ev.get("xrel", 0)) * MSPEED
            self.pitch += float(ev.get("yrel", 0)) * MSPEED
        elif kind == "quit":
            self.quit = True

    def update(self) -> np.ndarray:
        """Apply held keys to the pose; returns the frame's orientation
        (`Program.cpp:248-259` order: orient from CURRENT pan/pitch, move
        rotated by it, then q/e world-y)."""
        from ..models.camera import orient_from_pan_pitch

        move = np.zeros(3, np.float32)
        if self.kds["a"]:
            move[0] -= SPEED
        if self.kds["d"]:
            move[0] += SPEED
        if self.kds["w"]:
            move[2] += SPEED
        if self.kds["s"]:
            move[2] -= SPEED
        orient = orient_from_pan_pitch(self.pan, self.pitch)
        self.pos += orient @ move
        if self.kds["q"]:
            self.pos[1] += SPEED
        if self.kds["e"]:
            self.pos[1] -= SPEED
        return orient


def _load_script(path: str):
    events: dict[int, list[dict]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ev = json.loads(line)
            events.setdefault(int(ev.get("frame", 0)), []).append(ev)
    return events


def run_loop(scene, cam, rts, state: FlyState, events, max_frames: int,
             out_dir: str | None, profiler=None, on_frame=None) -> int:
    """The frame loop: poll -> update -> rotate RT -> unlock/lock ->
    trace -> present.  Returns the number of frames rendered."""
    from ..utils.png import write_packed_png

    rt_idx = 0
    frames_done = 0
    # Reference locks RT 0 before the loop (Program.cpp:192-193); rts
    # arrive locked=first-only, we normalize: lock rts[0].
    if not rts[0].locked:
        assert rts[0].lock() == 0
    for frame in range(max_frames):
        for ev in events.get(frame, ()):  # SDL_PollEvent analog
            state.feed(ev)
        if state.quit:
            break
        orient = state.update()

        # Render-target rotation (`Program.cpp:302-311`): advance index,
        # unlock the incoming RT, lock it for this frame's trace.
        rt_idx = (rt_idx + 1) % len(rts)
        rt = rts[rt_idx]
        if rt.locked:
            assert rt.unlock() == 0
        assert rt.lock() == 0

        err = cam.trace_scene(state.pos, orient, scene, rt)
        assert err == 0, f"trace error {err}"
        buf = np.asarray(rt.buffer)
        if out_dir is not None:
            write_packed_png(os.path.join(out_dir, f"fly_{frame:04d}.png"),
                             buf, cam.width, cam.height)
        if on_frame is not None:
            on_frame(frame, state, rt_idx, buf)
        frames_done += 1
    # Leave no locked process-global RT behind.
    for rt in rts:
        if rt.locked:
            rt.unlock()
    return frames_done


def main(argv=None) -> int:
    from raytracercuda_tpu import (AccelKind, Camera, RenderConfig,
                                   RenderTarget, Scene)
    from raytracercuda_tpu.models.loader import load_model
    from raytracercuda_tpu.utils import content

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="suzanne.obj")
    p.add_argument("--script", required=True, help="event-script path")
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--accel", default="bvh",
                   choices=[k.value for k in AccelKind])
    p.add_argument("--out", default="frames_fly")
    p.add_argument("--num-rt", type=int, default=NUM_RT)
    args = p.parse_args(argv)

    config = RenderConfig(accel=AccelKind(args.accel))
    scene = Scene.create(config)
    path = content.find(args.model) or args.model
    if not load_model(path, scene):
        print(f"failed to load {path}", file=sys.stderr)
        return 1
    scene.update_gpu_scene()

    cam = Camera.create()
    assert cam.set_initial_rays(args.size, args.size, -1, 1, -1, 1, 1) == 0
    rts = [RenderTarget.create(args.size, args.size)
           for _ in range(args.num_rt)]
    assert rts[0].lock() == 0

    data = scene.data()
    lo = np.asarray(data.positions.min(axis=0))
    hi = np.asarray(data.positions.max(axis=0))
    center, extent = (lo + hi) / 2, float(np.max(hi - lo))
    state = FlyState(center - np.array([0, 0, 2.0 * extent]))

    os.makedirs(args.out, exist_ok=True)
    n = run_loop(scene, cam, rts, state, _load_script(args.script),
                 args.frames, args.out)
    print(f"rendered {n} frames to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
