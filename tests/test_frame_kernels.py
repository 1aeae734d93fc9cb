"""Full-frame fill tests (clear / gradient / blob) against scalar
replications of the reference kernels (`RTClear.cu`, `Gradient.cu`,
`Blob.cu`).  `chip_smoke.py` compares the card's output with the same
scalar references."""

import numpy as np
import pytest

from raytracercuda_tpu import Camera, RenderTarget
from raytracercuda_tpu.errors import ERROR_ALL_FINE, ERROR_NO_RENDER_TARGET
from raytracercuda_tpu.ops.blob import blob
from raytracercuda_tpu.ops.clear import clear_buffer
from raytracercuda_tpu.ops.gradient import color_gradient


def test_clear_fills_value():
    buf = np.asarray(clear_buffer(1000, 0x00FF00FF))
    assert buf.shape == (1000,)
    assert buf.dtype == np.uint32
    assert (buf == 0x00FF00FF).all()


def test_clear_nonaligned_sizes():
    for n in (1, 127, 128, 1025, 499 * 499):
        buf = np.asarray(clear_buffer(n, 7))
        assert buf.shape == (n,)
        assert (buf == 7).all()


@pytest.mark.parametrize("width,height,value",
                         [(64, 48, 0xFF00FF00), (33, 7, 0), (1, 1, 0xFFFFFFFF)])
def test_camera_clear_fills_render_target(width, height, value):
    """`Camera.clear` (`Camera.cpp:74-83`) fills the target's buffer."""
    target = RenderTarget.create(width, height)
    assert Camera.create().clear(target, value) == ERROR_ALL_FINE
    buf = np.asarray(target.buffer)
    assert buf.shape == (width * height,) and buf.dtype == np.uint32
    assert (buf == np.uint32(value)).all()


def test_camera_clear_without_target():
    assert Camera.create().clear(None, 0) == ERROR_NO_RENDER_TARGET


def scalar_gradient(size):
    """Transcription of `Gradient.cu:5-41`."""
    out = np.zeros(size, np.uint32)
    block = size // 6
    for i in range(size):
        j = i if i < size else 0
        ct = j // block
        # float32 arithmetic, as the CUDA kernel computes it.
        c = np.uint32(np.float32(255) * (np.float32(j % block) / np.float32(block)))
        if ct == 0:
            out[i] = c << 16
        elif ct == 1:
            out[i] = c << 8
        elif ct == 2:
            out[i] = c
        elif ct == 3:
            out[i] = (c << 16) | (c << 8)
        elif ct == 4:
            out[i] = (c << 8) | c
        elif ct == 5:
            out[i] = (c << 16) | c
    return out


def test_gradient_matches_reference_kernel():
    w, h = 60, 40
    got = np.asarray(color_gradient(w, h))
    want = scalar_gradient(w * h)
    # XLA rewrites the /block division into a reciprocal multiply, which can
    # land the f32 ramp on the other side of an integer: allow +-1 per
    # 8-bit channel (identical tolerance class to CPU-vs-GPU builds of the
    # reference).
    gch = np.stack([(got >> 16) & 0xFF, (got >> 8) & 0xFF, got & 0xFF])
    wch = np.stack([(want >> 16) & 0xFF, (want >> 8) & 0xFF, want & 0xFF])
    assert np.abs(gch.astype(int) - wch.astype(int)).max() <= 1
    # The band structure itself must be exact.
    assert np.array_equal(got == 0, want == 0) or (got == 0).sum() <= (want == 0).sum() + 6


def test_gradient_six_bands():
    buf = np.asarray(color_gradient(96, 8))  # size divisible by 6
    size = 96 * 8
    block = size // 6
    # Band 0 is a pure red ramp, band 1 pure green, band 2 pure blue.
    assert (buf[:block] & 0x00FFFF00 == buf[:block] & 0x00FF0000).all()
    assert (buf[block] & 0x00FF00FF) == 0
    assert (buf[2 * block] & 0x00FFFF00) == 0


def scalar_blob(w, h, t):
    """Transcription of `Blob.cu:27-58`: ``[w*h]`` packed u32 at time t."""

    def pixel(i):
        ux = (i % w) - w // 2
        uy = (i // w) - h // 2
        s, c = np.sin(t), np.cos(t)
        rx, ry = c * ux - s * uy, s * ux + c * uy
        ry *= 2.0
        dx, dy = abs(rx) - 100.0, abs(ry) - 100.0
        d = min(0.0, max(dx, dy)) + np.hypot(max(dx, 0), max(dy, 0))
        tt = np.clip((d + 1) / 2, 0, 1)
        f = 1 - tt * tt * (3 - 2 * tt)
        shade = 1 - np.clip(d / 1500, 0, 1)
        bg = shade * shade
        mr, mg, mb = bg * (1 - f) + f, bg * (1 - f), bg * (1 - f)
        pack = lambda x: np.uint32(np.clip(x * 255, 0, 255))
        return (pack(mr) << np.uint32(16)) | (pack(mg) << np.uint32(8)) | pack(mb)

    return np.array([pixel(i) for i in range(w * h)], np.uint32)


def test_blob_matches_scalar():
    """The frame must be wider than the 100px SDF square so the
    edge/background branches are hit."""
    w, h, t = 320, 8, 1.25
    got = np.asarray(blob(w, h, t))
    want = scalar_blob(w, h, t)
    # float32 vs float64 trig: allow off-by-one in the 8-bit channels.
    gr = np.stack([(got >> 16) & 0xFF, (got >> 8) & 0xFF, got & 0xFF])
    wr = np.stack([(want >> 16) & 0xFF, (want >> 8) & 0xFF, want & 0xFF])
    assert np.abs(gr.astype(int) - wr.astype(int)).max() <= 1


def test_blob_time_is_traced_not_static():
    # Two different times must produce different frames without retracing
    # (time is a traced scalar, not a static arg).  The frame must extend
    # past the square SDF edge for the rotation to be visible.
    a = np.asarray(blob(320, 8, 0.0))
    b = np.asarray(blob(320, 8, 0.9))
    assert not np.array_equal(a, b)
