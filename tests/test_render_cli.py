"""Render CLI end-to-end: frames written, parity and FrameRenderer paths."""

import os

import numpy as np
import pytest

from raytracercuda_tpu.apps.render_cli import main
from raytracercuda_tpu.utils import content


@pytest.mark.slow
def test_cli_parity_frame(tmp_path, content_dir):
    model = content.find("suzanne.obj")
    rc = main([model, "-o", str(tmp_path), "--size", "64", "--accel",
               "cluster", "--shading", "parity"])
    assert rc == 0
    assert os.path.exists(tmp_path / "frame_0000.png")


@pytest.mark.slow
def test_cli_frame_renderer_path(tmp_path, content_dir):
    """--shading lambert-shadow with cluster accel routes through
    FrameRenderer (the bench's product path)."""
    model = content.find("suzanne.obj")
    rc = main([model, "-o", str(tmp_path), "--size", "64", "--accel",
               "cluster", "--shading", "lambert-shadow", "--frames", "2",
               "--orbit", "15"])
    assert rc == 0
    a = (tmp_path / "frame_0000.png").stat().st_size
    b = (tmp_path / "frame_0001.png").stat().st_size
    assert a > 0 and b > 0
