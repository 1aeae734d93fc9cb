"""Native C++ OBJ parser vs the pure-Python parser: identical output on
synthetic meshes and content written from seeded meshes."""

import os
import tempfile

import numpy as np
import pytest

from raytracercuda_tpu.models import loader
from raytracercuda_tpu.native import native_loader
from raytracercuda_tpu.utils import content

from helpers import BUNNY_FACES

NATIVE_OK = native_loader._load() is not None
pytestmark = pytest.mark.skipif(not NATIVE_OK, reason="native lib unavailable")


def _parse_python(path):
    """Run the pure-Python parser regardless of the native fast path."""
    real = native_loader.parse_obj
    native_loader.parse_obj = lambda p: None
    try:
        return loader.parse_obj(path)
    finally:
        native_loader.parse_obj = real


def _assert_same(path):
    a = loader.parse_obj(path)  # native fast path
    b = _parse_python(path)
    np.testing.assert_allclose(a.positions, b.positions, rtol=1e-6)
    assert (a.normals is None) == (b.normals is None)
    if a.normals is not None:
        np.testing.assert_allclose(a.normals, b.normals, rtol=1e-6)
    if a.uvs is not None and b.uvs is not None:
        np.testing.assert_allclose(a.uvs, b.uvs, rtol=1e-6)
    assert len(a.groups) == len(b.groups)
    for (ma, fa), (mb, fb) in zip(a.groups, b.groups):
        assert ma == mb
        np.testing.assert_array_equal(fa, fb)
    assert a.mtl_files == b.mtl_files


def test_native_matches_python_synthetic():
    obj = """
mtllib test.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vn 0 0 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
usemtl matA
f 1/1/1 2/2/1 3/3/1 4/4/1
usemtl matB
f -4//-1 -3//-1 -2//-1
f 1 2 3
"""
    with tempfile.NamedTemporaryFile("w", suffix=".obj", delete=False) as f:
        f.write(obj)
        path = f.name
    try:
        _assert_same(path)
        data = loader.parse_obj(path)
        assert sum(g[1].shape[0] for g in data.groups) == 4  # 2 (quad) + 1 + 1
        assert data.mtl_files == ["test.mtl"]
    finally:
        os.unlink(path)


def test_native_matches_python_f16(content_dir):
    _assert_same(content.find("f16.obj"))


def test_native_bunny_stats(content_dir):
    path = content.find("bunny.obj")
    data = loader.parse_obj(path)
    assert sum(g[1].shape[0] for g in data.groups) == BUNNY_FACES
