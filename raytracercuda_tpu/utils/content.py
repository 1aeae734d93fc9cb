"""Locate and stage Content meshes (suzanne.obj, f16.obj + BMP textures,
bunny.zip — the reference repo's `Content/` layout) for the apps.

The directory is ``$RAYTRACER_CONTENT`` or ``<repo>/content``.  Zipped
meshes are extracted into a local cache directory.  Benchmarks and tests
do not read content: they render seeded stand-ins
(`models/procedural.py`) or write their own fixtures.
"""

from __future__ import annotations

import os
import zipfile

CONTENT_DIRS = [
    os.environ.get("RAYTRACER_CONTENT", ""),
    os.path.join(os.path.dirname(__file__), "..", "..", "content"),
]

_CACHE = os.path.join(os.path.dirname(__file__), "..", "..", ".content_cache")


def content_dir() -> str | None:
    for d in CONTENT_DIRS:
        if d and os.path.isdir(d):
            return d
    return None


def find(name: str) -> str | None:
    """Path to a content file; extracts ``<stem>.zip`` into the cache when
    only the zip exists (bunny ships zipped)."""
    d = content_dir()
    if d is None:
        return None
    direct = os.path.join(d, name)
    if os.path.exists(direct):
        return direct
    cached = os.path.join(_CACHE, name)
    if os.path.exists(cached):
        return cached
    stem = os.path.splitext(name)[0]
    z = os.path.join(d, stem + ".zip")
    if os.path.exists(z):
        os.makedirs(_CACHE, exist_ok=True)
        with zipfile.ZipFile(z) as zf:
            zf.extractall(_CACHE)
        if os.path.exists(cached):
            return cached
        # Some zips nest the file; search.
        for root, _, files in os.walk(_CACHE):
            if name in files:
                return os.path.join(root, name)
    return None
