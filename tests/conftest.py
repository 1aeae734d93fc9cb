"""Test configuration.

Default tier: everything on the CPU, as a virtual 8-device mesh
(``--xla_force_host_platform_device_count=8``, SURVEY.md §4.7) so the
sharding tests see several devices.

GPU tier (``pytest -m gpu tests/``): the default device is kept and the
persistent compile cache is used.  Tests that need the card are marked
``gpu`` and take the ``gpu`` fixture, which skips them on any other
platform.
"""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _gpu_tier(config) -> bool:
    return (config.getoption("markexpr") or "").strip() == "gpu"


def pytest_configure(config):
    # Runs before any test module is imported, so before any backend is
    # initialized.
    if _gpu_tier(config):
        from raytracercuda_tpu.utils.compile_cache import (
            configure_compile_cache)

        configure_compile_cache()
        return
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """The GPU under test; skips unless JAX's default platform is a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (default platform is {dev.platform}); "
                    "run `pytest -m gpu tests/` on the card")
    return dev


@pytest.fixture
def content_dir(tmp_path, monkeypatch):
    """A content directory written from seeded meshes
    (`helpers.write_content`), made the one `utils.content` searches."""
    from helpers import write_content

    from raytracercuda_tpu.utils import content

    root = write_content(str(tmp_path / "content"))
    monkeypatch.setattr(content, "CONTENT_DIRS", [root])
    monkeypatch.setattr(content, "_CACHE", str(tmp_path / "cache"))
    return root
