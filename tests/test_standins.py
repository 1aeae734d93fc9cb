"""Seeded stand-in scenes (`models/procedural.py`): exact reference face
counts, deterministic from their seeds, and the compile-cache helper."""

import numpy as np
import pytest

from raytracercuda_tpu.models import procedural
from raytracercuda_tpu.utils import compile_cache


def _arrays(scene):
    d = scene.data()
    return [np.asarray(x) for x in
            (d.positions, d.faces, d.attrs[1], d.textures, d.reflectivity,
             d.mesh_material, d.texture_id)]


@pytest.mark.parametrize("build,faces", [
    (procedural.bunny_scene, 69630),
    (procedural.textured_scene, 4056 + 345944),
    (procedural.multi_mesh_scene, 69630 + 345944 + 100002),
])
def test_standin_face_counts_and_determinism(build, faces):
    a = build()
    assert a.data().num_faces == faces
    for x, y in zip(_arrays(a), _arrays(build())):
        np.testing.assert_array_equal(x, y)


def test_textured_standin_has_uvs_and_texture():
    data = procedural.textured_scene(f16_faces=200, armadillo_faces=0).data()
    assert data.num_faces == 200
    assert 2 in data.attrs  # VERTEX_DATA_UV1
    assert int(data.texture_id[data.mesh_material[0]]) == 0
    assert data.textures.shape == (1, 256, 256, 3)
    tex = np.asarray(data.textures)
    assert 0.2 <= tex.min() and tex.max() <= 1.0 and tex.std() > 0


def test_multi_mesh_standin_reflectivity():
    data = procedural.multi_mesh_scene(scale=1000).data()
    refl = np.asarray(data.reflectivity)[np.asarray(data.mesh_material)]
    np.testing.assert_allclose(refl, [0.3, 0.45, 0.6])


def test_seeded_texture_depends_on_seed():
    a = procedural.seeded_texture(64, seed=1)
    assert a.shape == (64, 64, 3) and a.dtype == np.float32
    np.testing.assert_array_equal(a, procedural.seeded_texture(64, seed=1))
    assert not np.array_equal(a, procedural.seeded_texture(64, seed=2))


@pytest.mark.parametrize("env", [None, "/some/where/else"])
def test_compile_cache_dir(env, monkeypatch):
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = compile_cache.configure_compile_cache()
        assert path.endswith(".jax_cache")
        assert calls == [("jax_compilation_cache_dir", path)]
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
        assert compile_cache.configure_compile_cache() == env
        assert calls == []  # JAX reads the variable itself
