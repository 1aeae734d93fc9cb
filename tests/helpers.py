"""Shared test fixtures: seeded triangle scenes and on-disk content."""

import os
import zipfile

import numpy as np
import jax.numpy as jnp

from raytracercuda_tpu.models.loader import write_obj
from raytracercuda_tpu.models.procedural import (bumpy_sphere_mesh,
                                                  seeded_texture)
from raytracercuda_tpu.models.scene import SceneData
from raytracercuda_tpu.utils.bmp import write_bmp


def sphere_scene(num_faces=700, seed=3, spread=0.8, center=(0, 0, 3.0)):
    """Small random triangles scattered over a sphere: ``(positions,
    faces)`` with one triangle per three vertices."""
    rng = np.random.default_rng(seed)
    base = (rng.standard_normal((num_faces, 3)) * spread).astype(np.float32)
    base /= np.maximum(np.linalg.norm(base, axis=1, keepdims=True), 1e-6)
    base = base * spread + np.asarray(center, np.float32)
    offs = rng.normal(scale=0.1, size=(num_faces, 2, 3)).astype(np.float32)
    verts = np.concatenate([base[:, None], base[:, None] + offs],
                           axis=1).reshape(-1, 3)
    faces = np.arange(num_faces * 3, dtype=np.int32).reshape(-1, 3)
    faces = np.concatenate([faces, np.zeros((num_faces, 1), np.int32)],
                           axis=1)
    return jnp.asarray(verts), jnp.asarray(faces)


def make_scene(num_faces=900, seed=17):
    """A shaded `SceneData` over `sphere_scene` with random normals."""
    rng = np.random.default_rng(seed)
    positions, faces = sphere_scene(num_faces, seed=seed)
    nv = positions.shape[0]
    return SceneData(
        positions=positions, faces=faces,
        attrs={1: jnp.asarray(
            rng.standard_normal((nv, 3)).astype(np.float32))},
        mesh_material=jnp.asarray([0], jnp.int32),
        albedo=jnp.asarray([[0.8, 0.6, 0.4]], jnp.float32),
        texture_id=jnp.asarray([-1], jnp.int32),
        textures=jnp.zeros((0, 4, 4, 3), jnp.float32),
    )


#: Face counts of the content written by `write_content`.
SUZANNE_FACES = 240
F16_FACES = (120, 80)
BUNNY_FACES = 300


def write_content(root):
    """Write a small content directory from seeded meshes:

    - ``suzanne.obj``: one untextured group;
    - ``f16.obj`` + ``f16.mtl`` + ``F16s.bmp``/``F16t.bmp``: two material
      groups, each with its own texture;
    - ``bunny.zip`` holding ``bunny.obj`` (content that ships zipped).
    """
    os.makedirs(root, exist_ok=True)
    write_obj(os.path.join(root, "suzanne.obj"),
              [("", bumpy_sphere_mesh(SUZANNE_FACES, seed=11))])
    for i, name in enumerate(("F16s.bmp", "F16t.bmp")):
        write_bmp(os.path.join(root, name),
                  seeded_texture(size=32, cells=4, seed=i))
    write_obj(os.path.join(root, "f16.obj"),
              [("skin", bumpy_sphere_mesh(F16_FACES[0], seed=12)),
               ("tail", bumpy_sphere_mesh(F16_FACES[1], center=(2, 0, 3),
                                          seed=13))],
              {"skin": "F16s.bmp", "tail": "F16t.bmp"})
    bunny = os.path.join(root, "bunny_src.obj")
    write_obj(bunny, [("", bumpy_sphere_mesh(BUNNY_FACES, seed=14))])
    with zipfile.ZipFile(os.path.join(root, "bunny.zip"), "w") as zf:
        zf.write(bunny, "bunny.obj")
    os.unlink(bunny)
    return root
