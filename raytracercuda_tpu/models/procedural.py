"""Procedural geometry (no file IO): icosphere, quad and bumpy-sphere
generators, and the seeded stand-in scenes every benchmark and smoke run
renders.  The quad mirrors the reference's hand-built fixture
(`TestProgram/Program.cpp:153-185`).

The stand-ins match the reference's benchmark meshes in face count only:
bunny and f16 ship with the reference (SURVEY.md §4); armadillo and tyra
are referenced by it but not shipped (`Program.cpp:142-145`).  Nothing is
read from disk, so every run renders the same scenes from their seeds.
"""

from __future__ import annotations

import numpy as np

from ..config import DEFAULT_CONFIG, RenderConfig
from .mesh import Mesh, VERTEX_DATA_NORMAL, VERTEX_DATA_POSITION, VERTEX_DATA_UV1
from .scene import Material, Scene

BUNNY_FACES = 69630
F16_FACES = 4056
ARMADILLO_FACES = 345944
TYRA_FACES = 100002


def icosphere(subdivisions: int = 3, radius: float = 1.0, center=(0.0, 0.0, 0.0)):
    """Subdivided icosahedron: (positions [V,3], indices [F,3]) float32/int32."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(subdivisions):
        cache: dict[tuple[int, int], int] = {}
        vlist = list(verts)

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = (vlist[a] + vlist[b]) / 2.0
                m /= np.linalg.norm(m)
                cache[key] = len(vlist)
                vlist.append(m)
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.array(vlist)
        faces = np.array(new_faces, np.int64)

    positions = (verts * radius + np.asarray(center)).astype(np.float32)
    return positions, faces.astype(np.int32)


def icosphere_mesh(subdivisions: int = 3, radius: float = 1.0, center=(0.0, 0.0, 3.0)) -> Mesh:
    """An icosphere as a framework Mesh with smooth normals and spherical UVs."""
    positions, faces = icosphere(subdivisions, radius, center)
    normals = positions - np.asarray(center, np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    u = 0.5 + np.arctan2(normals[:, 2], normals[:, 0]) / (2 * np.pi)
    v = 0.5 - np.arcsin(np.clip(normals[:, 1], -1, 1)) / np.pi
    uvs = np.stack([u, v], axis=1).astype(np.float32)
    mesh = Mesh.create()
    assert mesh.set_indices(faces.reshape(-1).astype(np.uint32), faces.size) == 0
    nv = positions.shape[0]
    assert mesh.set_vertex_data(positions, nv, 3, VERTEX_DATA_POSITION) == 0
    assert mesh.set_vertex_data(normals.astype(np.float32), nv, 3, VERTEX_DATA_NORMAL) == 0
    assert mesh.set_vertex_data(uvs, nv, 2, VERTEX_DATA_UV1) == 0
    return mesh


def quad_mesh(z: float = 1.56) -> Mesh:
    """The reference's hand-built 2-triangle quad (`Program.cpp:153-185`)."""
    mesh = Mesh.create()
    verts = np.array([[-1, -1, z], [0, 1, z], [1, -1, z], [2, 1, z]], np.float32)
    normals = np.tile(np.array([[0, 0, -1]], np.float32), (4, 1))
    indices = np.array([0, 1, 2, 1, 2, 3], np.uint32)
    assert mesh.set_indices(indices, 6) == 0
    assert mesh.set_vertex_data(verts, 4, 3, VERTEX_DATA_POSITION) == 0
    assert mesh.set_vertex_data(normals, 4, 3, VERTEX_DATA_NORMAL) == 0
    return mesh


def bumpy_sphere_mesh(
    num_faces: int,
    radius: float = 1.0,
    center=(0.0, 0.0, 3.0),
    bump: float = 0.15,
    seed: int = 0,
) -> Mesh:
    """Displaced lat-long sphere hitting an ARBITRARY face count.

    Stand-in for Content meshes the reference repo references but does not
    ship (armadillo ~346k faces, tyra ~100k — `Program.cpp:142-145`,
    `.gitignore:20-28`): matches their triangle counts with a non-convex,
    bumpy surface so traversal-depth behavior is realistic.
    """
    # 2*rows*cols triangles; pick rows/cols near-square then trim faces.
    rows = max(2, int(np.sqrt(num_faces / 4)))
    cols = max(3, -(-num_faces // (2 * rows)))
    rng = np.random.default_rng(seed)
    th = np.linspace(1e-3, np.pi - 1e-3, rows + 1)
    ph = np.linspace(0.0, 2 * np.pi, cols + 1)[:-1]
    tg, pg = np.meshgrid(th, ph, indexing="ij")  # [rows+1, cols]
    # Smooth low-frequency displacement field (sum of random harmonics).
    r = np.full(tg.shape, radius)
    for _ in range(6):
        a, b = rng.integers(1, 5, 2)
        phase = rng.uniform(0, 2 * np.pi, 2)
        r += bump * radius / 6 * np.cos(a * tg + phase[0]) * np.sin(b * pg + phase[1])
    x = r * np.sin(tg) * np.cos(pg)
    y = r * np.cos(tg)
    z = r * np.sin(tg) * np.sin(pg)
    pos = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    pos += np.asarray(center, np.float32)

    def vid(i, j):
        return i * cols + (j % cols)

    quads = []
    for i in range(rows):
        for j in range(cols):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j), vid(i + 1, j + 1)
            quads.append([a, b, c])
            quads.append([b, d, c])
    faces = np.asarray(quads, np.int64)[:num_faces]
    # Area-weighted smooth normals.
    fn = np.cross(pos[faces[:, 1]] - pos[faces[:, 0]],
                  pos[faces[:, 2]] - pos[faces[:, 0]])
    normals = np.zeros_like(pos)
    for k in range(3):
        np.add.at(normals, faces[:, k], fn)
    nrm = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = (normals / np.maximum(nrm, 1e-20)).astype(np.float32)
    u = (pg / (2 * np.pi)).reshape(-1)
    v = (tg / np.pi).reshape(-1)
    uvs = np.stack([u, v], axis=1).astype(np.float32)

    mesh = Mesh.create()
    nv = pos.shape[0]
    assert mesh.set_indices(faces.reshape(-1).astype(np.uint32), faces.size) == 0
    assert mesh.set_vertex_data(pos, nv, 3, VERTEX_DATA_POSITION) == 0
    assert mesh.set_vertex_data(normals, nv, 3, VERTEX_DATA_NORMAL) == 0
    assert mesh.set_vertex_data(uvs, nv, 2, VERTEX_DATA_UV1) == 0
    return mesh


def seeded_texture(size: int = 256, cells: int = 8, seed: int = 0) -> np.ndarray:
    """``[size, size, 3]`` float32 texture: a grid of seeded random colors."""
    rng = np.random.default_rng(seed)
    colors = rng.uniform(0.2, 1.0, (cells, cells, 3)).astype(np.float32)
    rep = -(-size // cells)
    return np.repeat(np.repeat(colors, rep, 0), rep, 1)[:size, :size]


def bunny_scene(config: RenderConfig = DEFAULT_CONFIG,
                num_faces: int = BUNNY_FACES) -> Scene:
    """Benchmark config 3: the bunny stand-in."""
    scene = Scene.create(config)
    scene.add_mesh(bumpy_sphere_mesh(num_faces, center=(0.0, 0.0, 3.0),
                                     seed=1))
    return scene


def textured_scene(config: RenderConfig = DEFAULT_CONFIG,
                   f16_faces: int = F16_FACES,
                   armadillo_faces: int = ARMADILLO_FACES) -> Scene:
    """Benchmark config 4: a textured f16 stand-in in front of the
    armadillo stand-in (``armadillo_faces=0`` leaves it out)."""
    scene = Scene.create(config)
    f16 = bumpy_sphere_mesh(f16_faces, radius=1.5, center=(0.0, 0.0, 3.0),
                            seed=4)
    scene.textures.append(seeded_texture(seed=4))
    scene.materials.append(Material(texture_id=len(scene.textures) - 1))
    f16.material_id = len(scene.materials) - 1
    scene.add_mesh(f16)
    if armadillo_faces:
        scene.add_mesh(bumpy_sphere_mesh(armadillo_faces, radius=4.0,
                                         center=(0.0, -1.0, 14.0), seed=2))
    return scene


def multi_mesh_scene(config: RenderConfig = DEFAULT_CONFIG,
                     scale: int = 1) -> Scene:
    """Benchmark config 5: bunny, armadillo and tyra stand-ins, mirror
    reflectivity 0.3, 0.45 and 0.6.  ``scale`` divides every face count."""
    scene = Scene.create(config)
    parts = [(BUNNY_FACES, 0.6, (0.0, 0.5, 0.0), 1, 0.3),
             (ARMADILLO_FACES, 0.9, (1.6, 0.8, 0.2), 2, 0.45),
             (TYRA_FACES, 0.7, (-1.5, 0.6, -0.3), 3, 0.6)]
    for faces, radius, center, seed, refl in parts:
        mesh = bumpy_sphere_mesh(faces // scale, radius=radius,
                                 center=center, seed=seed)
        scene.materials.append(Material(reflectivity=refl))
        mesh.material_id = len(scene.materials) - 1
        scene.add_mesh(mesh)
    return scene
