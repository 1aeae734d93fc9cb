"""Scene: mesh aggregation into flat device arrays, backend dispatch.

Analog of ``IScene``/``Scene`` and its concrete implementations
(`Raytracer/Scene.{h,cpp}`, `SceneTree.cpp`, `SceneHash.cpp`,
`SceneProgressive.cpp`).  Where the reference assembles a device array of
per-mesh *pointer tables* (``StaticMeshData[]``, `Scene.cpp:58-79`,
`SharedTypes.h:10-18`), the scene concatenates every mesh into single
flat SoA buffers with a global face table — no pointers, just indices —
which is what the traversal kernels consume directly from device memory.

Backend selection (kd-tree / hash / progressive in the reference,
`Scene.cpp:20-30` switching on the compile-time ``TREE_TYPE``) is a runtime
config value here (`config.AccelKind`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

from ..config import AccelKind, RenderConfig, DEFAULT_CONFIG
from ..errors import (
    ERROR_ALL_FINE,
    ERROR_NO_RENDER_TARGET,
    ERROR_RT_CAM_MISMATCH,
)
from .mesh import Mesh, VERTEX_DATA_COUNT, VERTEX_DATA_POSITION


class SceneData(NamedTuple):
    """Flattened scene — the ``StaticMeshData[]`` analog as SoA arrays.

    ``faces`` rows are ``(i0, i1, i2, mesh_id)``: exactly the payload of the
    reference's ``bmFace::m_index`` uint4 (`SharedTypes.h:25-29`), with
    vertex indices already rebased into the concatenated buffers so no
    per-mesh pointer table is needed at trace time.
    """

    positions: jnp.ndarray  # [V,3] float32
    faces: jnp.ndarray  # [F,4] int32
    attrs: dict  # {slot_id: [V,k] float32} concatenated, zero-filled
    mesh_material: jnp.ndarray  # [num_meshes] int32 material id
    albedo: jnp.ndarray  # [M,3] float32 material base color
    texture_id: jnp.ndarray  # [M] int32 index into textures, -1 = none
    textures: jnp.ndarray  # [T,H,W,3] float32 texture atlas (T>=1)
    #: [M] float32 mirror reflectance (None == all 0; drives multi-bounce).
    reflectivity: Optional[jnp.ndarray] = None

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.positions.shape[0]

    def face_vertices(self, face_ids):
        """Gather the 3 corner positions for ``face_ids`` -> 3x ``[...,3]``.

        The index-based equivalent of ``bmFaceRayIntersect``'s vertex fetch
        (`CudaComon.cuh:243-251`)."""
        f = self.faces[face_ids]
        v0 = self.positions[f[..., 0]]
        v1 = self.positions[f[..., 1]]
        v2 = self.positions[f[..., 2]]
        return v0, v1, v2

    def aabb(self):
        return jnp.min(self.positions, axis=0), jnp.max(self.positions, axis=0)


class Material:
    """Host-side material — ``bmMaterial`` analog (`SharedTypes.h:20-23`,
    which holds only a texture id) extended with a base color."""

    def __init__(self, albedo=(1.0, 1.0, 1.0), texture_id: int = -1,
                 reflectivity: float = 0.0):
        self.albedo = tuple(float(c) for c in albedo)
        self.texture_id = texture_id
        self.reflectivity = float(reflectivity)


def flatten_meshes(
    meshes: list[Mesh],
    materials: Optional[list[Material]] = None,
    textures: Optional[list[np.ndarray]] = None,
) -> SceneData:
    """Concatenate meshes into one SoA scene (``updateMeshPtrs`` analog,
    `Scene.cpp:58-79`, pointer tables -> rebased flat indices)."""
    if not meshes:
        raise ValueError("scene has no meshes")
    if materials is None:
        materials = [Material()]

    pos_list, face_list = [], []
    voffset = 0
    # Per-slot component widths: max across meshes so heterogeneous meshes
    # can still concatenate (missing slots zero-fill).
    slot_sizes = [0] * VERTEX_DATA_COUNT
    for m in meshes:
        for s in range(VERTEX_DATA_COUNT):
            slot_sizes[s] = max(slot_sizes[s], m.vertex_data_size(s))

    attr_lists: dict[int, list[np.ndarray]] = {
        s: [] for s in range(VERTEX_DATA_COUNT) if slot_sizes[s] > 0 and s != VERTEX_DATA_POSITION
    }
    mesh_material = []
    for mesh_id, m in enumerate(meshes):
        assert m.indices is not None, "mesh has no indices"
        nv = m.num_vertices
        pos_list.append(m.positions.astype(np.float32))
        idx = m.indices.reshape(-1, 3).astype(np.int64) + voffset
        mid = np.full((idx.shape[0], 1), mesh_id, dtype=np.int64)
        face_list.append(np.concatenate([idx, mid], axis=1))
        for s, lst in attr_lists.items():
            data = m.vertex_data(s)
            width = slot_sizes[s]
            if data is None:
                lst.append(np.zeros((nv, width), np.float32))
            elif data.shape[1] < width:
                pad = np.zeros((nv, width - data.shape[1]), np.float32)
                lst.append(np.concatenate([data, pad], axis=1))
            else:
                lst.append(data)
        mesh_material.append(m.material_id)
        voffset += nv

    if textures:
        # Pad all textures to a common H, W so they stack into one atlas.
        th = max(t.shape[0] for t in textures)
        tw = max(t.shape[1] for t in textures)
        padded = []
        for t in textures:
            t = np.asarray(t, np.float32)
            p = np.zeros((th, tw, 3), np.float32)
            p[: t.shape[0], : t.shape[1]] = t[..., :3]
            padded.append(p)
        tex = np.stack(padded)
    else:
        tex = np.zeros((1, 1, 1, 3), np.float32)

    return SceneData(
        positions=jnp.asarray(np.concatenate(pos_list)),
        faces=jnp.asarray(np.concatenate(face_list).astype(np.int32)),
        attrs={s: jnp.asarray(np.concatenate(lst)) for s, lst in attr_lists.items()},
        mesh_material=jnp.asarray(np.array(mesh_material, np.int32)),
        albedo=jnp.asarray(np.array([m.albedo for m in materials], np.float32)),
        texture_id=jnp.asarray(np.array([m.texture_id for m in materials], np.int32)),
        textures=jnp.asarray(tex),
        reflectivity=jnp.asarray(
            np.array([m.reflectivity for m in materials], np.float32)
        ),
    )


class Scene:
    """Host-side scene: mesh list + lazily (re)built acceleration structure.

    API parity with ``IScene`` (`Beam.h:56-63`): ``add_mesh``,
    ``remove_mesh``, ``update_gpu_scene``; plus ``march`` from the concrete
    scene classes (`SceneTree.cpp:109-127` etc.)."""

    def __init__(self, config: RenderConfig = DEFAULT_CONFIG):
        self.config = config
        self._meshes: list[Mesh] = []
        self.materials: list[Material] = [Material()]
        self.textures: list[np.ndarray] = []
        self._dirty = True  # m_mustUpdateMeshPtrs analog (`Scene.cpp:33`)
        self._data: Optional[SceneData] = None
        self._accel = None

    # -- IScene API -------------------------------------------------------

    @staticmethod
    def create(config: RenderConfig = DEFAULT_CONFIG) -> "Scene":
        """``IScene::create`` analog (`Scene.cpp:20-30`) — backend chosen by
        ``config.accel`` instead of a compile-time flag."""
        return Scene(config)

    def add_mesh(self, mesh: Mesh) -> None:
        self._meshes.append(mesh)
        self._dirty = True

    def remove_mesh(self, mesh: Mesh) -> None:
        """`Scene.cpp:43-56`."""
        for i, m in enumerate(self._meshes):
            if m is mesh:
                del self._meshes[i]
                break
        assert all(m is not mesh for m in self._meshes)
        self._dirty = True

    @property
    def meshes(self) -> list[Mesh]:
        return list(self._meshes)

    def data(self) -> SceneData:
        """Flattened arrays, rebuilt lazily on the dirty flag
        (``updateMeshPtrs``, `Scene.cpp:58-60`)."""
        if self._dirty or self._data is None:
            self._data = flatten_meshes(self._meshes, self.materials, self.textures)
            self._accel = None
            self._dirty = False
        return self._data

    def update_gpu_scene(self):
        """Build/rebuild the acceleration structure over the flattened scene
        (``updateGPUScene`` analog: `SceneTree.cpp:70-91` reset+insert;
        here a deterministic full rebuild of the configured structure)."""
        data = self.data()
        kind = self.config.accel
        if kind in (AccelKind.BVH, AccelKind.WAVEFRONT):
            from ..accel.bvh import build_bvh

            self._accel = build_bvh(data.positions, data.faces, self.config.bvh)
        elif kind == AccelKind.CLUSTER:
            from ..accel.clusters import build_clusters

            self._accel = build_clusters(data.positions, data.faces,
                                         self.config.cluster)
        elif kind == AccelKind.GRID:
            from ..accel.grid import build_grid

            self._accel = build_grid(data.positions, data.faces, self.config.grid)
        else:  # BRUTE: no structure
            self._accel = None
        return self._accel

    @property
    def accel(self):
        if self._accel is None and self.config.accel is not AccelKind.BRUTE:
            self.update_gpu_scene()
        return self._accel

    # -- tracing ----------------------------------------------------------

    def march(self, eye, orient, camera, render_target) -> int:
        """Trace the scene into ``render_target`` — the concrete scenes'
        ``march`` (`SceneTree.cpp:109-127`, `SceneHash.cpp:58-74`) including
        the base-class validation (`Scene.cpp:81-97`): a render target must
        exist and match the camera dimensions."""
        if render_target is None:
            return ERROR_NO_RENDER_TARGET
        if (
            render_target.width != camera.width
            or render_target.height != camera.height
        ):
            return ERROR_RT_CAM_MISMATCH

        from ..trace.pipeline import trace_to_buffer

        render_target.buffer = trace_to_buffer(
            self.data(),
            self.accel,
            camera.initial_rays,
            jnp.asarray(eye, jnp.float32),
            jnp.asarray(orient, jnp.float32),
            self.config,
            frame_hw=(camera.height, camera.width),
        )
        return ERROR_ALL_FINE
