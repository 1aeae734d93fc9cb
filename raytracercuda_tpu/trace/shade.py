"""Shading: composable JAX functions over SoA hit records.

The reference's extension point for shading is a device function pointer,
``bmHitCallback`` (`Raytracer/SharedTypes.h:37`), e.g. the app-side normal
shader ``bmShadeNormal`` (`TestProgram/Program.cpp:64-70`).  The JAX
form of the same extension point is an ordinary JAX function taking the
scene and a ``Hit`` record — composable, jittable, differentiable.

``shade_normal_packed`` reproduces the reference's built-in shading
bit-for-bit (`BuildTree.cu:486-496`, `Hash.cu:291-301`): interpolated
normal, red channel ``|n.z|*255`` truncated, miss = ``255<<8``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..models.mesh import VERTEX_DATA_NORMAL, VERTEX_DATA_UV1
from ..models.scene import SceneData
from ..ops.interpolate import face_interpolate
from ..ops.math import normalize, pack_rgb_vec
from ..types import Hit

#: Background value 255<<8 (`BuildTree.cu:495`).
import numpy as _np

MISS_COLOR_PACKED = _np.uint32(255 << 8)


def interpolate_slot(scene: SceneData, hit: Hit, slot: int) -> jnp.ndarray:
    attr = scene.attrs[slot]
    return face_interpolate(attr, scene.faces, hit.face, hit.u, hit.v)


def shade_normal_packed(scene: SceneData, hit: Hit) -> jnp.ndarray:
    """Bit-parity normal shading -> packed u32 framebuffer values.

    `BuildTree.cu:486-496`: ``buffer[i] = (u32)abs(n.z*255) << 16`` on hit
    (C cast truncates toward zero), ``255<<8`` on miss.
    """
    n = interpolate_slot(scene, hit, VERTEX_DATA_NORMAL)
    n = normalize(n, eps=1e-30)
    red = jnp.abs(n[..., 2] * 255.0).astype(jnp.uint32) << 16
    return jnp.where(hit.hit_mask, red, MISS_COLOR_PACKED)


def shade_normal_rgb(scene: SceneData, hit: Hit, background=(0.0, 1.0, 0.0)):
    """Float-RGB variant of the parity shading (differentiable)."""
    n = interpolate_slot(scene, hit, VERTEX_DATA_NORMAL)
    n = normalize(n, eps=1e-30)
    r = jnp.abs(n[..., 2])
    rgb = jnp.stack([r, jnp.zeros_like(r), jnp.zeros_like(r)], axis=-1)
    bg = jnp.asarray(background, jnp.float32)
    return jnp.where(hit.hit_mask[..., None], rgb, bg)


def sample_texture(textures: jnp.ndarray, tex_id, u, v) -> jnp.ndarray:
    """Bilinear texture fetch from the ``[T,H,W,3]`` atlas.

    The reference stores a texture id per material (`SharedTypes.h:20-23`)
    but never samples it in a kernel; texturing is a new, differentiable
    capability (BASELINE config #4 requires texture gradients).
    """
    t, h, w = textures.shape[0], textures.shape[1], textures.shape[2]
    # Wrap addressing.
    fu = (u % 1.0) * (w - 1)
    fv = (v % 1.0) * (h - 1)
    x0 = jnp.floor(fu).astype(jnp.int32)
    y0 = jnp.floor(fv).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, w - 1)
    y1 = jnp.minimum(y0 + 1, h - 1)
    ax = (fu - x0)[..., None]
    ay = (fv - y0)[..., None]
    tid = jnp.clip(tex_id, 0, t - 1)
    c00 = textures[tid, y0, x0]
    c01 = textures[tid, y0, x1]
    c10 = textures[tid, y1, x0]
    c11 = textures[tid, y1, x1]
    top = c00 * (1 - ax) + c01 * ax
    bot = c10 * (1 - ax) + c11 * ax
    return top * (1 - ay) + bot * ay


def material_albedo(scene: SceneData, hit: Hit) -> jnp.ndarray:
    """Per-hit base color: material albedo, modulated by its texture when
    one is assigned."""
    mesh_id = scene.faces[jnp.maximum(hit.face, 0), 3]
    mat_id = scene.mesh_material[mesh_id]
    albedo = scene.albedo[mat_id]
    tex_id = scene.texture_id[mat_id]
    if VERTEX_DATA_UV1 in scene.attrs:
        uv = interpolate_slot(scene, hit, VERTEX_DATA_UV1)
        tex_rgb = sample_texture(scene.textures, tex_id, uv[..., 0], uv[..., 1])
        albedo = jnp.where((tex_id >= 0)[..., None], albedo * tex_rgb, albedo)
    return albedo


class FaceTables(NamedTuple):
    """Per-face shading rows — the gather-once fast path for shading.

    ``face_interpolate`` needs a two-level scattered gather per pixel
    (face row, then 3 vertex attributes) plus the material-id chain;
    this table folds all of it into ONE row per face so shading a pixel
    is a single scattered fetch.  Built once per scene (static normals),
    so it must NOT be used when differentiating through vertex
    attributes — the diff path (`diff/render_grad.py`) keeps the
    two-level gathers, which is what makes gradients flow to
    ``scene.attrs``.

    ``rows``: ``[F, 13(+6)]`` = n0|n1|n2 (9) | albedo (3) | tex_id (1)
    | optionally uv0|uv1|uv2 (6).  UV presence is encoded in the (static)
    row width so the tuple jits cleanly.
    """

    rows: jnp.ndarray

    @property
    def has_uv(self) -> bool:
        return self.rows.shape[1] >= 19


@jax.jit
def _face_table_rows(scene: SceneData) -> jnp.ndarray:
    f = scene.faces
    n = scene.attrs[VERTEX_DATA_NORMAL]
    cols = [n[f[:, 0]], n[f[:, 1]], n[f[:, 2]]]
    mat = scene.mesh_material[f[:, 3]]
    cols.append(scene.albedo[mat])
    cols.append(scene.texture_id[mat].astype(jnp.float32)[:, None])
    if VERTEX_DATA_UV1 in scene.attrs:
        uv = scene.attrs[VERTEX_DATA_UV1]
        cols += [uv[f[:, 0], :2], uv[f[:, 1], :2], uv[f[:, 2], :2]]
    return jnp.concatenate(cols, axis=1)


def build_face_tables(scene: SceneData) -> FaceTables:
    """Precompute per-face shading rows (once per scene update)."""
    return FaceTables(rows=_face_table_rows(scene))


def shade_lambert_rgb(
    scene: SceneData,
    hit: Hit,
    ray_origin: jnp.ndarray,
    ray_dir: jnp.ndarray,
    light_dir=(0.4, 0.8, -0.45),
    shadow_mask: jnp.ndarray | None = None,
    ambient: float = 0.08,
    background=(0.0, 1.0, 0.0),
    tables: Optional[FaceTables] = None,
) -> jnp.ndarray:
    """Lambert N·L shading with optional shadow attenuation (BASELINE
    config #3: "Lambert shading + shadow rays").

    ``tables``: optional precomputed ``FaceTables`` — one scattered gather
    per pixel instead of the generic attribute-interpolation chain.  Only
    for non-differentiating callers (see ``FaceTables``)."""
    if tables is not None:
        row = tables.rows[jnp.maximum(hit.face, 0)]
        w = 1.0 - (hit.u + hit.v)
        n = (row[:, 0:3] * w[:, None] + row[:, 3:6] * hit.u[:, None]
             + row[:, 6:9] * hit.v[:, None])
        albedo = row[:, 9:12]
        tex_id = row[:, 12].astype(jnp.int32)
        if tables.has_uv:
            uv = (row[:, 13:15] * w[:, None] + row[:, 15:17] * hit.u[:, None]
                  + row[:, 17:19] * hit.v[:, None])
            tex_rgb = sample_texture(scene.textures, tex_id, uv[:, 0], uv[:, 1])
            albedo = jnp.where((tex_id >= 0)[:, None], albedo * tex_rgb, albedo)
        n = normalize(n, eps=1e-30)
        flip = jnp.sum(n * ray_dir, axis=-1) > 0.0
        n = jnp.where(flip[..., None], -n, n)
        l = normalize(jnp.asarray(light_dir, jnp.float32))
        ndotl = jnp.maximum(jnp.sum(n * l, axis=-1), 0.0)
        if shadow_mask is not None:
            ndotl = jnp.where(shadow_mask, 0.0, ndotl)
        rgb = albedo * (ambient + (1.0 - ambient) * ndotl)[..., None]
        bg = jnp.asarray(background, jnp.float32)
        return jnp.where(hit.hit_mask[..., None], rgb, bg)

    n = interpolate_slot(scene, hit, VERTEX_DATA_NORMAL)
    n = normalize(n, eps=1e-30)
    # Face the normal against the incoming ray.
    flip = jnp.sum(n * ray_dir, axis=-1) > 0.0
    n = jnp.where(flip[..., None], -n, n)
    l = normalize(jnp.asarray(light_dir, jnp.float32))
    ndotl = jnp.maximum(jnp.sum(n * l, axis=-1), 0.0)
    if shadow_mask is not None:
        ndotl = jnp.where(shadow_mask, 0.0, ndotl)
    albedo = material_albedo(scene, hit)
    rgb = albedo * (ambient + (1.0 - ambient) * ndotl)[..., None]
    bg = jnp.asarray(background, jnp.float32)
    return jnp.where(hit.hit_mask[..., None], rgb, bg)


def pack_shaded(rgb: jnp.ndarray) -> jnp.ndarray:
    """Float RGB -> packed u32 framebuffer (`CudaComon.cuh:85-98`)."""
    return pack_rgb_vec(rgb)
