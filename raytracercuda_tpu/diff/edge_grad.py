"""Silhouette (coverage) gradients via deterministic edge sampling.

`diff/render_grad.py`'s stop-grad/recompute VJPs are exact for INTERIOR
pixels only: pixel coverage is a step function of the geometry, and the
true derivative of a pixel-footprint-AVERAGED image carries a boundary
(edge) integral those VJPs do not model.  This module supplies that
boundary term — the reference has no gradients at all (this is the
BASELINE.json north-star capability, not reference parity).

Estimator (the boundary-integral form used by edge-sampling
differentiable renderers): for the box-filtered pixel

    I_p = (1/A) \\int_p L(x) dx ,

moving silhouette edges contribute

    dI_p/dtheta = (1/A) \\int_{edges \\cap p} (L_in - L_out)
                                           (n_hat . dx/dtheta) dl ,

where ``x`` is the edge point in screen space, ``n_hat`` the screen
normal pointing away from the occluding triangle, and ``L_in``/``L_out``
the radiance just inside/outside the edge.  We estimate the integral
with K deterministic stratified samples per silhouette edge; the two
radiances come from auxiliary pinhole rays offset ``+-delta`` along
``n_hat`` (values only — no gradients flow through them), and the whole
per-sample coefficient contracts against the upstream cotangent of its
pixel.  The only differentiated function is the PROJECTION of the edge
endpoints to screen space — one `jax.vjp` carries the boundary term to
vertex positions, the eye, and the orientation in a single pullback.

Shape discipline: the edge table ([E,2] vertex ids, [E,2] adjacent
faces) is static host-side data from the topology; every per-step array
is a fixed [E] / [E,K] plane — no data-dependent shapes, no host
round-trips inside jit.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.lax import Precision

from ..config import RenderConfig
from ..models.scene import SceneData
from ..trace.pipeline import trace_hit
from ..types import FLT_MAX


# ---------------------------------------------------------------------------
# Static topology: undirected edge table with adjacent faces.
# ---------------------------------------------------------------------------


def build_edge_table(faces) -> tuple[np.ndarray, np.ndarray]:
    """``[E,2]`` vertex ids + ``[E,2]`` adjacent face ids (-1 = boundary).

    Host-side numpy; static per topology (vertex POSITIONS may change
    freely between steps, indices may not).  Non-manifold edges (>2
    adjacent faces) keep their first two faces.
    """
    F = np.asarray(faces)[:, :3]
    e = np.stack([F[:, [0, 1]], F[:, [1, 2]], F[:, [2, 0]]], axis=1)
    e = e.reshape(-1, 2)  # [3F, 2], row i//3 = owning face
    owner = np.repeat(np.arange(F.shape[0], dtype=np.int32), 3)
    e_sorted = np.sort(e, axis=1)
    uniq, inv = np.unique(e_sorted, axis=0, return_inverse=True)
    E = uniq.shape[0]
    edge_faces = np.full((E, 2), -1, np.int32)
    order = np.argsort(inv, kind="stable")
    sinv = inv[order]
    first = np.searchsorted(sinv, np.arange(E), "left")
    last = np.searchsorted(sinv, np.arange(E), "right")
    edge_faces[:, 0] = owner[order[first]]
    has2 = (last - first) > 1
    edge_faces[has2, 1] = owner[order[np.minimum(first + 1, len(order) - 1)]][has2]
    return uniq.astype(np.int32), edge_faces


# ---------------------------------------------------------------------------
# Screen projection (the ONLY differentiated geometry path).
# ---------------------------------------------------------------------------


def project_screen(p: jnp.ndarray, eye: jnp.ndarray, orient: jnp.ndarray,
                   zoom: float) -> tuple[jnp.ndarray, jnp.ndarray]:
    """World points ``[N,3]`` -> screen ``[N,2]`` (gx, gy) + camera depth.

    Inverts the pinhole grid of `models/camera.camera_ray_grid`: a world
    direction ``orient @ (gx, gy, zoom)`` reaches ``p``, so with camera
    coords ``q = orient^T (p - eye)``: ``gx = zoom q_x / q_z``."""
    # rows: orient^T (p - eye)
    q = jnp.matmul(p - eye[None, :], orient, precision=Precision.HIGHEST)
    z = q[:, 2]
    safe = jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
    return jnp.stack([zoom * q[:, 0] / safe, zoom * q[:, 1] / safe],
                     axis=-1), z


# ---------------------------------------------------------------------------
# The boundary cotangent.
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("config", "width", "height", "zoom",
                                   "num_samples", "offset_px", "shading",
                                   "light_dir"))
def boundary_vjp(
    g: jnp.ndarray,
    scene: SceneData,
    accel,
    edge_vids: jnp.ndarray,
    edge_faces: jnp.ndarray,
    eye: jnp.ndarray,
    orient: jnp.ndarray,
    config: RenderConfig,
    width: int,
    height: int,
    zoom: float = 1.0,
    num_samples: int = 4,
    offset_px: float = 0.05,
    shading: str = "lambert",
    light_dir=(0.4, 0.8, -0.45),
):
    """Pull the upstream image cotangent ``g [H*W,3]`` back through the
    silhouette boundary integral -> ``(d_positions, d_eye, d_orient)``.

    All inputs to the radiance probes are stop-gradded; gradients flow
    only through the screen projection of the edge endpoints."""
    from ..trace.shade import shade_lambert_rgb
    from .render_grad import _stop_grad_scene, recompute_hit

    sg = _stop_grad_scene(scene)
    accel_sg = jax.tree_util.tree_map(jax.lax.stop_gradient, accel)
    E = edge_vids.shape[0]
    K = num_samples
    # Screen-space pixel geometry (camera_ray_grid conventions:
    # left=-1, right=1, top=1, bottom=-1; centers at half-pixel offsets).
    dx = 2.0 / width
    dy = -2.0 / height
    area = abs(dx * dy)

    # --- silhouette classification (values only) -------------------------
    pos = sg.positions
    f = sg.faces[:, :3]
    v0, v1, v2 = pos[f[:, 0]], pos[f[:, 1]], pos[f[:, 2]]
    fnorm = jnp.cross(v1 - v0, v2 - v0)
    fcent = (v0 + v1 + v2) / 3.0
    front = jnp.sum(fnorm * (fcent - eye[None, :]), axis=-1) < 0.0  # [F]
    ff = jnp.where(edge_faces >= 0, front[jnp.maximum(edge_faces, 0)], False)
    has2 = edge_faces[:, 1] >= 0
    # The tracer is TWO-SIDED (no backface culling — `ops/math.py`'s
    # no-det-cull contract), so a boundary edge is a silhouette whatever
    # its winding; interior edges are silhouettes when their two faces
    # face opposite ways relative to the eye.
    silhouette = jnp.where(has2, ff[:, 0] != ff[:, 1], True)  # [E]
    # The face whose interior is the "in" side: prefer the front-facing
    # adjacent face; a back-facing boundary edge keeps its only face.
    vis_face = jnp.where(has2 & ~ff[:, 0] & ff[:, 1], edge_faces[:, 1],
                         edge_faces[:, 0])

    # --- differentiable projection of edge endpoints ---------------------
    def endpoints(positions, eye_, orient_):
        pa, _ = project_screen(positions[edge_vids[:, 0]], eye_, orient_, zoom)
        pb, _ = project_screen(positions[edge_vids[:, 1]], eye_, orient_, zoom)
        return pa, pb

    (a, b), pull = jax.vjp(endpoints, scene.positions, eye, orient)
    a = jax.lax.stop_gradient(a)
    b = jax.lax.stop_gradient(b)
    _, za = project_screen(pos[edge_vids[:, 0]], eye, orient, zoom)
    _, zb = project_screen(pos[edge_vids[:, 1]], eye, orient, zoom)
    in_front = (za > 1e-6) & (zb > 1e-6)

    # Screen normal: perpendicular to the edge, pointing AWAY from the
    # visible face's third vertex (the outside of the occluder).
    ev = b - a  # [E,2]
    elen = jnp.sqrt(jnp.maximum(jnp.sum(ev * ev, axis=-1), 1e-30))
    ehat = ev / elen[:, None]
    nhat = jnp.stack([ehat[:, 1], -ehat[:, 0]], axis=-1)
    fsum = f[vis_face, 0] + f[vis_face, 1] + f[vis_face, 2]
    third = fsum - edge_vids[:, 0] - edge_vids[:, 1]  # the non-edge vertex
    cproj, _ = project_screen(pos[third], eye, orient, zoom)
    inward = jnp.sum(nhat * (cproj - (a + b) * 0.5), axis=-1) > 0.0
    nhat = jnp.where(inward[:, None], -nhat, nhat)

    # --- K stratified samples per edge -----------------------------------
    tau = (jnp.arange(K, dtype=jnp.float32) + 0.5) / K  # [K]
    x = a[:, None, :] + tau[None, :, None] * ev[:, None, :]  # [E,K,2]

    # Pixel lookup (pixel j covers gx in [left + dx j, left + dx (j+1))).
    px = jnp.floor((x[..., 0] + 1.0) / dx).astype(jnp.int32)
    py = jnp.floor((x[..., 1] - 1.0) / dy).astype(jnp.int32)
    in_frame = (px >= 0) & (px < width) & (py >= 0) & (py < height)
    pix = jnp.clip(py, 0, height - 1) * width + jnp.clip(px, 0, width - 1)

    # --- radiance just inside / outside (values only) --------------------
    delta = offset_px * min(abs(dx), abs(dy))
    probes = jnp.stack([x - delta * nhat[:, None, :],
                        x + delta * nhat[:, None, :]], axis=0)  # [2,E,K,2]
    pr = probes.reshape(-1, 2)
    pdirs = jnp.concatenate(
        [pr, jnp.full((pr.shape[0], 1), float(zoom), jnp.float32)], axis=-1)
    pdirs = pdirs / jnp.linalg.norm(pdirs, axis=-1, keepdims=True)
    porig = jnp.broadcast_to(eye[None, :], pdirs.shape)
    hit = trace_hit(sg, accel_sg, porig, pdirs, config)
    h = recompute_hit(sg, hit.face, porig, pdirs)
    if shading == "normal":
        from ..trace.shade import shade_normal_rgb

        L = shade_normal_rgb(sg, h, background=(0.0, 1.0, 0.0))
    else:
        L = shade_lambert_rgb(sg, h, porig, pdirs, light_dir=light_dir)
    L = L.reshape(2, E, K, 3)
    L_in, L_out = L[0], L[1]
    # Attribution: this edge owns the discontinuity only when the in-side
    # probe actually sees one of its adjacent faces (otherwise another
    # surface occludes the edge here and its motion cannot change the
    # pixel).
    hf = hit.face.reshape(2, E, K)
    owns = (hf[0] == edge_faces[:, 0:1]) | (
        (hf[0] == edge_faces[:, 1:2]) & (edge_faces[:, 1:2] >= 0))

    # --- per-sample coefficient and pullback ------------------------------
    gpix = g[pix.reshape(-1)].reshape(E, K, 3)
    coeff = jnp.sum(gpix * (L_in - L_out), axis=-1)  # [E,K]
    valid = (silhouette & in_front)[:, None] & in_frame & owns
    coeff = jnp.where(valid, coeff, 0.0) * (elen / (K * area))[:, None]

    # dx/dtheta = (1-tau) da/dtheta + tau db/dtheta; contract with
    # coeff * nhat.
    ca = jnp.sum(coeff * (1.0 - tau)[None, :], axis=1)[:, None] * nhat
    cb = jnp.sum(coeff * tau[None, :], axis=1)[:, None] * nhat
    d_pos, d_eye, d_orient = pull((ca, cb))
    return d_pos, d_eye, d_orient
