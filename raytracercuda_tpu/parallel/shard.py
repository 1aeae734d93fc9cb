"""Sharded render and training steps over a device mesh.

Ray tiles shard across devices (``shard_map`` over the ``"rays"`` axis);
the flattened scene and the acceleration structure are replicated, so
traversal touches only local device memory and NO communication happens
in the forward pass.  The backward pass of the training step produces
per-shard parameter gradients which are all-reduced with ``psum`` — XLA
schedules the collective against the remaining backward computation
(the overlap BASELINE.json's north star asks for).

``shard_map`` (not plain jit-with-shardings) matters here: the traversal
``while_loop``'s termination test is a global ``any`` — under jit that
would force a cross-device collective every iteration, while under
shard_map each device loops only until ITS rays finish.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import RenderConfig
from ..diff.render_grad import render_rgb
from ..models.scene import SceneData
from .mesh import RAY_AXIS


def _spec_like(tree, spec):
    return jax.tree_util.tree_map(lambda _: spec, tree)


@partial(
    jax.jit,
    static_argnames=("config", "mesh", "shading", "with_shadows", "frame_hw"),
)
def render_sharded(
    scene: SceneData,
    accel,
    initial_rays: jnp.ndarray,
    eye: jnp.ndarray,
    orient: jnp.ndarray,
    config: RenderConfig,
    mesh: Mesh,
    shading: str = "lambert",
    with_shadows: bool = False,
    frame_hw: tuple[int, int] | None = None,
) -> jnp.ndarray:
    """Forward render with rays sharded over the mesh -> ``[R,3]`` RGB.

    ``initial_rays.shape[0]`` must divide by the mesh size (use
    ``parallel.mesh.pad_rays_for_mesh``).  When ``frame_hw`` is given,
    rays shard as horizontal PIXEL BANDS of the frame — each device's
    shard is itself a (H/n, W) sub-frame, so the tile-based fast paths
    (dense cluster trace / beam traversal) run per shard instead of
    falling back to per-ray traversal."""
    local_hw = None
    if frame_hw is not None:
        h, w = frame_hw
        n = mesh.devices.size
        assert h % n == 0, f"frame height {h} not divisible by {n} devices"
        local_hw = (h // n, w)

    def local_render(scene, accel, rays_shard, eye, orient):
        return render_rgb(
            scene, accel, rays_shard, eye, orient, config,
            shading=shading, with_shadows=with_shadows, frame_hw=local_hw,
        )

    return jax.shard_map(
        local_render,
        mesh=mesh,
        in_specs=(
            _spec_like(scene, P()),
            _spec_like(accel, P()),
            P(RAY_AXIS),
            P(),
            P(),
        ),
        out_specs=P(RAY_AXIS),
        # Traversal while_loop carries are initialized shard-uniform and
        # become ray-varying in the first iteration; skip strict varying-
        # manual-axes checking rather than pvary-annotating every carry.
        check_vma=False,
    )(scene, accel, initial_rays, eye, orient)


def make_train_step(config: RenderConfig, mesh: Mesh, optimizer=None,
                    shading: str = "lambert", with_shadows: bool = False,
                    frame_hw: tuple[int, int] | None = None):
    """Build a jitted distributed training step for inverse rendering.

    The returned ``step(params, opt_state, scene, accel, rays, eye,
    orient, target)`` returns ``(params, opt_state, loss)``.  ``params``
    is a pytree of differentiable scene parameters — by convention
    ``{"positions": [V,3]}`` plus optionally ``albedo``/``textures`` —
    grafted onto the (replicated) scene before rendering.  Gradients are
    ``psum``-reduced over the ray axis inside shard_map, so each device
    holds identical updated parameters afterwards.
    """
    import optax

    if optimizer is None:
        optimizer = optax.adam(1e-2)

    def graft(scene: SceneData, params) -> SceneData:
        rep = {}
        if "positions" in params:
            rep["positions"] = params["positions"]
        if "albedo" in params:
            rep["albedo"] = params["albedo"]
        if "textures" in params:
            rep["textures"] = params["textures"]
        if "normals" in params:
            rep["attrs"] = {**scene.attrs, 1: params["normals"]}
        return scene._replace(**rep)

    local_hw = None
    if frame_hw is not None:
        h, w = frame_hw
        assert h % mesh.devices.size == 0
        local_hw = (h // mesh.devices.size, w)

    def local_loss(params, scene, accel, rays_shard, eye, orient, target_shard):
        img = render_rgb(
            graft(scene, params), accel, rays_shard, eye, orient, config,
            shading=shading, with_shadows=with_shadows, frame_hw=local_hw,
        )
        # Mean over ALL rays: scale local sum by the global count.
        n_total = rays_shard.shape[0] * mesh.devices.size
        return jnp.sum((img - target_shard) ** 2) / (n_total * 3)

    def local_step(params, opt_state, scene, accel, rays_shard, eye, orient, target_shard):
        loss, grads = jax.value_and_grad(local_loss)(
            params, scene, accel, rays_shard, eye, orient, target_shard
        )
        # Gradient all-reduce (`psum`), overlapped by XLA with the rest of
        # backward — the analog the reference never had.
        grads = jax.lax.psum(grads, RAY_AXIS)
        loss = jax.lax.psum(loss, RAY_AXIS)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    @partial(jax.jit, static_argnames=())
    def step(params, opt_state, scene, accel, rays, eye, orient, target):
        return jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(
                _spec_like(params, P()),
                _spec_like(opt_state, P()),
                _spec_like(scene, P()),
                _spec_like(accel, P()),
                P(RAY_AXIS),
                P(),
                P(),
                P(RAY_AXIS),
            ),
            out_specs=(
                _spec_like(params, P()),
                _spec_like(opt_state, P()),
                P(),
            ),
            check_vma=False,
        )(params, opt_state, scene, accel, rays, eye, orient, target)

    return step, optimizer


@partial(
    jax.jit,
    static_argnames=("config", "mesh", "height", "width", "num_bounces",
                     "with_shadows"),
)
def render_bounces_sharded(
    cs,
    scene: SceneData,
    eye: jnp.ndarray,
    dirs: jnp.ndarray,
    height: int,
    width: int,
    config: RenderConfig,
    mesh: Mesh,
    num_bounces: int = 2,
    light_dir=(0.4, 0.8, -0.45),
    with_shadows: bool = True,
    background=(0.0, 1.0, 0.0),
) -> jnp.ndarray:
    """Multi-bounce pinhole frame with rays sharded as pixel bands.

    BASELINE config #5's shape: every bounce (primary dense trace,
    shadow pass, per-bounce compaction and re-dispatch) runs per shard
    with the scene+accel replicated — bounce rays scatter arbitrarily, so
    keeping them on their home device costs no communication at all, while
    re-sharding them by direction would.  Reference precedent for the
    re-dispatch loop: the wavefront queues of `Trace2.cu:69-176`.
    """
    from ..trace.bounce import render_bounces

    n = mesh.devices.size
    assert height % n == 0, f"frame height {height} not divisible by {n}"
    local_h = height // n

    def local(cs, scene, eye, dirs_shard):
        return render_bounces(
            cs, scene, eye, dirs_shard, local_h, width, config,
            num_bounces=num_bounces, light_dir=light_dir,
            with_shadows=with_shadows, background=background)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(_spec_like(cs, P()), _spec_like(scene, P()), P(),
                  P(RAY_AXIS)),
        out_specs=P(RAY_AXIS),
        check_vma=False,
    )(cs, scene, eye, dirs)


@partial(
    jax.jit,
    static_argnames=("width", "height", "config", "mesh", "shading",
                     "with_shadows", "zoom"),
)
def progressive_step_sharded(
    state,
    scene: SceneData,
    accel,
    eye: jnp.ndarray,
    orient: jnp.ndarray,
    width: int,
    height: int,
    config: RenderConfig,
    mesh: Mesh,
    shading: str = "lambert",
    with_shadows: bool = False,
    zoom: float = 1.0,
):
    """One sharded progressive-accumulation step (pixel-band DP).

    Per-shard accumulation order is fixed (each band only ever adds its
    own samples), so results stay BIT-IDENTICAL to the single-device
    `progressive_step` — the reproducibility SceneProgressive's streaming
    design needed (`SceneProgressive.cpp:27-77`, SURVEY §7 hard part 5).
    """
    from ..trace.progressive import (ProgressiveState, halton,
                                     jittered_ray_grid)

    sample = state.count
    jx = halton(sample + 1, 2)
    jy = halton(sample + 1, 3)
    rays = jittered_ray_grid(width, height, jx, jy, zoom=zoom)
    n = mesh.devices.size
    assert height % n == 0
    local_h = height // n

    def local(scene, accel, rays_shard, eye, orient, accum_shard):
        rgb = render_rgb(
            scene, accel, rays_shard, eye, orient, config,
            shading=shading, with_shadows=with_shadows,
            frame_hw=(local_h, width))
        return accum_shard + rgb

    accum = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(_spec_like(scene, P()), _spec_like(accel, P()),
                  P(RAY_AXIS), P(), P(), P(RAY_AXIS)),
        out_specs=P(RAY_AXIS),
        check_vma=False,
    )(scene, accel, rays, eye, orient, state.accum)
    return ProgressiveState(accum=accum, count=state.count + 1)
