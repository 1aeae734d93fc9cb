"""Device-mesh helpers for ray-tile sharding.

The reference is single-process/single-GPU (`cudaSetDevice(count-1)`,
`TestProgram/Program.cpp:121-124`) — it has no distribution layer at all.
This module is the distribution layer mandated by BASELINE.json: rays
shard over the devices of a ``jax.sharding.Mesh`` axis named ``"rays"``
(the data-parallel axis of a ray tracer); scene + BVH are replicated.
Multi-host initialization goes through ``jax.distributed``.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

RAY_AXIS = "rays"


def make_ray_mesh(num_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh over all (or the first N) devices, axis ``"rays"``."""
    if devices is None:
        devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.array(devices), (RAY_AXIS,))


def ray_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for ``[R, ...]`` ray-major arrays: leading dim over devices."""
    return NamedSharding(mesh, P(RAY_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_rays_for_mesh(rays, mesh: Mesh):
    """Pad the leading (ray) dim to a multiple of the mesh size.

    Returns (padded_rays, original_count)."""
    n = mesh.devices.size
    r = rays.shape[0]
    rem = (-r) % n
    if rem:
        import jax.numpy as jnp

        pad = [(0, rem)] + [(0, 0)] * (rays.ndim - 1)
        rays = jnp.pad(rays, pad)
    return rays, r


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Multi-host bring-up (`jax.distributed.initialize`).

    Returns True when a multi-process runtime came up.  A deliberate no-op
    (returning False) ONLY when no multi-process launch is configured —
    neither explicit arguments nor the standard env (JAX_COORDINATOR_ADDRESS)
    are present.  A CONFIGURED launch that fails to
    initialize raises: silently falling back to single-process after a real
    multi-host failure would corrupt results (each host would render the
    full frame)."""
    import os

    configured = (
        coordinator_address is not None
        or os.environ.get("JAX_COORDINATOR_ADDRESS")
        or os.environ.get("COORDINATOR_ADDRESS")
    )
    if not configured:
        return False
    if jax.distributed.is_initialized():
        return True
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # racing init: treat 'already initialized' as up
        if "already initialized" not in str(e):
            raise
    return True
