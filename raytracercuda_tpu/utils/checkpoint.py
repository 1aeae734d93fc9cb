"""Checkpoint/resume for inverse-rendering runs and progressive frames.

The reference has no persistence at all — every run rebuilds all state
(`SceneTree::updateGPUScene` per frame, nothing survives the process,
SURVEY.md §5 "Checkpoint/resume: none").  A production framework
needs it for two long-running workloads this package ships:

  * **inverse rendering** (`parallel/shard.make_train_step`): optimizer
    params + opt_state + step counter, saved every N steps so a
    preempted pod slice resumes where it left off;
  * **progressive accumulation** (`trace/progressive.py`): the running
    radiance accumulator + sample index, so a long converging frame
    survives restarts bit-identically (the accumulation order is fixed,
    so resume == uninterrupted).

Built on orbax (`StandardCheckpointer` under a `CheckpointManager`), the
standard JAX checkpoint layer: async-capable, atomic directory commits,
retention policies, and — on a multi-host mesh — per-host sharded
save/restore of distributed arrays.  State is any pytree of jax/numpy
arrays plus scalar metadata.
"""

from __future__ import annotations

import os
from typing import Any

import jax


def _manager(directory: str, max_to_keep: int | None = 3):
    import orbax.checkpoint as ocp

    return ocp.CheckpointManager(
        os.path.abspath(directory),
        options=ocp.CheckpointManagerOptions(
            max_to_keep=max_to_keep, create=True),
    )


class CheckpointStore:
    """Thin orbax wrapper bound to one checkpoint directory.

    ``save(step, state)`` / ``restore(state_like)`` where ``state`` is a
    pytree (dict of params/opt_state/accumulators).  ``restore`` needs an
    abstract or concrete example of the tree for sharding/dtype recovery;
    pass the freshly-initialized state you would otherwise start from.
    """

    def __init__(self, directory: str, max_to_keep: int | None = 3):
        self._mgr = _manager(directory, max_to_keep)

    def save(self, step: int, state: Any, *, force: bool = False) -> bool:
        import orbax.checkpoint as ocp

        ok = self._mgr.save(step, args=ocp.args.StandardSave(state),
                            force=force)
        self._mgr.wait_until_finished()
        return bool(ok)

    def latest_step(self) -> int | None:
        return self._mgr.latest_step()

    def restore(self, state_like: Any, step: int | None = None) -> Any:
        """Restore ``step`` (default: latest) shaped/sharded like
        ``state_like``.  Returns None when the directory has no steps."""
        import orbax.checkpoint as ocp

        if step is None:
            step = self._mgr.latest_step()
        if step is None:
            return None
        abstract = jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=getattr(x, "sharding", None))
            if hasattr(x, "shape") else x,
            state_like,
        )
        return self._mgr.restore(step,
                                 args=ocp.args.StandardRestore(abstract))

    def close(self) -> None:
        self._mgr.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def save_train_state(directory: str, step: int, params, opt_state,
                     **extra) -> bool:
    """One-call save of an inverse-rendering run's state."""
    with CheckpointStore(directory) as store:
        return store.save(step, {"params": params, "opt_state": opt_state,
                                 **extra})


def restore_train_state(directory: str, params, opt_state, **extra):
    """One-call resume: returns ``(step, state_dict)`` or ``(None, None)``
    when no checkpoint exists.  ``params``/``opt_state`` are the
    freshly-initialized trees used as the restore template."""
    with CheckpointStore(directory) as store:
        step = store.latest_step()
        if step is None:
            return None, None
        state = store.restore({"params": params, "opt_state": opt_state,
                               **extra}, step=step)
        return step, state
