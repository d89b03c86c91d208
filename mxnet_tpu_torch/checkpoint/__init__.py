"""Asynchronous, preemption-safe checkpoints (reference:
``mxnet_tpu/checkpoint/``).

    import mxnet_tpu_torch as mx
    mgr = mx.checkpoint.CheckpointManager("/ckpt", keep_last_n=3)
    mod.fit(train, num_epoch=90, checkpoint_manager=mgr)  # resumes itself
    mx.checkpoint.latest_checkpoint("/ckpt")              # discovery
    engine.reload_from("/ckpt", poll_interval=30)         # serving follows

* ``layout``  — step directories, the atomic commit, discovery, retention
* ``state``   — params, optimizer and RNG capture (device clones behind a
  CUDA event) and restore
* ``manager`` — ``CheckpointManager``: the writer thread, retention,
  resume, the preemption hook

The directories and ``params.nd`` are the JAX package's format, so either
package restores the other's params, and the port resumes a fit the JAX
package checkpointed. ``kvshard`` (the ``dist_async`` server shards) is
not yet ported (ROADMAP A7 part 2).
"""
from . import layout
from . import state
from .layout import (latest_checkpoint, latest_step, list_checkpoints,
                     read_meta)
from .manager import CheckpointManager, SaveHandle, RestoredCheckpoint
from .state import TrainingState


def load_params(path):
    """(arg_params, aux_params) of a committed checkpoint directory, on
    the CPU: the serving tier's ``reload_from`` reads this."""
    return state.load_params_files(path)


__all__ = ["CheckpointManager", "SaveHandle", "RestoredCheckpoint",
           "TrainingState", "latest_checkpoint", "latest_step",
           "list_checkpoints", "read_meta", "load_params", "layout",
           "state"]
