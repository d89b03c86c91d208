"""Training steps and their pieces, the process group's collectives
(``collectives``) and device meshes (``mesh``); steps sharded over several
devices are ROADMAP A7 part 3."""
from . import collectives, mesh
from .mesh_kernels import kernel_tier_mode, resolve_kernel_tier
from .optim_update import apply_update, grad_prologue, init_opt_state
from .sharded_step import ShardedTrainStep
from .tpu_step import DataParallelTrainStep

__all__ = ["ShardedTrainStep", "DataParallelTrainStep", "init_opt_state",
           "apply_update", "grad_prologue", "resolve_kernel_tier",
           "kernel_tier_mode", "collectives", "mesh"]
