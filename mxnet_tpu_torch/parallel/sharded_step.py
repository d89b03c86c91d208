"""Single-device train step: loss -> grads -> global-norm clip -> update.

Counterpart of ``mxnet_tpu/parallel/sharded_step.py`` ``ShardedTrainStep``
with ``mesh=None``: forward, backward and the optimizer update run
eagerly on one device (``cuda:0`` unless given ``device``). The mesh
shardings and ZeRO (``shard_update``/``zero``) are not yet ported and
raise. ``fused_optupdate`` (or ``MXNET_TPU_FUSED_OPTUPDATE=1``) routes
the update through the fused kernel #7 (``kernels/opt_update.py``) as the
JAX step does on one device (``fused_update_mesh`` -> ``fused_update_step``
with rescale 1, no clip and wd 0, since the step has already clipped and
added ``wd * param``); the port walks the tree's leaves, so the nested
transformer params work.

Params and optimizer slots live on the device and are updated IN PLACE
each step (the eager analog of the jitted step's buffer donation), in
jnp's dtype promotion: a bf16 or float16 model's params and Adam slots
leave the first Adam step as float32 (SGD with momentum keeps the
model's dtype), as the JAX step returns them (its float32
``corr`` and clip scale promote them), and are rebound in ``params`` and
``opt_state`` (``optim_update.apply_update``). The port's transformer
forward computes in its config's dtype whatever its params' (the JAX
forward's layer scan raises on the float32 params there, ROADMAP C). The
step body goes through ``compile.ProgramBuilder`` under the site
``train.sharded_step``: its ``program_count()`` is the number of distinct
shape signatures it ran, 1 for a fixed batch shape.
"""
from __future__ import annotations

import torch

from ..base import MXNetError, env_flag
from ..compile.builder import ProgramBuilder
from ..context import resolve_device
from ..kernels.opt_update import fused_update_step
from .optim_update import (_jnp_cast, apply_update, init_opt_state,
                           tree_leaves, tree_map)

__all__ = ["ShardedTrainStep"]


def _to_tensor(x, device):
    return torch.as_tensor(x).to(device, non_blocking=True)


class ShardedTrainStep:
    """loss -> grads -> optimizer on one device.

    Parameters
    ----------
    loss_fn : callable(params, batch) -> scalar loss tensor
        ``batch`` is a dict of tensors on the step's device.
    mesh : None
        A mesh raises: distribution is not yet ported (ROADMAP A7).
    optimizer : 'adam' | 'sgd' (``momentum`` 0 for plain SGD)
    grad_clip : float or None
        Global-norm clip: grads scale by ``min(1, clip / (norm + 1e-6))``.
    wd : float
        Added to the grads as ``wd * param`` after the clip.
    skip_nonfinite : bool
        A step whose loss or global grad norm is not finite leaves params
        and slots as they were; ``last_good`` holds the device bool of the
        last step's verdict (no host sync). With ``fused_optupdate`` the
        verdict goes to kernel #7, which then writes nothing (no copy of
        the state); the unfused update carries each leaf with
        ``torch.where`` from a copy taken before it.
    fused_optupdate : bool, default ``MXNET_TPU_FUSED_OPTUPDATE``
        The update through kernel #7 (bitwise equal on the card).
    device : torch.device or str, default ``cuda:0``
        Raises ``MXNetError`` without CUDA unless given ``"cpu"``.
    """

    def __init__(self, loss_fn, mesh=None, optimizer="adam", lr=1e-3,
                 momentum=0.9, wd=0.0,
                 beta1=0.9, beta2=0.999, eps=1e-8, grad_clip=None,
                 shard_update=None, zero=None, skip_nonfinite=False,
                 fused_optupdate=None, device=None):
        if mesh is not None:
            raise MXNetError("ShardedTrainStep(mesh=...): distribution is not "
                             "yet ported (ROADMAP A7); pass mesh=None")
        if shard_update or zero:
            # as the JAX constructor does without a 'dp' axis of size > 1
            raise MXNetError("%s=True needs a 'dp' mesh axis of size > 1; "
                             "the port's step runs on one device"
                             % ("zero" if zero else "shard_update"))
        if fused_optupdate is None:
            fused_optupdate = env_flag("MXNET_TPU_FUSED_OPTUPDATE")
        self.fused_optupdate = bool(fused_optupdate)
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.skip_nonfinite = bool(skip_nonfinite)
        self.last_good = None
        self.optimizer = optimizer
        self.hp = dict(lr=lr, momentum=momentum, wd=wd, beta1=beta1,
                       beta2=beta2, eps=eps, grad_clip=grad_clip)
        self._step_fn = None
        self.step_count = 0

    def init(self, params):
        """Copy params (tensors or numpy arrays, nested dicts) onto the
        device as leaves that require grad; allocate optimizer state."""
        if self.optimizer not in ("adam", "sgd"):
            raise MXNetError("unknown optimizer %r" % self.optimizer)
        self.params = tree_map(
            lambda x: _to_tensor(x, self.device).detach().clone()
            .requires_grad_(True), params)
        self.opt_state = init_opt_state(self.optimizer, self.params,
                                        momentum=self.hp["momentum"])
        self._step_fn = ProgramBuilder(self._step, site="train.sharded_step",
                                       donate_argnums=(0, 1))
        return self

    def _step(self, params, opt_state, batch):
        hp = self.hp
        leaves = tree_leaves(params)
        loss = self.loss_fn(params, batch)
        # a param the loss does not use gets a zero gradient, as in JAX
        grads = list(torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True))
        loss = loss.detach()
        with torch.no_grad():
            good = None
            if self.skip_nonfinite:
                gsq = sum((g.float() ** 2).sum() for g in grads)
                good = torch.isfinite(loss) & torch.isfinite(gsq)
            if hp["grad_clip"]:
                gnorm = torch.sqrt(sum((g.float() ** 2).sum()
                                       for g in grads))
                scale = torch.clamp(hp["grad_clip"] / (gnorm + 1e-6),
                                    max=1.0)
                grads = [_jnp_cast(g, scale) * scale for g in grads]
            if hp["wd"]:
                grads = [g + hp["wd"] * p for g, p in zip(grads, leaves)]
            it = iter(grads)
            update = fused_update_step if self.fused_optupdate \
                else apply_update
            update(self.optimizer, hp, params, opt_state,
                   tree_map(lambda _: next(it), params), verdict=good)
            if self.skip_nonfinite:
                return loss, good
        return loss

    def __call__(self, batch):
        """One step on a batch (a dict of numpy arrays or tensors);
        returns the loss as a 0-d tensor on the device."""
        if self._step_fn is None:
            raise MXNetError("call init() first")
        batch = {k: _to_tensor(x, self.device) for k, x in batch.items()}
        out = self._step_fn(self.params, self.opt_state, batch)
        if self.skip_nonfinite:
            loss, self.last_good = out
        else:
            loss = out
        self.step_count += 1
        return loss

    def program_count(self):
        """Distinct shape signatures the step has run (1 for a fixed
        batch shape)."""
        return 0 if self._step_fn is None else self._step_fn.program_count()
