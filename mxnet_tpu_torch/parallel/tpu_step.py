"""Fused train step of the symbolic stack, on one device.

Counterpart of ``mxnet_tpu/parallel/tpu_step.py`` ``DataParallelTrainStep``
(L24-661) on a one-device mesh: a Symbol's forward, backward and optimizer
update in one call, what ``Module.fit(kvstore='tpu_sync')`` hands its
work to. The JAX step compiles this into one XLA program; the port runs
it eagerly: the graph interpreter ``executor.run_graph`` (shared with
``Executor``) under ``torch.autograd``, seeds of ones at the outputs, then
the update.

- The update is the reference's prologue (rescale -> elementwise clip ->
  + wd * weight) and ``apply_update``, or with ``fused_optupdate`` (or
  ``MXNET_TPU_FUSED_OPTUPDATE=1``) the fused kernel #7
  (``kernels/opt_update.py``, CUDA on the card): one launch per eligible
  leaf, bitwise equal to the unfused path.
- Params, optimizer slots and BatchNorm aux states live on the device and
  are updated IN PLACE each step (the analog of buffer donation); no
  autograd graph outlives the backward.
- ``lr`` lives in a float32 0-d device tensor, refilled each call without
  a host sync; the kernels read it through a pointer, so a new lr changes
  no launch argument and no signature.
- The step body goes through ``compile.ProgramBuilder`` under the site
  ``train.fused_step``: one signature for a fixed batch shape.
- ``init`` draws He-normal weights, zero biases and betas, unit gammas and
  a unit ``moving_var`` (as L152-177 does) from a ``torch.Generator``; the
  values differ from JAX's RNG, so parity runs go through ``init_from``.

Not yet ported, and raising: a mesh of more than one device and ``zero``
(distribution, ROADMAP A10), ``compute_dtype`` (bf16 compute with fp32
masters, ROADMAP A7), ``supervise`` (ROADMAP A11), ``warmup`` /
``abstract_step_args`` / ``comm_plan`` (ROADMAP A9), the lint hooks of
``MXNET_TPU_LINT`` (ROADMAP A12),
and graphs with stochastic ops. ``shard_update`` on one device is the
no-op it is in the JAX package, and ``sharding_config`` has nothing to
shard: both are accepted and ignored.
"""
from __future__ import annotations

import math

import numpy as _np
import torch

from ..base import MXNetError, env_flag
from ..compile.builder import ProgramBuilder
from ..context import resolve_device
from ..executor import GraphPlan, run_graph
from ..kernels.opt_update import fused_update_step
from ..ops.elemwise import torch_dtype
from .optim_update import apply_update, grad_prologue, init_opt_state

__all__ = ["DataParallelTrainStep"]


def _not_ported(name, item):
    def method(self, *args, **kwargs):
        raise MXNetError("DataParallelTrainStep.%s is not yet ported "
                         "(ROADMAP %s)" % (name, item))
    method.__name__ = name
    return method


def _tensor(x, device):
    """NDArray / numpy / tensor -> a fresh tensor on ``device``."""
    if hasattr(x, "_data"):
        x = x._data
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(_np.ascontiguousarray(_np.asarray(x)))
    return x.detach().to(device).clone()


class DataParallelTrainStep:
    """A Symbol's forward + backward + optimizer update on one device.

    ``mesh`` is None or a one-device list (whose device is used when
    ``device`` is not given); ``device`` defaults to ``cuda:0`` and raises
    without CUDA. Each call takes a batch (dict name -> numpy array or
    tensor) and returns the outputs; params, slots and aux states update
    in place."""

    def __init__(self, symbol, mesh=None, lr=0.01, momentum=0.0, wd=0.0,
                 data_names=("data",), label_names=("softmax_label",),
                 sharding_config=None, rescale_grad=None, optimizer="sgd",
                 opt_hp=None, fixed_param_names=(), clip_gradient=None,
                 compute_dtype=None, shard_update=None,
                 fused_optupdate=None, zero=None, supervise=False,
                 device=None):
        if mesh is not None:
            devices = list(mesh) if isinstance(mesh, (list, tuple)) else None
            if devices is None or len(devices) != 1:
                raise MXNetError("DataParallelTrainStep(mesh=...): "
                                 "distribution is not yet ported (ROADMAP "
                                 "A10); pass mesh=None or one device")
            if device is None:
                device = devices[0]
        if zero:
            raise MXNetError("DataParallelTrainStep(zero=True): ZeRO is not "
                             "yet ported (distribution, ROADMAP A10)")
        if compute_dtype is not None:
            raise MXNetError("DataParallelTrainStep(compute_dtype=...): "
                             "low-precision compute with fp32 masters is not "
                             "yet ported (ROADMAP A7)")
        if supervise:
            raise MXNetError("DataParallelTrainStep(supervise=True) is not "
                             "yet ported (ROADMAP A11)")
        if env_flag("MXNET_TPU_LINT"):
            raise MXNetError("MXNET_TPU_LINT: the train step's lint hooks are "
                             "not yet ported (ROADMAP A12, analysis/)")
        if symbol._needs_rng():
            raise MXNetError("DataParallelTrainStep: graphs with stochastic "
                             "ops are not yet ported (ROADMAP A3)")
        if optimizer not in ("sgd", "adam"):
            raise MXNetError("unknown optimizer %r" % optimizer)
        self.device = resolve_device(device)
        self.symbol = symbol
        self.lr = lr
        self.wd = wd
        self.data_names = list(data_names)
        self.label_names = list(label_names)
        self.optimizer = optimizer
        # static hyperparameters (momentum / beta1 / beta2 / eps)
        self.opt_hp = dict(opt_hp or {})
        if optimizer == "sgd":
            self.opt_hp.setdefault("momentum", momentum)
        else:
            for k, v in (("beta1", 0.9), ("beta2", 0.999), ("eps", 1e-8)):
                self.opt_hp.setdefault(k, v)
        self.fixed_param_names = frozenset(fixed_param_names or ())
        self.clip_gradient = clip_gradient
        if fused_optupdate is None:
            fused_optupdate = env_flag("MXNET_TPU_FUSED_OPTUPDATE")
        self.fused_optupdate = bool(fused_optupdate)
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.param_names = [n for n in self.arg_names
                            if n not in self.data_names + self.label_names]
        self._rescale = rescale_grad
        self._step = None
        self._lr_t = None

    # ------------------------------------------------------------------
    def init(self, batch_shapes, dtype=_np.float32, seed=0):
        """Infer shapes, initialize params and aux states (He-normal from
        a ``torch.Generator`` seeded with ``seed``) and opt state, build
        the step."""
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**batch_shapes)
        shapes = dict(zip(self.arg_names, arg_shapes))
        gen = torch.Generator().manual_seed(int(seed))
        tdt = torch_dtype(dtype)
        params = {}
        for name in self.param_names:
            shape = tuple(shapes[name])
            if name.endswith("_gamma"):
                init = torch.ones(shape, dtype=tdt)
            elif name.endswith("_bias") or name.endswith("_beta"):
                init = torch.zeros(shape, dtype=tdt)
            else:
                fan_in = math.prod(shape[1:]) if len(shape) > 1 else shape[0]
                init = torch.randn(shape, generator=gen, dtype=tdt) \
                    * math.sqrt(2.0 / max(fan_in, 1))
            params[name] = init
        aux = {name: (torch.ones if "var" in name else torch.zeros)(
            tuple(s), dtype=tdt)
            for name, s in zip(self.aux_names, aux_shapes)}
        return self.init_from(params, aux, batch_shapes)

    def init_from(self, arg_params, aux_params, batch_shapes):
        """Adopt existing values (dict name -> NDArray / numpy / tensor),
        copied onto the device."""
        self.params = {n: _tensor(arg_params[n], self.device)
                       .requires_grad_(True) for n in self.param_names}
        self.aux = {n: _tensor(aux_params[n], self.device)
                    for n in self.aux_names}
        self.opt_state = init_opt_state(
            self.optimizer, self.params,
            momentum=self.opt_hp.get("momentum", 0.0))
        self._build_step(batch_shapes)
        return self

    @torch.no_grad()
    def reload_params(self, arg_params, aux_params):
        """Overwrite param and aux values in place, keeping the optimizer
        state and the step."""
        for src, dst in ((arg_params, self.params), (aux_params, self.aux)):
            for n, t in dst.items():
                t.copy_(_tensor(src[n], self.device))

    def export_params(self):
        """Current (params, aux) as numpy dicts (a host sync point)."""
        return ({n: v.detach().cpu().numpy() for n, v in self.params.items()},
                {n: v.detach().cpu().numpy() for n, v in self.aux.items()})

    def _build_step(self, batch_shapes):
        self._plan = GraphPlan(self.symbol)
        batch_size = list(batch_shapes.values())[0][0]
        self._rescale_value = (self._rescale if self._rescale is not None
                               else 1.0 / batch_size)
        self._lr_t = torch.zeros((), dtype=torch.float32, device=self.device)
        self._step = ProgramBuilder(self._body, site="train.fused_step",
                                    donate_argnums=(0, 1))

    def _body(self, params, opt_state, aux, batch, lr):
        outs, aux_upd = run_graph(self._plan, {**params, **batch}, aux, True)
        leaves = [params[n] for n in self.param_names]
        grads = torch.autograd.grad(
            [o for o in outs if o.requires_grad], leaves,
            [torch.ones_like(o) for o in outs if o.requires_grad],
            allow_unused=True, materialize_grads=True)
        with torch.no_grad():
            grads = dict(zip(self.param_names, grads))
            # a fixed param updates its slots, never itself
            target = {n: (p.detach().clone() if n in self.fixed_param_names
                          else p) for n, p in params.items()}
            hp = dict(self.opt_hp, lr=lr)
            kw = dict(rescale=self._rescale_value, clip=self.clip_gradient,
                      wd=self.wd)
            if self.fused_optupdate:
                fused_update_step(self.optimizer, hp, target, opt_state,
                                  grads, **kw)
            else:
                apply_update(self.optimizer, hp, target, opt_state,
                             grad_prologue(target, grads, **kw))
            for name, val in aux_upd.items():
                if val is not aux[name]:
                    aux[name].copy_(val)
        return tuple(o.detach() for o in outs)

    def __call__(self, batch, rng=None, lr=None):
        """One step on a batch (dict name -> numpy array or tensor);
        returns the outputs. ``rng`` is accepted for API parity (no ported
        op draws randomness)."""
        if self._step is None:
            raise MXNetError("call init() first")
        batch = {n: torch.as_tensor(x).to(self.device, non_blocking=True)
                 for n, x in batch.items() if n in self.arg_names}
        self._lr_t.fill_(self.lr if lr is None else lr)
        return self._step(self.params, self.opt_state, self.aux, batch,
                          self._lr_t)

    def program_count(self):
        """Distinct shape signatures the step has run (1 for a fixed batch
        shape)."""
        return 0 if self._step is None else self._step.program_count()

    warmup = _not_ported("warmup", "A9")
    abstract_step_args = _not_ported("abstract_step_args", "A9")
    comm_plan = _not_ported("comm_plan", "A9")
