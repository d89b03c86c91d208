"""Fused train step of the symbolic stack, on one device.

Counterpart of ``mxnet_tpu/parallel/tpu_step.py`` ``DataParallelTrainStep``
(L24-661): a Symbol's forward, backward and optimizer update in one call,
what ``Module.fit(kvstore='tpu_sync')`` hands its work to. The JAX step
compiles this into one XLA program; the port runs it eagerly: the graph
interpreter ``executor.run_graph`` (shared with ``Executor``) under
``torch.autograd``, seeds of ones at the outputs, then the update.

- ``mesh`` (a ``parallel.mesh.Mesh`` or a list of devices) whose entries
  all name one physical device, e.g. ``[gpu(0), gpu(0)]``: the step runs
  the whole batch there, which is the whole-batch math of the reference's
  partitioned program (BatchNorm over the whole batch); the update is the
  one #7 launch over every float32 leaf, the single-device counterpart of
  ``fused_update_mesh``. Each batch input's axis 0 must divide by the
  mesh's size, as the reference's batch sharding requires (ValueError).

- The update is the reference's prologue (rescale -> elementwise clip ->
  + wd * weight) and ``apply_update``, or with ``fused_optupdate`` (or
  ``MXNET_TPU_FUSED_OPTUPDATE=1``) the fused kernel #7
  (``kernels/opt_update.py``, CUDA on the card): one launch per eligible
  leaf, bitwise equal to the unfused path.
- Params, optimizer slots and BatchNorm aux states live on the device and
  are updated IN PLACE each step (the analog of buffer donation); no
  autograd graph outlives the backward. The aux states are views of one
  flat buffer per dtype, written with one ``cat`` and one copy a step.
- ``lr`` lives in a float32 0-d device tensor, refilled each call without
  a host sync; the kernels read it through a pointer, so a new lr changes
  no launch argument and no signature.
- The step body goes through ``compile.ProgramBuilder`` under the site
  ``train.fused_step``: one signature for a fixed batch shape.
- ``init`` draws He-normal weights, zero biases and betas, unit gammas and
  a unit ``moving_var`` (as L152-177 does) from a ``torch.Generator``; the
  values differ from JAX's RNG, so parity runs go through ``init_from``.
- ``compute_dtype`` (``"bfloat16"`` or ``"float16"``, a torch or numpy
  dtype; L72-80, L293-360): the reference's mixed precision. Params stay
  float32 masters; each step casts them, and the floating data inputs,
  to the compute dtype before the forward and backward, never the labels
  (ResNet-50's 1000 class indices do not fit bf16's significand).
  Gradients reach the masters through the cast as float32, so the
  prologue and the update (#7's one launch over every float32 leaf) run
  as without it; the outputs and the activations are in the compute
  dtype; BatchNorm's updated running statistics go back to float32.
- ``supervise=True`` (L41-50, L296-443): the step takes a loss scale, a
  float32 0-d device tensor refilled each call as ``lr`` is (``scale=``,
  default 1.0; a NaN scale is just another value). The backward's seeds
  are the scale in each output's dtype, the gradients are unscaled by
  ``1 / scale`` (multi-tensor), and the step's verdict, a 0-d bool tensor
  on the device (``last_flag``), is every floating output finite and the
  float32 sum of squares of the unscaled gradients finite (the reference's
  reduction: each leaf's sum, then their sum). A bad step leaves params,
  slots and BatchNorm statistics with their bits: the fused update hands
  the verdict to kernel #7, which then writes nothing; the unfused update
  carries each leaf with ``torch.where`` (``apply_update(verdict=)``); the
  flat running statistics take one ``torch.where`` in place of the copy.
  At scale 1.0 every bit is the unsupervised step's, and
  ``supervise=False`` computes exactly the unsupervised step.
- ``warmup(batch_dtypes)`` / ``abstract_step_args`` (L503-547): the
  step's argument signature as ``device="meta"`` tensors, registered with
  the ``ProgramBuilder`` ahead of time (the first batch then counts no
  on-demand program), and kernel #7's library built and loaded when the
  update is fused on the card. It runs no step and changes no state.

- A graph with stochastic ops (Dropout, rrelu, the sampling ops) draws
  from one ``torch.Generator`` on the device, seeded each call with
  ``random.step_seed()``: ``numpy.random.randint(0, 2**31)``, as the
  reference draws its step key (L605-610), also for a supervised step
  that turns out bad. A fit from one ``numpy.random.seed`` draws the same
  masks bit for bit. ``rng`` (an int) seeds the step's generator instead.
  A graph without them draws nothing from numpy.

Not yet ported, and raising: a mesh over several physical devices,
``zero`` and ``comm_plan`` (ROADMAP A7 part 3) and the lint hooks of
``MXNET_TPU_LINT`` (ROADMAP A9, analysis/). ``shard_update`` on one
device is the no-op it is in the JAX package, and ``sharding_config``
has nothing to shard: both are accepted and ignored.
"""
from __future__ import annotations

import math

import numpy as _np
import torch

from ..base import MXNetError, env_flag
from ..compile.builder import ProgramBuilder
from ..context import resolve_device
from ..executor import GraphPlan, run_graph
from ..kernels import opt_update as _opt_update
from ..kernels.opt_update import fused_update_step
from ..ops.elemwise import torch_dtype
from ..ops.nn import loss_grad_scale_scope
from ..random import step_seed
from .mesh import mesh_devices, one_physical_device
from .optim_update import (apply_update, grad_prologue, init_opt_state,
                           tree_map)

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

    ``mesh`` is None or a mesh of one physical device (which is used
    when ``device`` is not given); ``device`` defaults to ``cuda:0`` and
    raises without CUDA. Each call takes a batch (dict name -> numpy array or
    tensor) and returns the outputs; params, slots and aux states update
    in place."""

    def __init__(self, symbol, mesh=None, lr=0.01, momentum=0.0, wd=0.0,
                 data_names=("data",), label_names=("softmax_label",),
                 sharding_config=None, rescale_grad=None, optimizer="sgd",
                 opt_hp=None, fixed_param_names=(), clip_gradient=None,
                 compute_dtype=None, shard_update=None,
                 fused_optupdate=None, zero=None, supervise=False,
                 device=None):
        self.mesh_size = 1
        if mesh is not None:
            devices = mesh_devices(mesh)
            one = one_physical_device(devices,
                                      "DataParallelTrainStep(mesh=)")
            if device is None:
                device = one
            elif one_physical_device([resolve_device(device)],
                                     "device") != one:
                raise MXNetError("DataParallelTrainStep: device %s is not "
                                 "the mesh's %s" % (device, one))
            self.mesh_size = len(devices)
        if zero:
            raise MXNetError("DataParallelTrainStep(zero=True): ZeRO is not "
                             "yet ported (distribution, ROADMAP A7 part 3)")
        if env_flag("MXNET_TPU_LINT"):
            raise MXNetError("MXNET_TPU_LINT: the train step's lint hooks are "
                             "not yet ported (ROADMAP A9, analysis/)")
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
        # mixed precision: float32 masters, the graph in compute_dtype
        self.compute_dtype = (None if compute_dtype is None
                              else torch_dtype(compute_dtype))
        if fused_optupdate is None:
            fused_optupdate = env_flag("MXNET_TPU_FUSED_OPTUPDATE")
        self.fused_optupdate = bool(fused_optupdate)
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.param_names = [n for n in self.arg_names
                            if n not in self.data_names + self.label_names]
        self._rescale = rescale_grad
        # supervised numeric containment: a loss-scale argument, the
        # scaled seeds, the unscale, and a device verdict that carries
        # params, slots and BatchNorm statistics through a bad step
        self.supervise = bool(supervise)
        self.last_flag = None
        self._step = None
        self._lr_t = None
        self._scale_t = None
        self._needs_rng = symbol._needs_rng()
        self._gen = None

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

    def _check_batch(self, shapes):
        """Each batch input's axis 0 splits evenly over the mesh, as the
        reference's batch sharding requires."""
        for name, shape in shapes:
            if shape and shape[0] % self.mesh_size:
                raise ValueError(
                    "batch input %r of shape %s: axis 0 must be divisible "
                    "by the mesh's %d devices" % (name, tuple(shape),
                                                  self.mesh_size))

    def _build_step(self, batch_shapes):
        self._check_batch(batch_shapes.items())
        self._plan = GraphPlan(self.symbol)
        batch_size = list(batch_shapes.values())[0][0]
        self._rescale_value = (self._rescale if self._rescale is not None
                               else 1.0 / batch_size)
        self._batch_shapes = {k: tuple(v) for k, v in batch_shapes.items()}
        self._lr_t = torch.zeros((), dtype=torch.float32, device=self.device)
        self._aux_flat = []
        self._flatten_aux()
        if self.supervise:
            self._scale_t = torch.ones((), dtype=torch.float32,
                                       device=self.device)
        if self._needs_rng:
            self._gen = torch.Generator(self.device)
        self._step = ProgramBuilder(self._body, site="train.fused_step",
                                    donate_argnums=(0, 1))

    @torch.no_grad()
    def _flatten_aux(self):
        """The aux states as views of one flat buffer per dtype, so a
        step writes them all with one ``cat`` and one copy (supervised,
        one ``torch.where``)."""
        groups = {}
        for n in self.aux_names:
            groups.setdefault(self.aux[n].dtype, []).append(n)
        for dtype, names in groups.items():
            flat = torch.empty(sum(self.aux[n].numel() for n in names),
                               dtype=dtype, device=self.device)
            off = 0
            for n in names:
                t = self.aux[n]
                view = flat[off:off + t.numel()].view(t.shape)
                view.copy_(t)
                self.aux[n] = view
                off += t.numel()
            self._aux_flat.append((flat, names))

    def _verdict(self, outs, grads):
        """Every floating output finite and the float32 sum of squares of
        the gradients finite, as a 0-d bool on the device: each leaf's
        squared norm (one multi-tensor launch), then their sum."""
        good = torch.ones((), dtype=torch.bool, device=self.device)
        for o in outs:
            if o.is_floating_point():
                good &= torch.isfinite(o).all()
        gs = [g if g.dtype == torch.float32 else g.float() for g in grads]
        if gs:
            gsq = torch.stack(torch._foreach_norm(gs)).square().sum()
            good &= torch.isfinite(gsq)
        return good

    def _body(self, params, opt_state, aux, batch, lr, scale=None):
        leaves = [params[n] for n in self.param_names]
        cdt = self.compute_dtype
        if cdt is None:
            args = {**params, **batch}
        else:
            # never the labels: class indices past 256 do not fit bf16
            args = {n: (v.to(cdt) if n in self.data_names
                        and v.is_floating_point() else v)
                    for n, v in batch.items()}
            args.update((n, p.to(cdt)) for n, p in params.items())
        with loss_grad_scale_scope(scale):
            outs, aux_upd = run_graph(self._plan, args, aux, True,
                                      rng=self._gen)
            live = [o for o in outs if o.requires_grad]
            if scale is None:
                seeds = [torch.ones_like(o) for o in live]
            else:
                # the loss-scaled backward: the seed IS the scale (a power
                # of two: scale 1.0 is the unscaled seed bit for bit); the
                # loss heads take it multiplicatively (ops/nn.py _LossOp),
                # an implicit loss site through loss_grad_scale_scope
                seeds = [torch.empty_like(o).copy_(scale.to(o.dtype))
                         for o in live]
            grads = torch.autograd.grad(live, leaves, seeds,
                                        allow_unused=True,
                                        materialize_grads=True)
        with torch.no_grad():
            good = None
            if scale is not None:
                # g * (1 / scale) in g's dtype, as the reference's
                # g * inv.astype(g.dtype): one multi-tensor launch
                grads = torch._foreach_mul(list(grads), 1.0 / scale)
                good = self._verdict(outs, grads)
            grads = dict(zip(self.param_names, grads))
            # a fixed param updates its slots, never itself
            target = {n: (p.detach().clone() if n in self.fixed_param_names
                          else p) for n, p in params.items()}
            hp = dict(self.opt_hp, lr=lr)
            kw = dict(rescale=self._rescale_value, clip=self.clip_gradient,
                      wd=self.wd)
            if self.fused_optupdate:
                # kernel #7 reads the verdict: a bad step writes nothing
                fused_update_step(self.optimizer, hp, target, opt_state,
                                  grads, verdict=good, **kw)
            else:
                apply_update(self.optimizer, hp, target, opt_state,
                             grad_prologue(target, grads, **kw),
                             verdict=good)
            # the running statistics stay in their dtype (float32 under
            # a 16-bit compute dtype)
            for flat, names in self._aux_flat:
                new = torch.cat([aux_upd.get(n, aux[n]).reshape(-1)
                                 .to(flat.dtype) for n in names])
                if good is None:
                    flat.copy_(new)
                else:
                    torch.where(good, new, flat, out=flat)
        outs = tuple(o.detach() for o in outs)
        return outs if good is None else (outs, good)

    def __call__(self, batch, rng=None, lr=None, scale=None):
        """One step on a batch (dict name -> numpy array or tensor; a
        tensor already on the device goes in without a copy); returns the
        outputs. A graph with stochastic ops seeds its generator with
        ``rng`` (an int) or, by default, ``random.step_seed()``.
        Supervised, ``scale`` (default 1.0) is the loss scale and
        ``last_flag`` holds the step's device verdict."""
        if self._step is None:
            raise MXNetError("call init() first")
        if self._gen is not None:
            # drawn before the step, as the reference's key: a step the
            # supervisor skips has drawn it too
            self._gen.manual_seed(step_seed() if rng is None else int(rng))
        batch = {n: torch.as_tensor(x).to(self.device, non_blocking=True)
                 for n, x in batch.items() if n in self.arg_names}
        if self.mesh_size > 1:
            self._check_batch((n, t.shape) for n, t in batch.items())
        self._lr_t.fill_(self.lr if lr is None else lr)
        if not self.supervise:
            return self._step(self.params, self.opt_state, self.aux, batch,
                              self._lr_t)
        self._scale_t.fill_(1.0 if scale is None else scale)
        outs, self.last_flag = self._step(self.params, self.opt_state,
                                          self.aux, batch, self._lr_t,
                                          self._scale_t)
        return outs

    def program_count(self):
        """Distinct shape signatures the step has run (1 for a fixed batch
        shape)."""
        return 0 if self._step is None else self._step.program_count()

    def abstract_step_args(self, batch_dtypes=None):
        """The step's argument signature as ``device="meta"`` tensors:
        params, optimizer state and aux states as they are, the batch at
        its build shapes in ``batch_dtypes`` (name -> dtype; default
        float32, the ``NDArrayIter`` contract), lr, and the loss scale when
        supervised: what :meth:`warmup` registers."""
        if self._step is None:
            raise MXNetError("call init() first")
        dts = {k: torch_dtype(v) for k, v in (batch_dtypes or {}).items()}

        def meta(x):
            return None if x is None else torch.empty(
                tuple(x.shape), dtype=x.dtype, device="meta")

        batch = {n: torch.empty(s, dtype=dts.get(n, torch.float32),
                                device="meta")
                 for n, s in self._batch_shapes.items()
                 if n in self.arg_names}
        args = (tree_map(meta, self.params), tree_map(meta, self.opt_state),
                tree_map(meta, self.aux), batch, meta(self._lr_t))
        if self.supervise:
            args = args + (meta(self._scale_t),)
        return args

    def warmup(self, batch_dtypes=None):
        """Register the step's signature ahead of the first batch (the
        builder's ``aot`` count; that batch then adds no on-demand
        program) and, when the update is fused on the card, build and
        load kernel #7's library. Runs no step and changes no state.
        Returns self."""
        args = self.abstract_step_args(batch_dtypes)
        if self.fused_optupdate and self.device.type == "cuda":
            kind = _opt_update._kind(self.optimizer,
                                     self.opt_state.get("mom"))
            _opt_update._entry(_opt_update._ENTRY[kind])
        self._step.aot_info(*args, mode="aot")
        return self

    comm_plan = _not_ported("comm_plan", "A7 part 3")
