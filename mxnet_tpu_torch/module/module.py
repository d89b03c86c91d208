"""Module of the port (reference: ``mxnet_tpu/module/module.py`` L20-919).

``Module(symbol, context=...)`` binds the symbol on one device through
its executor group and trains it with ``fit``. ``context`` None is the
card (``cuda:0``), and raises without CUDA; ``mx.cpu()`` runs on the CPU.
A ``Module`` computes in float32, as the reference does: it turns off
torch's TF32 matmuls and convolutions (``context.pin_float32``;
``MXNET_ALLOW_TF32=1`` opts in to TF32).

``init_optimizer`` picks the update path as the reference does:
- a ``tpu_sync`` kvstore (or its type name), or ``device`` over several
  contexts, builds the fused step,
  ``parallel.DataParallelTrainStep`` on the module's device: each
  training ``forward`` is one step (forward, backward and the SGD or Adam
  update, through kernel #7 under ``MXNET_TPU_FUSED_OPTUPDATE=1``), fed the
  optimizer's scheduled lr; ``backward`` and ``update`` are no-ops, and
  the step's params are copied into the executor group before anything
  reads them there (``score``, ``predict``, ``get_params``). An optimizer
  with ``multi_precision=True``, or ``MXNET_FUSED_COMPUTE_DTYPE``, gives
  the step a compute dtype (bf16 with float32 masters); a value that is no
  dtype logs a warning and the step runs in float32.
- any other kvstore pushes each gradient and pulls each weight through
  the store's ``Updater``, and no kvstore runs the module's own
  ``Updater`` on each parameter (``optimizer.SGD``/``Adam``).
Up to ``MXNET_ASYNC_DISPATCH_DEPTH`` (2) fused steps stay queued on the
card; the host waits for the oldest one beyond that (a CUDA event per
step), and that wait is the one place a supervised fit reads a step's
verdict.

On the fused path (reference L361-590, L811-830):
- ``fit`` wraps the train iterator in an ``io.DevicePrefetchIter`` that
  stages the next batch on the step's device from pinned host buffers on
  a side stream while the current step runs (``MXNET_DEVICE_PREFETCH=0``
  opts out, ``MXNET_DEVICE_PREFETCH_DEPTH`` sizes it, default 2); a staged
  batch goes to the step without a second copy.
- Under a ``resilience.TrainingSupervisor`` (``fit(supervisor=...)`` or
  ``MXNET_TPU_TRAIN_SUPERVISE=1``) the step is built with
  ``supervise=True``: each dispatch passes the supervisor's loss scale,
  the step's device verdict rides the in-flight queue (on the card, copied
  to pinned host memory behind the step's event), and the retire point
  hands it to ``supervisor.await_ready``; every epoch ends by retiring
  every step in flight. A module built by an unsupervised fit is rebuilt
  (with a warning) when a supervisor arrives.
- ``MXNET_TPU_TRAIN_AOT`` (default 1) calls the step's ``warmup`` at
  build: the step's signature is registered before the first batch and
  kernel #7's library is built and loaded.

``predict`` routes through a ``serving.InferenceEngine`` (reference
L682-745): the bound batch size is its one bucket, so on the card an
inference batch replays one captured CUDA graph and a final partial batch
is padded into it. The route is taken on the reference's conditions (one
context, no state names, no monitor, no input gradients, a batch-major
layout, ``MXNET_SERVING_PREDICT`` not 0, and no inference forward already
run on the executors); otherwise ``predict`` runs the executors. Unlike
the reference, an error of the engine (a capture or a launch) raises; it
never falls back. ``install_monitor`` (L877) hooks a ``monitor.Monitor``
on the executors and turns the fused step off, as the reference does.

``save_optimizer_states`` writes ``checkpoint/state.py``'s tagged payload
(the fused step's slots, or the updater's, with the optimizer's schedule
counters) from device clones; ``load_optimizer_states`` and
``Module.load(..., load_optimizer_states=True)`` (applied by
``init_optimizer``) read it back, also from the JAX package's files.

``context`` may be a list: contexts may repeat (``[mx.gpu(0),
mx.gpu(0)]``, as in MXNet), and the executor group splits each batch
over them (``work_load_list``), one executor per slice. The update path
follows the reference (L302-303, L361-411): a ``tpu_sync`` store, or
``device`` over several contexts, builds the fused step over the
contexts' mesh (the whole batch on their one device); it is not built
when ``compression_params`` asks for compression (the store's push
compresses), when the process group has several processes
(``dist_sync`` pushes each gradient through the store's ``Updater``, with
``rescale_grad`` 1 / (batch x num_workers)), or when the batch does not
divide over the contexts (a warning). ``group2ctxs`` that keeps every
group on its context's device is accepted and places nothing.

Not yet ported, and raising: contexts on several physical devices in one
process (ROADMAP A7 part 3) and row-sparse parameters (ROADMAP A9).
"""
from __future__ import annotations

import collections
import logging
import time

import numpy as _np
import torch

from .. import profiler as _prof
from ..base import MXNetError, atomic_write, env_flag, get_env
from ..context import pin_float32
from ..initializer import Uniform, InitDesc
from .. import optimizer as opt_mod
from ..model import (_create_kvstore, _initialize_kvstore,
                     _update_params_on_kvstore, _update_params,
                     load_checkpoint)
from ..io import DataDesc
from ..ndarray.ndarray import NDArray
from ..ops.elemwise import torch_dtype
from ..parallel import collectives
from ..parallel.mesh import (data_parallel_mesh, mesh_devices,
                             one_physical_device)
from ..resilience import faults as _faults
from .base_module import BaseModule, _check_input_names
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]


def _not_ported(what, item):
    raise MXNetError("%s is not yet ported (ROADMAP %s)" % (what, item))


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        if context is None or isinstance(context, (str, torch.device)):
            context = [context]
        self._context = mesh_devices(list(context))
        if len(self._context) > 1:
            # contexts may repeat ([gpu(0), gpu(0)]); contexts on several
            # physical devices raise (ROADMAP A7 part 3)
            one_physical_device(self._context, "Module(context=...)")
        pin_float32()
        self._work_load_list = work_load_list or [1] * len(self._context)

        self._symbol = symbol
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        arg_names = symbol.list_arguments()
        input_names = data_names + label_names + (state_names or [])
        self._param_names = [x for x in arg_names if x not in input_names]
        self._fixed_param_names = fixed_param_names or []
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._state_names = state_names or []
        self._output_names = symbol.list_outputs()

        _check_input_names(symbol, data_names, "data", True)
        _check_input_names(symbol, label_names, "label", False)
        _check_input_names(symbol, self._state_names, "state", True)
        _check_input_names(symbol, self._fixed_param_names, "fixed_param",
                           True)
        attrs = symbol.attr_dict()
        if any(attrs.get(n, {}).get("__storage_type__") == "row_sparse"
               for n in self._param_names):
            _not_ported("Module with row_sparse parameters", "A9")

        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._compression_params = compression_params
        self._group2ctxs = group2ctxs
        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = None
        self._updater = None
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None
        # the fused tpu_sync step: one call per iteration instead of the
        # per-param push/pull
        self._fused_step = None
        self._fused_outputs = None
        self._fused_active = False
        self._fused_dirty = False   # fused params newer than exec_group's
        # bounded dispatch: (event or None, verdict or None) per queued
        # fused step
        self._inflight = collections.deque()
        self._dispatch_depth = 2
        self._fused_step_count = 0
        self._monitor = None
        self._serving_engine = None
        self._preload_opt_states = None

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module of ``prefix``'s checkpoint; with
        ``load_optimizer_states``, ``init_optimizer`` reads
        ``prefix-%04d.states``."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        from ..model import save_checkpoint
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))
        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, self.symbol, arg_params, aux_params)

    # ------------------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        outputs = self._exec_group.get_outputs()
        return list(zip(self._output_names, [o.shape for o in outputs]))

    # ------------------------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        if self._params_dirty:
            self._sync_params_from_devices()
        return (self._arg_params, self._aux_params)

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        if self._arg_params is None:
            self._arg_params = {
                name: arrs[0].copy() for name, arrs in
                zip(self._param_names, self._exec_group.param_arrays)}
        if self._aux_params is None:
            self._aux_params = {
                name: arrs[0].copy() for name, arrs in
                zip(self._aux_names, self._exec_group.aux_arrays)}
        attrs = self._symbol.attr_dict()

        def _impl(name, arr, cache):
            if cache is not None and name in cache:
                cache_arr = cache[name]
                if cache_arr is not arr:
                    if cache_arr.shape != arr.shape:
                        raise MXNetError("shape mismatch for %s: %s vs %s"
                                         % (name, cache_arr.shape,
                                            arr.shape))
                    cache_arr.copyto(arr)
            else:
                if not allow_missing:
                    raise RuntimeError("%s is not presented" % name)
                if initializer is not None:
                    initializer(InitDesc(name, attrs.get(name)), arr)

        for name in self._param_names:
            arr = self._arg_params[name]
            if arg_params is not None and name in arg_params:
                _impl(name, arr, arg_params)
            elif arg_params is not None and not allow_missing:
                raise RuntimeError("%s is not presented" % name)
            elif initializer is not None:
                initializer(InitDesc(name, attrs.get(name)), arr)
        for name in self._aux_names:
            arr = self._aux_params[name]
            if aux_params is not None and name in aux_params:
                _impl(name, arr, aux_params)
            elif initializer is not None:
                initializer(InitDesc(name, attrs.get(name)), arr)

        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params,
                                    allow_extra=allow_extra)
        if self._fused_step is not None:
            # the new values become the fused step's (its optimizer state
            # stays)
            self._fused_step.reload_params(self._arg_params,
                                           self._aux_params)
            self._fused_dirty = False

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not allow_extra:
            extra = set(arg_params or ()) - set(self._param_names)
            extra |= set(aux_params or ()) - set(self._aux_names)
            if extra:
                raise MXNetError(
                    "parameters %s are not needed by the symbol "
                    "(pass allow_extra=True to ignore)" % sorted(extra))
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init, allow_extra=allow_extra)
            return
        if self.params_initialized and not force_init:
            logging.warning("Parameters already initialized and "
                            "force_init=False. set_params call ignored.")
            return
        self._exec_group.set_params(arg_params, aux_params,
                                    allow_extra=allow_extra)
        if self._fused_step is not None:
            merged_args = dict(self._arg_params or {})
            merged_args.update(arg_params or {})
            merged_aux = dict(self._aux_params or {})
            merged_aux.update(aux_params or {})
            self._fused_step.reload_params(merged_args, merged_aux)
            self._fused_dirty = False
        self._params_dirty = True
        self.params_initialized = True

    # ------------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        if not for_training:
            assert not inputs_need_grad
        self._data_shapes, self._label_shapes = _parse_data_desc(
            self.data_names, self.label_names, data_shapes, label_shapes)
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list,
            self._data_shapes, self._label_shapes, self._param_names,
            for_training, inputs_need_grad, shared_group=None,
            logger=self.logger, fixed_param_names=self._fixed_param_names,
            grad_req=grad_req, state_names=self._state_names,
            group2ctxs=self._group2ctxs)
        self.binded = True
        if self.params_initialized:
            # params set before bind (Module.load): into the executors
            self._exec_group.set_params(self._arg_params, self._aux_params)
        if shared_module is not None and shared_module.params_initialized:
            self.set_params(*shared_module.get_params())

    def _reset_bind(self):
        self.binded = False
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None
        self._serving_engine = None
        self._inflight.clear()

    def reshape(self, data_shapes, label_shapes=None):
        assert self.binded
        self._data_shapes, self._label_shapes = _parse_data_desc(
            self.data_names, self.label_names, data_shapes, label_shapes)
        self._exec_group.reshape(self._data_shapes, self._label_shapes)
        if self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    # ------------------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        if self._params_dirty:
            self._sync_params_from_devices()

        kvstore_type = (kvstore if isinstance(kvstore, str)
                        else getattr(kvstore, "type", "") or "")
        (kvstore, update_on_kvstore) = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        batch_size = self._exec_group.batch_size
        if kvstore and "dist" in kvstore.type and "_sync" in kvstore.type:
            batch_size *= kvstore.num_workers
        rescale_grad = 1.0 / batch_size

        if update_on_kvstore:
            idx2name = dict(enumerate(self._exec_group.param_names))
        else:
            idx2name = {i * len(self._context) + k: n
                        for k in range(len(self._context))
                        for i, n in enumerate(self._exec_group.param_names)}
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            if "rescale_grad" not in optimizer_params:
                optimizer_params["rescale_grad"] = rescale_grad
            optimizer = opt_mod.create(optimizer, sym=self.symbol,
                                       param_idx2name=idx2name,
                                       **optimizer_params)
        else:
            assert isinstance(optimizer, opt_mod.Optimizer)
            if optimizer.rescale_grad != rescale_grad:
                self.logger.warning(
                    "Optimizer created manually outside Module but "
                    "rescale_grad is not normalized to "
                    "1.0/batch_size/num_workers (%s vs. %s). ",
                    optimizer.rescale_grad, rescale_grad)
            if not optimizer.idx2name:
                optimizer.idx2name = idx2name.copy()

        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = None

        self._try_build_fused_step(kvstore_type)

        if kvstore:
            if self._compression_params:
                kvstore.set_gradient_compression(self._compression_params)
            if update_on_kvstore:
                kvstore.set_optimizer(self._optimizer)
            _initialize_kvstore(kvstore=kvstore,
                                param_arrays=self._exec_group.param_arrays,
                                arg_params=self._arg_params,
                                param_names=self._param_names,
                                update_on_kvstore=update_on_kvstore)
        if not update_on_kvstore:
            self._updater = opt_mod.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    # ------------------------------------------------------------------
    # the fused tpu_sync path (reference: module.py:361-590)
    # ------------------------------------------------------------------
    def _try_build_fused_step(self, kvstore_type):
        self._fused_step = None
        if not ("tpu" in kvstore_type
                or (kvstore_type == "device" and len(self._context) > 1)):
            return
        if not self.for_training or self._grad_req != "write":
            return
        if self.inputs_need_grad or self._state_names or self._monitor:
            return
        if self._compression_params:
            # compression asked for must compress: the store's push path
            # quantizes, the fused step never would
            self.logger.info(
                "kvstore=%s: gradient compression requested; using the "
                "kvstore aggregation path (drop compression_params to get "
                "the fused in-graph step)", kvstore_type)
            return
        if collectives.process_count() > 1:
            # several processes sum through the store's push
            return
        if self._label_shapes is None:
            return
        opt = self._optimizer
        if type(opt) is opt_mod.SGD:
            fused_name, hp = "sgd", {"momentum": opt.momentum}
        elif type(opt) is opt_mod.Adam:
            fused_name, hp = "adam", {"beta1": opt.beta1, "beta2": opt.beta2,
                                      "eps": opt.epsilon}
        else:
            self.logger.info("kvstore=%s: optimizer %s has no fused kernel; "
                             "using the per-param update path",
                             kvstore_type, type(opt).__name__)
            return
        batch_size = self._data_shapes[0].shape[0]
        if batch_size % len(self._context) != 0:
            self.logger.warning(
                "kvstore=%s: batch %d not divisible by %d devices; "
                "fused step disabled", kvstore_type, batch_size,
                len(self._context))
            return
        from ..parallel.tpu_step import DataParallelTrainStep
        mesh = data_parallel_mesh(self._context)
        batch_shapes = {d.name: d.shape for d in self._data_shapes}
        batch_shapes.update({l.name: l.shape for l in self._label_shapes})
        # mixed precision: optimizer multi_precision=True or
        # MXNET_FUSED_COMPUTE_DTYPE picks the step's compute dtype; masters,
        # optimizer state and BatchNorm's running statistics stay float32
        compute_dtype = get_env("MXNET_FUSED_COMPUTE_DTYPE") or \
            ("bfloat16" if getattr(opt, "multi_precision", False) else None)
        if compute_dtype is not None:
            try:
                torch_dtype(compute_dtype)
            except TypeError:
                self.logger.warning(
                    "MXNET_FUSED_COMPUTE_DTYPE=%r is not a dtype; "
                    "running the fused step in fp32", compute_dtype)
                compute_dtype = None
        supervisor = self._supervisor
        step = DataParallelTrainStep(
            self._symbol, mesh, lr=opt.lr, wd=opt.wd,
            data_names=self._data_names, label_names=self._label_names,
            rescale_grad=opt.rescale_grad, optimizer=fused_name, opt_hp=hp,
            fixed_param_names=self._fixed_param_names,
            clip_gradient=opt.clip_gradient, compute_dtype=compute_dtype,
            supervise=supervisor is not None)
        step.init_from(self._arg_params, self._aux_params, batch_shapes)
        if supervisor is not None:
            # the default loss scale follows the step's compute dtype
            supervisor.attach_step(step)
        self._fused_step = step
        self._fused_dirty = False
        self._dispatch_depth = max(0, get_env("MXNET_ASYNC_DISPATCH_DEPTH",
                                              2, int))
        self._inflight.clear()
        self.logger.info("kvstore=%s: fused train step active (fwd+bwd+%s "
                         "in one step on %s over %d context(s))",
                         kvstore_type, fused_name, step.device,
                         len(self._context))
        if get_env("MXNET_TPU_TRAIN_AOT", 1, int):
            # a host batch's float64 becomes float32 on the way to the
            # device (the NDArray convention), as the step will see it
            dtypes = {d.name: (_np.float32 if _np.dtype(d.dtype)
                               == _np.float64 else d.dtype)
                      for d in list(self._data_shapes)
                      + list(self._label_shapes or [])}
            step.warmup(dtypes)

    def _fused_lr(self):
        """This step's lr from the optimizer's scheduler (num_update
        counts fused steps)."""
        opt = self._optimizer
        opt.num_update += 1
        if opt.lr_scheduler is not None:
            return opt.lr_scheduler(opt.num_update)
        return opt.lr

    def _fused_forward(self, data_batch):
        fused = self._fused_step
        batch = {}
        for desc, arr in zip(self._data_shapes, data_batch.data):
            batch[desc.name] = arr._data if isinstance(arr, NDArray) else arr
        for desc, arr in zip(self._label_shapes or [],
                             data_batch.label or []):
            batch[desc.name] = arr._data if isinstance(arr, NDArray) else arr
        _faults.fault_point("train.step", step=self._fused_step_count)
        self._fused_step_count += 1
        sup = self._supervisor
        t0 = time.perf_counter()
        if sup is not None and fused.supervise:
            # the loss scale rides as an argument, the verdict comes back
            # on the device
            outs = fused(batch, lr=self._fused_lr(), scale=sup.step_scale())
            flag = fused.last_flag
        else:
            outs = fused(batch, lr=self._fused_lr())
            flag = None
        event = None
        if fused.device.type == "cuda":
            if flag is not None:
                # the verdict to pinned host memory behind the step: read
                # at retire, after the event, with no sync of its own
                host = torch.empty((), dtype=torch.bool, pin_memory=True)
                host.copy_(flag, non_blocking=True)
                flag = host
            event = torch.cuda.Event()
            event.record()
        _prof.record_pipeline_event(
            steps=1, dispatch_ms=(time.perf_counter() - t0) * 1e3)
        self._fused_outputs = [NDArray(o) for o in outs]
        self._fused_active = True
        self._fused_dirty = True
        self._params_dirty = True
        # bounded dispatch: wait on step i - depth before going further
        self._inflight.append((event, flag))
        while len(self._inflight) > self._dispatch_depth:
            self._retire_oldest_inflight()

    def _retire_oldest_inflight(self):
        """Wait on (and, supervised, judge) the oldest step in flight: the
        one place that reads a step's verdict."""
        event, flag = self._inflight.popleft()
        t1 = time.perf_counter()
        sup = self._supervisor
        if sup is not None and flag is not None:
            sup.await_ready(event, flag)
        elif event is not None:
            event.synchronize()
        _prof.record_pipeline_event(
            readback_stall_ms=(time.perf_counter() - t1) * 1e3)

    def _drain_inflight_flags(self):
        """Epoch boundary of a supervised fit: every dispatched step's
        verdict is observed before the params are read."""
        if self._supervisor is None:
            return
        while self._inflight:
            self._retire_oldest_inflight()
        self._supervisor.idle()

    def _wrap_train_iter(self, train_data):
        """The train iterator wrapped in a DevicePrefetchIter staging the
        next batch on the fused step's device (fused path only;
        ``MXNET_DEVICE_PREFETCH=0`` opts out, ``MXNET_DEVICE_PREFETCH_DEPTH``
        sizes it)."""
        if self._fused_step is None or \
                not env_flag("MXNET_DEVICE_PREFETCH", True):
            return train_data
        from ..io_device import DevicePrefetchIter, default_stage_fn
        if isinstance(train_data, DevicePrefetchIter):
            return train_data
        if not (hasattr(train_data, "next") and hasattr(train_data, "reset")):
            return train_data
        depth = max(1, get_env("MXNET_DEVICE_PREFETCH_DEPTH", 2, int))
        return DevicePrefetchIter(
            train_data, stage_fn=default_stage_fn(self._fused_step.device,
                                                  depth=depth),
            depth=depth)

    def _copy_fused_params(self):
        """The fused step's params and aux states into ``_arg_params`` /
        ``_aux_params`` and the executor group, on the device."""
        step = self._fused_step
        with torch.no_grad():
            for src, dst in ((step.params, self._arg_params),
                             (step.aux, self._aux_params)):
                for name, t in src.items():
                    dst[name]._data.copy_(t.detach())
        self._exec_group.set_params(self._arg_params, self._aux_params)
        self._fused_dirty = False

    def _sync_fused_to_execs(self):
        """Before eval/predict: the fused step's params into the
        executors."""
        if self._fused_step is not None and self._fused_dirty:
            self._copy_fused_params()

    # ------------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if (self._fused_step is not None and self._monitor is None
                and (is_train is None or is_train)
                and getattr(data_batch, "label", None)):
            self._fused_forward(data_batch)
            return
        self._fused_active = False
        self._sync_fused_to_execs()
        curr_data_shapes = tuple(i.shape for i in self._data_shapes)
        new_data_shapes = tuple(i.shape for i in data_batch.data)
        if curr_data_shapes != new_data_shapes:
            if getattr(data_batch, "provide_data", None):
                new_dshape = data_batch.provide_data
            else:
                new_dshape = [DataDesc(i.name, shape, i.dtype, i.layout)
                              for i, shape in zip(self._data_shapes,
                                                  new_data_shapes)]
            if getattr(data_batch, "provide_label", None):
                new_lshape = data_batch.provide_label
            elif getattr(data_batch, "label", None) and self._label_shapes:
                new_lshape = [DataDesc(i.name, j.shape, i.dtype, i.layout)
                              for i, j in zip(self._label_shapes,
                                              data_batch.label)]
            else:
                new_lshape = None
            self.reshape(new_dshape, new_lshape)
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        if self._fused_active:
            return  # the fused step already took the gradient
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """Push/pull through the kvstore, or the local updater; a no-op
        after a fused step, whose update already ran."""
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        self._params_dirty = True
        if self._fused_active:
            return
        if self._update_on_kvstore:
            _update_params_on_kvstore(self._exec_group.param_arrays,
                                      self._exec_group.grad_arrays,
                                      self._kvstore,
                                      self._exec_group.param_names)
        else:
            _update_params(self._exec_group.param_arrays,
                           self._exec_group.grad_arrays,
                           updater=self._updater,
                           num_device=len(self._context),
                           kvstore=self._kvstore,
                           param_names=self._exec_group.param_names)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        if self._fused_active:
            return list(self._fused_outputs)
        return self._exec_group.get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized \
            and self.inputs_need_grad
        return self._exec_group.get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        if self._fused_active:
            # the device-side metric: no host sync per batch
            if not eval_metric.update_device(labels, self._fused_outputs):
                eval_metric.update(labels, self._fused_outputs)
            return
        self._exec_group.update_metric(eval_metric, labels)

    def _sync_params_from_devices(self):
        if self._fused_step is not None and self._fused_dirty:
            self._copy_fused_params()
        else:
            self._exec_group.get_params(self._arg_params, self._aux_params)
        self._params_dirty = False

    def save_optimizer_states(self, fname):
        """The optimizer's slots and schedule counters, as
        ``checkpoint/state.py``'s tagged payload."""
        assert self.optimizer_initialized
        if self._update_on_kvstore and self._fused_step is None:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=True)
            return
        from ..checkpoint import state as ckpt_state
        atomic_write(fname, ckpt_state.optimizer_payload_bytes(self))

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._update_on_kvstore and self._fused_step is None:
            self._kvstore.load_optimizer_states(fname)
            return
        from ..checkpoint import state as ckpt_state
        with open(fname, "rb") as f:
            ckpt_state.apply_optimizer_payload(self, f.read())

    def install_monitor(self, mon):
        """Hook ``mon`` on the executors; interior capture needs them, so
        the fused step is turned off (its params first brought back)."""
        assert self.binded
        self._monitor = mon
        if self._fused_step is not None:
            self._sync_fused_to_execs()
            self._fused_step = None
        for exec_ in self._exec_group.execs:
            mon.install(exec_)

    # ------------------------------------------------------------------
    # predict through the serving engine (reference L682-745)
    # ------------------------------------------------------------------
    def _predict_serving_engine(self):
        """The module's InferenceEngine, built on first use and refreshed
        with the executors' current params; None when the module does not
        serve (then predict runs the executors)."""
        if not env_flag("MXNET_SERVING_PREDICT", True):
            return None
        if not (self.binded and self.params_initialized):
            return None
        if (len(self._context) != 1 or self._state_names
                or self._monitor is not None or self.inputs_need_grad):
            return None
        for desc in self._data_shapes:
            layout = getattr(desc, "layout", None)
            if layout and "N" in layout and layout.find("N") != 0:
                return None  # the engine pads and splits axis 0 only
        exe0 = self._exec_group.execs[0]
        if self._serving_engine is None and exe0.has_compiled_forward():
            # score/eval already ran this module's inference forward on
            # the executor path: it keeps that path
            return None
        self._sync_fused_to_execs()
        arg_params = {n: exe0.arg_dict[n] for n in self._param_names
                      if n in exe0.arg_dict}
        aux_params = dict(exe0.aux_dict)
        if self._serving_engine is None:
            from ..serving import InferenceEngine
            self._serving_engine = InferenceEngine(
                self._symbol, arg_params, aux_params, ctx=self._context[0],
                buckets=(self._data_shapes[0].shape[0],),
                name=getattr(self._symbol, "name", None) or "module")
        else:
            self._serving_engine.update_params(arg_params, aux_params)
        return self._serving_engine

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False, sparse_row_id_fn=None):
        """The reference's predict, through the serving engine when the
        module serves (``_predict_serving_engine``)."""
        eng = (self._predict_serving_engine()
               if sparse_row_id_fn is None else None)
        if eng is None:
            return super().predict(
                eval_data, num_batch=num_batch, merge_batches=merge_batches,
                reset=reset, always_output_list=always_output_list,
                sparse_row_id_fn=sparse_row_id_fn)
        if reset:
            eval_data.reset()
        per_batch = []
        for i, batch in enumerate(eval_data):
            if i == num_batch:
                break
            n_pad = getattr(batch, "pad", 0) or 0
            request = {}
            # labels too when the batch carries them: a graph whose
            # inference output reads the label sees what the executor
            # path would
            for desc, arr in list(zip(self._data_shapes, batch.data)) + \
                    list(zip(self._label_shapes or [],
                             getattr(batch, "label", None) or [])):
                request[desc.name] = arr[:arr.shape[0] - n_pad] \
                    if n_pad else arr
            per_batch.append(eng.predict(request))
        return self._merge_predict_outputs(per_batch, merge_batches,
                                           always_output_list)


def _parse_data_desc(data_names, label_names, data_shapes, label_shapes):
    data_shapes = [x if isinstance(x, DataDesc) else DataDesc(*x)
                   for x in data_shapes]
    _check_names_match(data_names, data_shapes, "data", True)
    if label_shapes is not None:
        label_shapes = [x if isinstance(x, DataDesc) else DataDesc(*x)
                        for x in label_shapes]
        _check_names_match(label_names, label_shapes, "label", False)
    else:
        _check_names_match(label_names, [], "label", False)
    return data_shapes, label_shapes


def _check_names_match(data_names, data_shapes, name, throw):
    actual = [x[0] for x in data_shapes]
    if sorted(data_names) != sorted(actual):
        msg = "Data provided by %s_shapes don't match names specified by " \
              "%s_names (%s vs. %s)" % (name, name, str(data_shapes),
                                        str(data_names))
        if throw:
            raise ValueError(msg)
        logging.warning(msg)
