"""DataParallelExecutorGroup of the port, on one context (reference:
``mxnet_tpu/module/executor_group.py`` L1-256).

It binds one ``Executor`` for the module's context and copies each
batch, which the iterators build on the host, into the input arrays bound
on that device (``non_blocking``: the host does not wait for the card to
drain its queue before the copy). More than one context is not yet
ported (ROADMAP A7).
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray

__all__ = ["DataParallelExecutorGroup"]


def _tensor(x):
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(_np.ascontiguousarray(_np.asarray(x)))


def _load(bound, sources):
    """Copy each source batch into its bound device arrays."""
    with torch.no_grad():
        for d_arr, src in zip(bound, sources):
            src = _tensor(src)
            for sl, dst in d_arr:
                dst._data.copy_(src[sl], non_blocking=True)


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=None, fixed_param_names=None,
                 grad_req="write", state_names=None, group2ctxs=None):
        if len(contexts) != 1 or shared_group is not None \
                or group2ctxs is not None:
            raise MXNetError("an executor group over %d contexts, shared "
                             "groups and group2ctxs are not yet ported "
                             "(ROADMAP A7)" % len(contexts))
        self.symbol = symbol
        self.contexts = contexts
        self.workload = workload or [1]
        self.param_names = param_names
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = set(fixed_param_names or [])
        self.state_names = state_names or []

        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()

        self.grad_req = {}
        for name in self.arg_names:
            if name in self.param_names:
                self.grad_req[name] = ("null" if name in
                                       self.fixed_param_names else grad_req)
            elif inputs_need_grad and any(name == d.name
                                          for d in data_shapes):
                self.grad_req[name] = grad_req
            else:
                self.grad_req[name] = "null"
        if not for_training:
            self.grad_req = {n: "null" for n in self.arg_names}

        self.execs = []
        self.slices = None
        self.data_shapes = None
        self.label_shapes = None
        self.bind_exec(data_shapes, label_shapes)

    # ------------------------------------------------------------------
    def decide_slices(self, data_shapes):
        batch_size = data_shapes[0].shape[0]
        self.slices = [slice(0, batch_size)]
        return batch_size

    def bind_exec(self, data_shapes, label_shapes, shared_group=None,
                  reshape=False):
        self.batch_size = self.decide_slices(data_shapes)
        self.data_shapes = data_shapes
        self.label_shapes = label_shapes
        input_shapes = {}
        input_types = {}
        for d in data_shapes:
            input_shapes[d.name] = d.shape
            # a non-float32 data input binds at its dtype when the graph
            # isolates it (a cast front); labels never do
            if getattr(d, "dtype", None) is not None \
                    and _np.dtype(d.dtype) != _np.float32:
                input_types[d.name] = _np.dtype(d.dtype)
        if input_types:
            # bind float32 instead when infer_type would unify the input
            # dtype into a parameter
            arg_types, _, _ = self.symbol.infer_type(**input_types)
            data_like = set(input_types) | {
                l.name for l in (label_shapes or [])}
            for name, t in zip(self.arg_names, arg_types):
                if name not in data_like and \
                        not _np.issubdtype(_np.dtype(t), _np.floating):
                    input_types = {}
                    break
        for l in (label_shapes or []):
            input_shapes[l.name] = l.shape
        exec_ = self.symbol.simple_bind(self.contexts[0],
                                        grad_req=self.grad_req,
                                        type_dict=input_types or None,
                                        **input_shapes)
        self.execs = [exec_]
        self.data_arrays = [[(self.slices[0], exec_.arg_dict[d.name])]
                            for d in data_shapes]
        self.label_arrays = None
        if label_shapes:
            self.label_arrays = [[(self.slices[0], exec_.arg_dict[l.name])]
                                 for l in label_shapes
                                 if l.name in self.arg_names]
        self.param_arrays = [[exec_.arg_dict[name]]
                             for name in self.param_names
                             if name in self.arg_names]
        self.grad_arrays = [[exec_.grad_dict.get(name)]
                            for name in self.param_names
                            if name in self.arg_names]
        self.aux_arrays = [[exec_.aux_dict[name]] for name in self.aux_names]

    # ------------------------------------------------------------------
    def reshape(self, data_shapes, label_shapes):
        self.bind_exec(data_shapes, label_shapes, reshape=True)

    def set_params(self, arg_params, aux_params, allow_extra=False):
        for exec_ in self.execs:
            exec_.copy_params_from(arg_params, aux_params,
                                   allow_extra_params=allow_extra)

    def get_params(self, arg_params, aux_params):
        """Copy the bound params and aux states into the given dicts."""
        for names, blocks, out in ((self.param_names, self.param_arrays,
                                    arg_params),
                                   (self.aux_names, self.aux_arrays,
                                    aux_params)):
            for name, block in zip(names, blocks):
                if name in out:
                    block[0].copyto(out[name])
                else:
                    out[name] = block[0].copy()

    # ------------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        _load(self.data_arrays, data_batch.data)
        if self.label_arrays is not None and data_batch.label:
            _load(self.label_arrays, data_batch.label)
        for exec_ in self.execs:
            exec_.forward(is_train=is_train)

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True to run "
                             "backward")
        for exec_ in self.execs:
            exec_.backward(out_grads=out_grads)

    def get_outputs(self, merge_multi_context=True):
        outputs = [[o] for o in self.execs[0].outputs]
        if merge_multi_context:
            return [outs[0] for outs in outputs]
        return outputs

    def get_input_grads(self, merge_multi_context=True):
        grads = [[self.execs[0].grad_dict.get(d.name)]
                 for d in self.data_shapes]
        if merge_multi_context:
            return [g[0] for g in grads]
        return grads

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.execs[0].outputs)
