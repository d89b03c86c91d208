"""DataParallelExecutorGroup of the port (reference:
``mxnet_tpu/module/executor_group.py`` L1-256).

It splits each batch over the module's contexts by ``work_load_list``
(``_split_input_slice``), binds one ``Executor`` per context on its
slice, and copies each slice of a batch, which the iterators build on
the host, into the input arrays bound on that context's device
(``non_blocking``: the host does not wait for the card to drain its
queue before the copy). Contexts may repeat (``[gpu(0), gpu(0)]``, as in
MXNet): each executor still owns its arrays, so BatchNorm's statistics
are per slice, as in the reference. ``get_outputs``/``get_input_grads``
concatenate the slices (``merge_multi_context``), ``update_metric``
updates the metric slice by slice, and ``get_params`` averages the
weights and aux states over the contexts in the reference's order
((first + second + ...) / n).

``group2ctxs`` (a dict, or one dict per context) is the reference's
model-parallel placement; where every group names the context's own
physical device it is the no-op the reference's is with fewer than two
devices, and otherwise it raises (ROADMAP A7 part 3). ``shared_group``
is accepted and, as in the reference, unused.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray, concatenate
from ..parallel.mesh import one_physical_device

__all__ = ["DataParallelExecutorGroup", "_split_input_slice"]


def _split_input_slice(batch_size, work_load_list):
    """The batch's slice per context, sized by ``work_load_list``
    (reference: executor_manager.py _split_input_slice)."""
    total = sum(work_load_list)
    batch_num_list = [round(batch_size * w / total) for w in work_load_list]
    delta = batch_size - sum(batch_num_list)
    batch_num_list[0] += delta
    slices = []
    end = 0
    for n in batch_num_list:
        begin = int(min(end, batch_size))
        end = int(min(begin + n, batch_size))
        if begin >= end:
            raise MXNetError("Too many slices. Some splits are empty.")
        slices.append(slice(begin, end))
    return slices


def _check_group2ctxs(group2ctxs, contexts):
    """group2ctxs whose groups all sit on each context's own physical
    device place nothing; any other raises (ROADMAP A7 part 3)."""
    if group2ctxs is None:
        return
    per_ctx = group2ctxs if isinstance(group2ctxs, (list, tuple)) \
        else [group2ctxs] * len(contexts)
    for ctx, g2c in zip(contexts, per_ctx):
        devices = [ctx]
        for c in (g2c or {}).values():
            devices += list(c) if isinstance(c, (list, tuple)) else [c]
        one_physical_device(devices, "group2ctxs")


def _tensor(x):
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(_np.ascontiguousarray(_np.asarray(x)))


def _load(bound, sources):
    """Copy each source batch's slices into their bound device arrays."""
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
        _check_group2ctxs(group2ctxs, contexts)
        self.symbol = symbol
        self.contexts = contexts
        self.group2ctxs = group2ctxs
        self.shared_group = shared_group
        self.workload = workload or [1] * len(contexts)
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
        self.slices = _split_input_slice(batch_size, self.workload)
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
        self.execs = []
        for ctx, sl in zip(self.contexts, self.slices):
            shapes = {name: (sl.stop - sl.start,) + tuple(shape[1:])
                      for name, shape in input_shapes.items()}
            self.execs.append(self.symbol.simple_bind(
                ctx, grad_req=self.grad_req, type_dict=input_types or None,
                **shapes))
        pairs = list(zip(self.slices, self.execs))
        self.data_arrays = [[(sl, e.arg_dict[d.name]) for sl, e in pairs]
                            for d in data_shapes]
        self.label_arrays = None
        if label_shapes:
            self.label_arrays = [[(sl, e.arg_dict[l.name])
                                  for sl, e in pairs]
                                 for l in label_shapes
                                 if l.name in self.arg_names]
        self.param_arrays = [[e.arg_dict[name] for e in self.execs]
                             for name in self.param_names
                             if name in self.arg_names]
        self.grad_arrays = [[e.grad_dict.get(name) for e in self.execs]
                            for name in self.param_names
                            if name in self.arg_names]
        self.aux_arrays = [[e.aux_dict[name] for e in self.execs]
                           for name in self.aux_names]

    # ------------------------------------------------------------------
    def reshape(self, data_shapes, label_shapes):
        self.bind_exec(data_shapes, label_shapes, reshape=True)

    def set_params(self, arg_params, aux_params, allow_extra=False):
        for exec_ in self.execs:
            exec_.copy_params_from(arg_params, aux_params,
                                   allow_extra_params=allow_extra)

    def get_params(self, arg_params, aux_params):
        """The bound params and aux states, averaged over the contexts
        ((first + second + ...) / n, on the first one's device), into the
        given dicts."""
        for names, blocks, out in ((self.param_names, self.param_arrays,
                                    arg_params),
                                   (self.aux_names, self.aux_arrays,
                                    aux_params)):
            for name, block in zip(names, blocks):
                value = block[0]
                if len(block) > 1:
                    value = sum((w.as_in_context(block[0].context)
                                 for w in block[1:]), block[0]) / len(block)
                if name in out:
                    value.copyto(out[name])   # in out's dtype
                else:
                    out[name] = value.copy()

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
        for sl, exec_ in zip(self.slices, self.execs):
            if out_grads is not None and len(self.execs) > 1:
                exec_.backward(out_grads=[
                    o[sl] if isinstance(o, NDArray) else o
                    for o in out_grads])
            else:
                exec_.backward(out_grads=out_grads)

    def get_outputs(self, merge_multi_context=True):
        outputs = [[e.outputs[i] for e in self.execs]
                   for i in range(len(self.execs[0].outputs))]
        if merge_multi_context:
            return [outs[0] if len(outs) == 1
                    else concatenate(outs, axis=0) for outs in outputs]
        return outputs

    def get_input_grads(self, merge_multi_context=True):
        grads = []
        for d in self.data_shapes:
            per_dev = [e.grad_dict.get(d.name) for e in self.execs]
            if merge_multi_context:
                per_dev = [g for g in per_dev if g is not None]
                grads.append(per_dev[0] if len(per_dev) == 1
                             else concatenate(per_dev, axis=0))
            else:
                grads.append(per_dev)
        return grads

    def update_metric(self, eval_metric, labels):
        if len(self.execs) == 1:
            eval_metric.update(labels, self.execs[0].outputs)
            return
        for sl, exec_ in zip(self.slices, self.execs):
            eval_metric.update([l[sl] if hasattr(l, "shape") else l
                                for l in labels], exec_.outputs)
