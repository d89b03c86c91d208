"""Executor — binds a Symbol to a device and arrays and runs it.

Counterpart of ``mxnet_tpu/executor.py`` (``Executor`` L26). Where the JAX
package traces the graph into one jitted program per mode, the port
interprets it eagerly: ``run_graph`` (the JAX package's ``_run_graph``,
L187-240) walks the op nodes in topological order and returns the outputs
and the BatchNorm aux updates. It is the one graph interpreter that the
executor and ``parallel.DataParallelTrainStep`` share.

``forward(is_train=True)`` on an executor with gradients records the graph
under ``torch.autograd``; ``backward(out_grads)`` seeds it with
``out_grads`` (ones when none are given, as the JAX package's fused
forward+backward does) and writes ``grad_dict`` in place, or adds to it
for ``grad_req="add"``. The aux states are updated in place. ``outputs``
are built at bind, zeros of the inferred output shapes, and each forward
writes into them, as MXNet's executors write their bind-allocated
outputs: an output held across forwards reads the latest one.
``arg_arrays``/``grad_arrays``/``aux_arrays``, ``output_dict``,
``copy_params_from`` and ``reshape`` are the reference's (L563-631):
``reshape`` binds a new executor that shares every array whose shape
stays. Monitor callbacks, ``warmup`` and ``program_cost`` are not yet
ported (ROADMAP A4).
"""
from __future__ import annotations

import torch

from .base import MXNetError
from .context import resolve_device
from .ndarray.ndarray import NDArray, zeros

__all__ = ["Executor", "GraphPlan", "run_graph"]


class GraphPlan:
    """A symbol's graph prepared for ``run_graph``: the variables, and the
    op nodes in topological order with their params parsed once."""

    def __init__(self, symbol):
        self.symbol = symbol
        topo = symbol._topo()
        aux_ids = symbol._aux_set()
        self.variables = [(id(n), n.name, id(n) in aux_ids)
                          for n in topo if n.is_variable]
        self.nodes = []
        for node in topo:
            if node.is_variable:
                continue
            params = node.make_params()
            n_in = len(node.op.list_inputs(params))
            n_aux = len(node.op.list_aux(params))
            self.nodes.append((
                node, params, [(id(i), oi) for i, oi in node.inputs],
                node.op.n_outputs(params),
                [node.inputs[n_in + j][0].name for j in range(n_aux)]))
        self.outputs = [(id(n), 0 if n.is_variable else oi)
                        for n, oi in symbol._outputs]


def run_graph(plan, arg_vals, aux_vals, is_train):
    """Interpret ``plan`` on tensors: ``arg_vals`` / ``aux_vals`` map
    variable names to tensors. Returns (outputs tuple, {aux name: updated
    value})."""
    vals = {}
    for nid, name, is_aux in plan.variables:
        src = aux_vals if is_aux else arg_vals
        if name in src:
            vals[(nid, 0)] = src[name]
    aux_updates = {}
    for node, params, in_keys, n_vis, aux_names in plan.nodes:
        try:
            ins = [vals[k] for k in in_keys]
        except KeyError:
            raise MXNetError("executor: missing input for node %s"
                             % node.name) from None
        outs = node.op.apply(params, ins, is_train=is_train)
        for i in range(n_vis):
            vals[(id(node), i)] = outs[i]
        for name, upd in zip(aux_names, outs[n_vis:]):
            aux_updates[name] = upd
    return tuple(vals[k] for k in plan.outputs), aux_updates


def _not_ported(name):
    def method(self, *args, **kwargs):
        raise MXNetError("Executor.%s is not yet ported (ROADMAP A4)" % name)
    method.__name__ = name
    return method


class Executor:
    """A symbol bound to arrays on one device (``ctx`` None: the card,
    raising without CUDA; ``mx.cpu()``: the CPU)."""

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None):
        self._device = resolve_device(ctx)
        self._symbol = symbol
        self._arg_names = arg_names = symbol.list_arguments()
        self._aux_names = aux_names = symbol.list_auxiliary_states()
        self.arg_dict = self._normalize(args, arg_names, "args")
        self.aux_dict = self._normalize(aux_states or {}, aux_names,
                                        "aux_states", allow_missing=True)
        for name in aux_names:
            if name not in self.aux_dict:
                raise MXNetError("missing aux state %r" % name)
        if isinstance(grad_req, str):
            self._grad_req = {n: grad_req for n in arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self._grad_req = dict(zip(arg_names, grad_req))
        else:
            self._grad_req = dict(grad_req)
            for n in arg_names:
                self._grad_req.setdefault(n, "null")
        self.grad_dict = self._normalize(args_grad or {}, arg_names,
                                         "args_grad", allow_missing=True)
        self._grad_names = [n for n in arg_names
                            if self._grad_req.get(n, "null") != "null"]
        for n in self._grad_names:
            if n not in self.grad_dict:
                self.grad_dict[n] = zeros(self.arg_dict[n].shape,
                                          ctx=self._device)
        self._plan = GraphPlan(symbol)
        self._pending = None    # (outputs, grad leaves) of a train forward
        try:
            _, out_shapes, _ = symbol.infer_shape(
                **{n: a.shape for n, a in self.arg_dict.items()})
            self.outputs = [zeros(s, ctx=self._device) for s in out_shapes]
        except MXNetError:      # shapes known only once a forward runs
            self.outputs = []

    def _normalize(self, arrays, names, what, allow_missing=False):
        if isinstance(arrays, dict):
            out = dict(arrays)
        elif isinstance(arrays, (list, tuple)):
            if len(arrays) != len(names):
                raise MXNetError("%s length %d != expected %d (%s)"
                                 % (what, len(arrays), len(names), names))
            out = dict(zip(names, arrays))
        else:
            raise MXNetError("%s must be list or dict" % what)
        if not allow_missing:
            for n in names:
                if n not in out:
                    raise MXNetError("missing %s entry %r" % (what, n))
        return {n: a if isinstance(a, NDArray) else NDArray(a,
                                                            ctx=self._device)
                for n, a in out.items()}

    def _run(self, is_train, record):
        """One pass of the graph; with ``record``, under autograd with the
        gradient arguments as fresh leaves -> (outputs, aux updates,
        leaves)."""
        arg_vals = {n: a._data for n, a in self.arg_dict.items()}
        aux_vals = {n: a._data for n, a in self.aux_dict.items()}
        leaves = {}
        if record:
            leaves = {n: arg_vals[n].detach().requires_grad_(True)
                      for n in self._grad_names}
            arg_vals.update(leaves)
        with torch.set_grad_enabled(record):
            outs, aux_upd = run_graph(self._plan, arg_vals, aux_vals,
                                      is_train)
        return outs, aux_upd, leaves

    def forward(self, is_train=False, **kwargs):
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown forward argument %r" % k)
            self.arg_dict[k][:] = v
        record = bool(is_train and self._grad_names)
        outs, aux_upd, leaves = self._run(is_train, record)
        self._pending = (outs, leaves) if record else None
        with torch.no_grad():
            for name, val in aux_upd.items():
                dst = self.aux_dict[name]._data
                if val is not dst:
                    dst.copy_(val)
        if len(self.outputs) != len(outs):
            self.outputs = [NDArray(torch.empty_like(o)) for o in outs]
        with torch.no_grad():
            for held, o in zip(self.outputs, outs):
                if held._data.shape != o.shape or held._data.dtype != o.dtype:
                    held._data = torch.empty_like(o)
                held._data.copy_(o)
        return self.outputs

    def backward(self, out_grads=None, is_train=True):
        if not self._grad_names:
            return
        if self._pending is None:
            if out_grads is None:
                raise MXNetError("backward() called before "
                                 "forward(is_train=True)")
            # as the JAX package does: a fresh train-mode pass, whose aux
            # updates are not applied
            outs, _, leaves = self._run(is_train, True)
        else:
            outs, leaves = self._pending
        if out_grads is None:
            seeds = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, (NDArray, torch.Tensor)):
                out_grads = [out_grads]
            seeds = [(g._data if isinstance(g, NDArray)
                      else torch.as_tensor(g)).to(o.device, o.dtype)
                     for g, o in zip(out_grads, outs)]
        pairs = [(o, s) for o, s in zip(outs, seeds) if o.requires_grad]
        wrt = [leaves[n] for n in self._grad_names]
        if pairs:
            grads = torch.autograd.grad([o for o, _ in pairs], wrt,
                                        [s for _, s in pairs],
                                        allow_unused=True,
                                        materialize_grads=True)
        else:
            grads = [torch.zeros_like(w) for w in wrt]
        with torch.no_grad():
            for name, g in zip(self._grad_names, grads):
                dst = self.grad_dict[name]._data
                if self._grad_req.get(name) == "add":
                    dst.add_(g)
                else:
                    dst.copy_(g)
        self._pending = None

    # convenience accessors (reference: executor.py L563-596)
    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._aux_names]

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy (and cast) the given arrays into the bound ones, in place;
        a name the executor lacks raises unless ``allow_extra_params``."""
        for name, array in arg_params.items():
            if name in self.arg_dict:
                array.copyto(self.arg_dict[name])
            elif not allow_extra_params:
                raise MXNetError("Found name %r not in executor arguments"
                                 % name)
        for name, array in (aux_params or {}).items():
            if name in self.aux_dict:
                array.copyto(self.aux_dict[name])
            elif not allow_extra_params:
                raise MXNetError("Found name %r not in executor aux states"
                                 % name)

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor bound at the given input shapes: arrays whose
        shape stays are shared with this one, the others are new zeros,
        and every gradient array is new."""
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        new_args = {}
        for name, shape in zip(self._arg_names, arg_shapes):
            cur = self.arg_dict[name]
            new_args[name] = cur if tuple(shape) == cur.shape else zeros(
                shape, ctx=self._device, dtype=cur.dtype)
        new_aux = {}
        for name, shape in zip(self._aux_names, aux_shapes):
            cur = self.aux_dict[name]
            new_aux[name] = cur if tuple(shape) == cur.shape else zeros(
                shape, ctx=self._device)
        grads = {n: zeros(a.shape, ctx=self._device)
                 for n, a in new_args.items()
                 if self._grad_req.get(n, "null") != "null"}
        return Executor(self._symbol, self._device, new_args, grads,
                        self._grad_req, new_aux)

    warmup = _not_ported("warmup")
    program_cost = _not_ported("program_cost")
    set_monitor_callback = _not_ported("set_monitor_callback")
