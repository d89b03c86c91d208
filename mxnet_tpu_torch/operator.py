"""User-defined Python operators (``mx.operator``).

Counterpart of ``mxnet_tpu/operator.py`` (``CustomOp``, ``CustomOpProp``,
``register``, ``get_all_registered_operators`` and the ``Custom`` op,
L154-223). A user's op runs on the host, as the reference's
``pure_callback`` runs it: its inputs are copied to the CPU, its
``forward`` and ``backward`` receive ``NDArray``s there (``in_data``,
``out_data``, ``aux``, ``out_grad``) and write their results into the
ones handed to them (``self.assign``), and the results go back to the
inputs' device. The callbacks run under ``context.host_scope()``, so an
array the user makes (``mx.nd.array(y)``) stays on the host.

- The gradient path is a ``torch.autograd.Function``: the backward
  calls the user's ``backward`` on the same operator instance, which
  may keep what its ``forward`` stashed on ``self``.
- Aux states come back as extra outputs, which ``mx.nd``, ``Executor``
  and ``DataParallelTrainStep`` write into the aux arrays.
- ``Custom`` runs in ``mx.nd.Custom``, in a ``Symbol`` bound by an
  ``Executor`` and inside ``DataParallelTrainStep``. It copies data to
  the host each call, so it can never run inside a CUDA-graph capture:
  it raises there.
- On ``meta`` tensors (shape inference) it returns the shapes of the
  prop's ``infer_shape`` and calls nothing of the user.
"""
from __future__ import annotations

import numpy as _np
import torch

from .base import MXNetError, Params, param_field
from .context import host_scope
from .ops.elemwise import torch_dtype
from .ops.registry import register_op

__all__ = ["CustomOp", "CustomOpProp", "register",
           "get_all_registered_operators"]

_REGISTRY = {}


class CustomOp:
    """Base class of a user op (reference: operator.py ``CustomOp``)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError()

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError()

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` as ``req`` says ("write",
        "inplace", "add" or "null")."""
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] = dst + src
        else:
            raise MXNetError("assign: unknown req %r" % (req,))


class CustomOpProp:
    """The op's metadata (reference: operator.py ``CustomOpProp``)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


def register(reg_name):
    """Decorator registering a ``CustomOpProp`` subclass under
    ``reg_name`` (the ``op_type`` of ``Custom``)."""
    def do_register(prop_cls):
        _REGISTRY[reg_name] = prop_cls
        return prop_cls
    return do_register


def get_all_registered_operators():
    return list(_REGISTRY.keys())


class CustomParam(Params):
    op_type = param_field(str, required=True)

    def __init__(self, **kwargs):
        # every other kwarg goes to the prop's constructor, as
        # MXCustomOpRegister passes the string kwargs through
        op_type = kwargs.pop("op_type", None)
        if op_type is None:
            raise MXNetError("Custom op requires op_type")
        super().__init__(op_type=op_type)
        self.kwargs = kwargs

    def as_str_dict(self):
        out = {"op_type": self.op_type}
        out.update({k: str(v) for k, v in self.kwargs.items()})
        return out


def _get_prop(params):
    if params.op_type not in _REGISTRY:
        raise MXNetError("custom op type %r is not registered (known: %s)"
                         % (params.op_type, list(_REGISTRY)))
    return _REGISTRY[params.op_type](**(params.kwargs or {}))


def _custom_inputs(p):
    return ("data",) if p is None else tuple(_get_prop(p).list_arguments())


def _custom_aux(p):
    return () if p is None else tuple(_get_prop(p).list_auxiliary_states())


def _custom_n_outputs(p):
    return 1 if p is None else len(_get_prop(p).list_outputs())


def _host(t):
    """A host NDArray holding a copy of tensor ``t``."""
    from .ndarray.ndarray import NDArray
    return NDArray(t.detach().to("cpu", copy=True))


class _CustomFunction(torch.autograd.Function):
    """The user's forward, and its backward as the gradient."""

    @staticmethod
    def forward(ctx, op, is_train, n_args, out_specs, *tensors):
        from .ndarray.ndarray import NDArray
        device = tensors[0].device
        in_data = [_host(t) for t in tensors[:n_args]]
        aux = [_host(t) for t in tensors[n_args:]]
        out_data = [NDArray(torch.zeros(s, dtype=d)) for s, d in out_specs]
        with host_scope():
            op.forward(bool(is_train), ["write"] * len(out_data), in_data,
                       out_data, aux)
        ctx.op, ctx.device = op, device
        ctx.host = (in_data, out_data, aux)
        outs = [o._data.to(device) for o in out_data]
        aux_out = [a._data.to(device) for a in aux]
        ctx.mark_non_differentiable(*aux_out)
        return tuple(outs + aux_out)

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray.ndarray import NDArray
        _refuse_capture()
        in_data, out_data, aux = ctx.host
        out_grad = [NDArray(torch.zeros(o.shape, dtype=o._data.dtype)
                            if g is None else g.detach().to("cpu", copy=True))
                    for o, g in zip(out_data, grads)]
        in_grad = [NDArray(torch.zeros(a.shape, dtype=a._data.dtype))
                   for a in in_data]
        with host_scope():
            ctx.op.backward(["write"] * len(in_grad), out_grad, in_data,
                            out_data, in_grad, aux)
        grads_in = [g._data.to(ctx.device) for g in in_grad]
        return (None, None, None, None) + tuple(grads_in) + \
            (None,) * len(aux)


def _refuse_capture():
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise MXNetError("Custom: a Python op copies data to the host each "
                         "call and cannot run inside a CUDA-graph capture")


@register_op("Custom", param_cls=CustomParam, input_names=_custom_inputs,
             aux_names=_custom_aux, num_outputs=_custom_n_outputs,
             need_train=True)
def _custom(params, *inputs, is_train=False):
    prop = _get_prop(params)
    n_args = len(prop.list_arguments())
    args = inputs[:n_args]
    in_shapes = [list(a.shape) for a in args]
    _, out_shapes, _ = prop.infer_shape(in_shapes)
    _, out_types, _ = prop.infer_type(
        [_np.dtype(str(a.dtype).replace("torch.", "")) for a in args])
    out_specs = [(tuple(s), torch_dtype(_np.dtype(d)))
                 for s, d in zip(out_shapes, out_types)]
    if any(t.device.type == "meta" for t in inputs):
        return tuple(torch.empty(s, dtype=d, device="meta")
                     for s, d in out_specs) + tuple(
            torch.empty_like(a) for a in inputs[n_args:])
    _refuse_capture()
    op = prop.create_operator(None, [tuple(s) for s in in_shapes],
                              [a.dtype for a in args])
    return _CustomFunction.apply(op, is_train, n_args, out_specs, *inputs)
