"""``mx.nd`` of the port: ``NDArray``, one function per registered op, the
``.params`` format and ``mx.nd.random``.

Counterpart of ``mxnet_tpu/ndarray/__init__.py`` (L19-80): the
``mx.nd.<op>`` functions are generated from the op registry. A function
takes its NDArray inputs positionally or by name, and its attributes by
keyword or positionally in the op's field order; a variadic op (Concat,
add_n) counts its inputs. ``out=`` receives the visible outputs (written
in place, or rebound when the result is on the autograd graph), updated
aux states (BatchNorm's moving statistics) are written back into their
arrays in place, and an update op's new states (``sgd_mom_update``'s
``mom``) into its state inputs. An op with no tensor input makes its
output on ``ctx`` (the card when None). Ops registered later
(``rtc.register_cuda_op``) are found by name on first use.
"""
from __future__ import annotations

import builtins as _builtins
import sys

import torch

from .. import imperative as _imp
from .. import random as _random
from ..base import MXNetError
from ..context import resolve_device
from ..ops import OPS, find_op
from ..ops.registry import _ALIASES as _OP_ALIASES
from ..ops.registry import QUANTIZED, draws, make_internal_namespace, \
    make_prefix_namespace, quantized_error
from .ndarray import (NDArray, arange, array, concatenate, empty, full,
                      moveaxis, ones, waitall, zeros)
from .utils import load, save

_this = sys.modules[__name__]


def _write_out(dst, src):
    """``src`` into the ``out=`` array ``dst``: in place, unless ``src`` is
    on the autograd graph or of another shape or dtype (then ``dst``
    takes it, as the reference's handle does)."""
    if src.requires_grad or src.shape != dst._data.shape or \
            src.dtype != dst._data.dtype:
        dst._data = src
    elif src is not dst._data:
        with torch.no_grad():
            dst._data.copy_(src)


def invoke(opdef, inputs, attrs, out=None, ctx=None):
    """Run ``opdef`` on NDArrays as ``mx.nd.<op>`` does; returns its
    visible outputs (one NDArray, or a list)."""
    params = opdef.make_params(dict(attrs))
    tensors = [a._data for a in inputs]
    if tensors:
        device = tensors[0].device
    else:
        device = resolve_device(ctx if ctx is not None
                                else getattr(params, "ctx", None))
    is_train = _imp.is_training()
    rng = _random.generator(device) if draws(opdef, params, is_train) \
        else None
    outs = _imp.run_op(
        lambda *ts: opdef.apply(params, ts, is_train, rng, device), tensors)
    n_vis = opdef.n_outputs(params)
    visible = outs[:n_vis]
    with torch.no_grad():
        n_in = len(opdef.list_inputs(params))
        for arr, upd in zip(inputs[n_in:], outs[n_vis:]):
            if upd is not arr._data:
                arr._data.copy_(upd)
        if opdef.state_outputs:
            for arr, upd in zip(inputs[2:], visible[1:]):
                arr._data.copy_(upd)
    if out is not None:
        for dst, src in zip(out if isinstance(out, (list, tuple))
                            else [out], visible):
            _write_out(dst, src)
        return out
    results = [NDArray(t) for t in visible]
    return results[0] if len(results) == 1 else results


def _make_nd_function(opdef):
    def op_func(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)      # accepted for API parity
        ctx = kwargs.pop("ctx", None)
        inputs = [a for a in args if isinstance(a, NDArray)]
        attr_args = [a for a in args if not isinstance(a, NDArray)]
        attrs, named = {}, {}
        for k, v in kwargs.items():
            (named if isinstance(v, NDArray) else attrs)[k] = v
        if attr_args:
            # positional non-arrays bind to the fields in declaration order
            fields = [f for f in opdef.param_cls._fields if f not in attrs]
            attrs.update(zip(fields, attr_args))
        attrs = {k: v for k, v in attrs.items() if v is not None}
        if opdef.key_var_num_args and opdef.key_var_num_args not in attrs \
                and inputs:
            attrs[opdef.key_var_num_args] = len(inputs)
        if named:
            probe = opdef.make_params(dict(attrs))
            names = opdef.list_inputs(probe) + opdef.list_aux(probe)
            merged = inputs + [None] * (len(names) - len(inputs))
            for k, v in named.items():
                if k not in names:
                    raise MXNetError("%s: unknown input %r (expects %s)"
                                     % (opdef.name, k, names))
                merged[names.index(k)] = v
            inputs = [m for m in merged if m is not None]
        return invoke(opdef, inputs, attrs, out=out, ctx=ctx)

    op_func.__name__ = opdef.name
    op_func.__doc__ = opdef.doc
    return op_func


_GENERATED = {}
for _name, _opdef in list(OPS.items()):
    _GENERATED[_name] = _make_nd_function(_opdef)
for _al, _target in _OP_ALIASES.items():
    if _target in _GENERATED:
        _GENERATED.setdefault(_al, _GENERATED[_target])
# snake_case mirrors of CamelCase ops that mxnet also exposes
for _al, _target in [("fully_connected", "FullyConnected"),
                     ("convolution", "Convolution"), ("pooling", "Pooling"),
                     ("activation", "Activation"),
                     ("batch_norm", "BatchNorm"),
                     ("softmax_output", "SoftmaxOutput")]:
    _GENERATED[_al] = _GENERATED[_target]
for _name, _fn in _GENERATED.items():
    setattr(_this, _name, _fn)


def __getattr__(name):
    # an op registered after import (rtc.register_cuda_op's user ops)
    from .. import rtc
    fn = rtc.nd_function(name)
    if fn is None:
        op = find_op(name)
        if op is None:
            if name in QUANTIZED:
                raise quantized_error("mx.nd." + name, AttributeError)
            raise AttributeError("module %r has no attribute %r"
                                 % (__name__, name))
        fn = _make_nd_function(op)
    _GENERATED[name] = fn
    return fn


# free-function arithmetic (reference: ndarray.py add/subtract/...)
def _binary_free_fn(op_attr):
    def fn(lhs, rhs):
        if isinstance(lhs, NDArray):
            return getattr(lhs, op_attr)(rhs)
        return getattr(rhs, op_attr.replace("__", "__r", 1))(lhs)
    return fn


add = _binary_free_fn("__add__")
subtract = _binary_free_fn("__sub__")
multiply = _binary_free_fn("__mul__")
divide = _binary_free_fn("__truediv__")
true_divide = divide
modulo = _binary_free_fn("__mod__")


def _binary_or_scalar(tensor_op, torch_fn, py_fn):
    """maximum/minimum/power: arrays through the op; a scalar operand as
    a Python number; two scalars give the Python result (reference)."""
    def fn(lhs, rhs):
        if isinstance(lhs, NDArray) and isinstance(rhs, NDArray):
            return _GENERATED[tensor_op](lhs, rhs)
        if isinstance(lhs, NDArray):
            return lhs._binary(rhs, torch_fn)
        if isinstance(rhs, NDArray):
            return rhs._binary(lhs, torch_fn, reverse=True)
        return py_fn(lhs, rhs)
    return fn


def _scalar_max(a, b):
    return torch.clamp_min(a, b) if isinstance(a, torch.Tensor) else \
        torch.clamp_min(b, a)


def _scalar_min(a, b):
    return torch.clamp_max(a, b) if isinstance(a, torch.Tensor) else \
        torch.clamp_max(b, a)


maximum = _binary_or_scalar("maximum", _scalar_max, _builtins.max)
minimum = _binary_or_scalar("minimum", _scalar_min, _builtins.min)
power = _binary_or_scalar("power", torch.pow, lambda a, b: a ** b)


from . import random  # noqa: E402  (mx.nd.random)

_internal = make_internal_namespace(_GENERATED, _OP_ALIASES)
contrib = make_prefix_namespace(_GENERATED, "_contrib_", "contrib")
image = make_prefix_namespace(_GENERATED, "_image_", "image")

__all__ = ["NDArray", "array", "zeros", "ones", "full", "arange", "empty",
           "concatenate", "moveaxis", "waitall", "random", "save", "load",
           "add", "subtract", "multiply", "divide", "true_divide", "modulo",
           "maximum", "minimum", "power", "invoke", "contrib",
           "image"] + list(_GENERATED)
