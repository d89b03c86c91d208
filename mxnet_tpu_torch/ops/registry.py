"""Operator registry of the port.

Counterpart of ``mxnet_tpu/ops/registry.py``: each op is a plain PyTorch
function plus a typed ``Params`` struct. Gradients come from
``torch.autograd`` (loss heads carry their own ``autograd.Function``), and
output shapes from running the op on ``meta`` tensors (``OpDef.infer``),
where the JAX package uses ``jax.eval_shape``.

Op function contract::

    fn(params, *inputs, is_train=False) -> tensor or tuple of tensors

The returned tuple has length ``num_outputs + num_aux``: visible outputs
first, then updated auxiliary states (BatchNorm's moving_mean/moving_var).
``inputs`` likewise carries the aux states at the end (data, weight, ...,
aux...). An op the port has not registered raises "not yet ported".
"""
from __future__ import annotations

import torch

from ..base import MXNetError, Params

__all__ = ["OpDef", "register_op", "get_op", "find_op", "list_ops", "OPS"]

OPS = {}
_ALIASES = {}


class _EmptyParams(Params):
    pass


class OpDef:
    __slots__ = ("name", "fn", "param_cls", "input_names", "aux_names",
                 "num_outputs", "need_rng", "need_train", "doc")

    def __init__(self, name, fn, param_cls=None, input_names=("data",),
                 aux_names=(), num_outputs=1, need_rng=False,
                 need_train=False, doc=""):
        self.name = name
        self.fn = fn
        self.param_cls = param_cls or _EmptyParams
        self.input_names = input_names    # tuple | callable(params)->tuple
        self.aux_names = aux_names        # tuple | callable(params)->tuple
        self.num_outputs = num_outputs    # int | callable(params)->int
        self.need_rng = need_rng
        self.need_train = need_train
        self.doc = doc or (fn.__doc__ or "")

    def make_params(self, kwargs):
        return self.param_cls(**kwargs)

    def list_inputs(self, params=None):
        names = self.input_names
        if callable(names):
            names = names(params)
        return list(names)

    def list_aux(self, params=None):
        names = self.aux_names
        if callable(names):
            names = names(params)
        return list(names)

    def list_outputs(self, params=None):
        n = self.n_outputs(params)
        if n == 1:
            return ["output"]
        return ["output%d" % i for i in range(n)]

    def n_outputs(self, params=None):
        n = self.num_outputs
        return n(params) if callable(n) else n

    def apply(self, params, inputs, is_train=False):
        """Run the op on tensors; always returns a tuple (outputs + aux
        updates)."""
        kw = {"is_train": is_train} if self.need_train else {}
        out = self.fn(params, *inputs, **kw)
        return out if isinstance(out, tuple) else (out,)

    def infer(self, params, in_shapes, is_train=True):
        """Output shapes of the op for input shapes ``in_shapes``: the op
        runs on ``meta`` tensors, which carry shapes and no data."""
        ins = [torch.empty(s, dtype=torch.float32, device="meta")
               for s in in_shapes]
        return [tuple(o.shape) for o in self.apply(params, ins, is_train)]

    def __repr__(self):
        return "OpDef(%s)" % self.name


def register_op(name, aliases=(), **kw):
    """Decorator registering a torch function as an operator."""
    def deco(fn):
        if name in OPS:
            raise MXNetError("op %s already registered" % name)
        OPS[name] = OpDef(name, fn, **kw)
        for al in aliases:
            _ALIASES[al] = name
        return fn
    return deco


def get_op(name):
    op = find_op(name)
    if op is None:
        raise MXNetError("operator %r is not yet ported (ROADMAP A3; the "
                         "port has %s)" % (name, list_ops()))
    return op


def find_op(name):
    if name in OPS:
        return OPS[name]
    if name in _ALIASES:
        return OPS[_ALIASES[name]]
    return None


def list_ops():
    return sorted(OPS)
