"""Operator registry of the port.

Counterpart of ``mxnet_tpu/ops/registry.py``: each op is a plain PyTorch
function plus a typed ``Params`` struct. Gradients come from
``torch.autograd`` (loss heads carry their own ``autograd.Function``), and
output shapes from running the op on ``meta`` tensors (``OpDef.infer``),
where the JAX package uses ``jax.eval_shape``.

Op function contract::

    fn(params, *inputs, is_train=False, rng=None, device=None)
        -> tensor or tuple of tensors

The returned tuple has length ``num_outputs + num_aux``: visible outputs
first, then updated auxiliary states (BatchNorm's moving_mean/moving_var).
``inputs`` likewise carries the aux states at the end (data, weight, ...,
aux...). The reference's quantization ops (``QUANTIZED``) raise "not yet
ported (ROADMAP A9)"; any other unknown name raises the reference's "not
registered".

- ``is_train`` reaches ops registered with ``need_train``.
- ``rng`` reaches ops registered with ``need_rng``: a ``torch.Generator``
  on the inputs' device, never torch's global RNG. The caller owns its
  state (``random.generator`` for imperative calls, one seeded generator
  a step in ``DataParallelTrainStep``); ``None`` only on ``meta`` tensors
  (shape inference), where nothing is drawn.
- ``device`` reaches ops without tensor inputs (``_zeros``,
  ``_random_uniform``): the device their output is made on.
"""
from __future__ import annotations

import torch

from ..base import MXNetError, Params

__all__ = ["OpDef", "register_op", "get_op", "find_op", "list_ops", "OPS",
           "draws", "QUANTIZED", "make_internal_namespace",
           "make_prefix_namespace"]

OPS = {}
_ALIASES = {}

#: the reference's quantization ops (``mxnet_tpu/ops/quantization.py``),
#: which come with quantized graphs
QUANTIZED = ("_contrib_quantize", "_contrib_dequantize",
             "_contrib_requantize", "_contrib_quantized_conv",
             "_contrib_quantized_fully_connected",
             "_contrib_quantized_pooling", "_contrib_quantized_flatten")


def quantized_error(name, cls=MXNetError):
    return cls("operator %r is not yet ported (ROADMAP A9: quantized "
               "graphs)" % name)


def make_internal_namespace(generated, aliases):
    """The ``_internal`` namespace over a table of op functions (reference
    python/mxnet/{ndarray,symbol}/_internal.py); ``mx.nd._internal`` and
    ``mx.sym._internal`` share it."""

    class _InternalNamespace(object):
        def __getattr__(self, name):
            fn = generated.get(name)
            if fn is None and name in aliases:
                fn = generated.get(aliases[name])
            if fn is None:
                if name in QUANTIZED:
                    raise quantized_error(name, AttributeError)
                raise AttributeError("no internal op %r" % name)
            return fn

    return _InternalNamespace()


def make_prefix_namespace(generated, prefix, label):
    """The ops registered under ``prefix`` by their bare names:
    ``mx.nd.contrib`` ("_contrib_"), ``mx.nd.image`` ("_image_") and their
    ``mx.sym`` twins (reference python/mxnet/ndarray/{contrib,image}.py)."""

    class _PrefixNamespace(object):
        def __getattr__(self, name):
            fn = generated.get(prefix + name)
            if fn is None:
                if prefix + name in QUANTIZED:
                    raise quantized_error(prefix + name, AttributeError)
                raise AttributeError("no %s op %r" % (label, name))
            return fn

        def __dir__(self):
            return [k[len(prefix):] for k in generated
                    if k.startswith(prefix)]

    return _PrefixNamespace()


class _EmptyParams(Params):
    pass


class OpDef:
    __slots__ = ("name", "fn", "param_cls", "input_names", "aux_names",
                 "num_outputs", "need_rng", "need_train", "key_var_num_args",
                 "output_names", "state_outputs", "doc")

    def __init__(self, name, fn, param_cls=None, input_names=("data",),
                 aux_names=(), num_outputs=1, need_rng=False,
                 need_train=False, key_var_num_args=None, output_names=None,
                 state_outputs=False, doc=""):
        self.name = name
        self.fn = fn
        self.param_cls = param_cls or _EmptyParams
        self.input_names = input_names    # tuple | callable(params)->tuple
        self.aux_names = aux_names        # tuple | callable(params)->tuple
        self.num_outputs = num_outputs    # int | callable(params)->int
        self.need_rng = need_rng
        self.need_train = need_train
        # the attr that counts a variadic op's inputs (Concat's num_args)
        self.key_var_num_args = key_var_num_args
        self.output_names = output_names
        # an update op: output i >= 1 is the new value of input i + 1 (the
        # optimizer states), which ``mx.nd`` writes back in place
        self.state_outputs = state_outputs
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
        if self.output_names and len(self.output_names) == n:
            return list(self.output_names)
        if n == 1:
            return ["output"]
        return ["output%d" % i for i in range(n)]

    def n_outputs(self, params=None):
        n = self.num_outputs
        return n(params) if callable(n) else n

    def apply(self, params, inputs, is_train=False, rng=None, device=None):
        """Run the op on tensors; always returns a tuple (outputs + aux
        updates)."""
        kw = {"is_train": is_train} if self.need_train else {}
        if self.need_rng:
            kw["rng"] = rng
        if not inputs:
            kw["device"] = device
        out = self.fn(params, *inputs, **kw)
        return out if isinstance(out, tuple) else (out,)

    def infer(self, params, in_shapes, is_train=True):
        """Output shapes of the op for input shapes ``in_shapes``: the op
        runs on ``meta`` tensors, which carry shapes and no data."""
        ins = [torch.empty(s, dtype=torch.float32, device="meta")
               for s in in_shapes]
        return [tuple(o.shape) for o in self.apply(
            params, ins, is_train, device=torch.device("meta"))]

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
        if name in QUANTIZED:
            raise quantized_error(name)
        raise MXNetError("operator %r is not registered" % name)
    return op


def find_op(name):
    if name in OPS:
        return OPS[name]
    if name in _ALIASES:
        return OPS[_ALIASES[name]]
    return None


def list_ops():
    return sorted(OPS)


def draws(op, params, is_train):
    """Whether ``op`` draws random numbers in this mode: a sampling op
    always; an op that is stochastic only in training (Dropout, rrelu)
    when ``is_train``, or in every mode under Dropout's ``mode="always"``."""
    if not op.need_rng:
        return False
    if not op.need_train or is_train:
        return True
    return getattr(params, "mode", None) == "always"
