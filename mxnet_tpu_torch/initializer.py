"""Weight initializers of the port (reference: ``mxnet_tpu/initializer.py``
L20-197; ``mx.init`` is this module).

``Initializer.__call__(InitDesc(name, attrs), arr)`` routes on the name's
suffix as the reference does: weights to ``_init_weight``, biases and
betas to 0, gammas to 1, moving means to 0 and moving variances to 1; a
variable's ``__init__`` attribute overrides the routing. The random
initializers fill the array in place from ``mx.random``'s generator of
the array's device: the same shapes and scales as the reference, torch's
values. ``LSTMBias`` (the LSTM cells' i2h bias) is ported; ``MSRAPrelu``,
``Orthogonal``, ``Bilinear`` and ``Mixed`` are not yet (ROADMAP A2).
"""
from __future__ import annotations

import json

import numpy as _np
import torch

from . import random as _random
from .base import MXNetError, Registry

__all__ = ["InitDesc", "Initializer", "Uniform", "Normal", "Zero", "One",
           "Constant", "Xavier", "LSTMBias", "register", "create",
           "init_registry"]

init_registry = Registry("initializer", not_ported=(
    "MSRAPrelu", "Orthogonal", "Bilinear", "Mixed"), item="A2")


class InitDesc(str):
    """Name + attrs descriptor passed to initializers."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, desc, arr):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(str(desc))
        init = desc.attrs.get("__init__", "")
        if init:
            create(init)._init_weight(desc, arr)
            return
        name = desc.lower()
        if name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("bias"):
            self._init_bias(desc, arr)
        elif name.endswith("gamma"):
            self._init_gamma(desc, arr)
        elif name.endswith("beta"):
            self._init_beta(desc, arr)
        elif name.endswith("moving_mean") or name.endswith("running_mean"):
            self._init_zero(desc, arr)
        elif name.endswith("moving_var") or name.endswith("running_var"):
            self._init_one(desc, arr)
        elif name.endswith("moving_inv_var") or name.endswith("moving_avg"):
            self._init_zero(desc, arr)
        elif name.endswith("min") or name.endswith("max"):
            self._init_zero(desc, arr)
        else:
            self._init_default(desc, arr)

    # -- fillers -----------------------------------------------------------
    def _set(self, arr, value):
        arr[:] = value

    def _init_zero(self, _, arr):
        self._set(arr, 0.0)

    def _init_one(self, _, arr):
        self._set(arr, 1.0)

    def _init_bias(self, _, arr):
        self._set(arr, 0.0)

    def _init_gamma(self, _, arr):
        self._set(arr, 1.0)

    def _init_beta(self, _, arr):
        self._set(arr, 0.0)

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def _init_default(self, name, arr):
        raise MXNetError(
            "Unknown initialization pattern for %s. Default initialization "
            "only covers names ending with weight/bias/gamma/beta/moving_*"
            % name)

    def __repr__(self):
        return "%s(%s)" % (type(self).__name__, self._kwargs)

    def dumps(self):
        return json.dumps([type(self).__name__.lower(), self._kwargs])


def _uniform(arr, low, high):
    t = arr._data
    with torch.no_grad():
        t.uniform_(low, high, generator=_random.generator(t.device))


def _normal(arr, mean, std):
    t = arr._data
    with torch.no_grad():
        t.normal_(mean, std, generator=_random.generator(t.device))


def register(cls):
    init_registry.register(cls)
    return cls


def create(name, **kwargs):
    if isinstance(name, Initializer):
        return name
    if isinstance(name, str) and name.startswith("["):
        kind, kw = json.loads(name)
        return init_registry.get(kind)(**kw)
    return init_registry.get(name)(**kwargs)


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        self._set(arr, 0.0)


init_registry.alias(Zero, "zeros")


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        self._set(arr, 1.0)


init_registry.alias(One, "ones")


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        self._set(arr, self.value)


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        _uniform(arr, -self.scale, self.scale)


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        _normal(arr, 0, self.sigma)


@register
class Xavier(Initializer):
    """reference: initializer.py Xavier — avg/in/out x uniform/gaussian."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        hw_scale = 1.0
        if len(shape) < 2:
            raise MXNetError("Xavier requires at least 2D weight, got %s "
                             "for %s" % (shape, name))
        if len(shape) > 2:
            hw_scale = _np.prod(shape[2:])
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = float(_np.sqrt(self.magnitude / factor))
        if self.rnd_type == "uniform":
            _uniform(arr, -scale, scale)
        else:
            _normal(arr, 0, scale)


@register
class LSTMBias(Initializer):
    """Zeros, with ``forget_bias`` on the forget gate's quarter of the
    [i, f, g, o] packing (reference: initializer.py LSTMBias)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        num_hidden = arr.shape[0] // 4
        a = _np.zeros(arr.shape, dtype=_np.float32)
        a[num_hidden:2 * num_hidden] = self.forget_bias
        arr[:] = a
