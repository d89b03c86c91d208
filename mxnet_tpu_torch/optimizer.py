"""Optimizers of the port: ``Optimizer``, ``SGD``, ``Adam``, ``Updater``
(reference: ``mxnet_tpu/optimizer.py`` L26-190, L390-433, L647-679).

This is the per-parameter update that ``Module`` runs through a kvstore or
its own ``Updater`` (``kvstore='local'``); the fused ``tpu_sync`` step has
its own prologue and update (``parallel/optim_update.py``, kernel #7),
written separately in the reference as here.

Each update is the reference's op (``mxnet_tpu/ops/optimizer_ops.py``
L25-56 and ``adam_update``) in the same order of operations, on the
weight's device: ``g = grad * rescale_grad``, clipped when
``clip_gradient > 0``, ``+ wd * weight``, then the step. The results are
written into the weight and state arrays in place (the reference swaps
their buffers). lr and wd multipliers resolve from ``idx2name`` and the
symbol's ``__lr_mult__``/``__wd_mult__`` attributes as in the reference.
The other optimizers of the reference (``Signum``, ``NAG``, ``RMSProp``,
...) are not yet ported (ROADMAP A2): ``create`` raises on them.
"""
from __future__ import annotations

import numpy as _np
import torch

from .base import MXNetError, Registry
from .ndarray.ndarray import NDArray, zeros

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "get_updater", "create",
           "register", "opt_registry"]

opt_registry = Registry("optimizer", not_ported=(
    "Signum", "NAG", "LBSGD", "DCASGD", "SGLD", "AdaGrad", "RMSProp",
    "AdaDelta", "Ftrl", "Adamax", "Nadam", "FTML"), item="A2")


def register(cls):
    opt_registry.register(cls)
    return cls


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    return opt_registry.get(name)(**kwargs)


# -- the update ops (reference: ops/optimizer_ops.py) -----------------------

def _prep_grad(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _sgd_update(weight, grad, lr, wd, rescale_grad, clip_gradient):
    g = _prep_grad(grad, rescale_grad, clip_gradient) + wd * weight
    return weight - lr * g


def _sgd_mom_update(weight, grad, mom, lr, momentum, wd, rescale_grad,
                    clip_gradient):
    g = _prep_grad(grad, rescale_grad, clip_gradient) + wd * weight
    mom = momentum * mom - lr * g
    return weight + mom, mom


def _adam_update(weight, grad, mean, var, lr, beta1, beta2, epsilon, wd,
                 rescale_grad, clip_gradient):
    g = _prep_grad(grad, rescale_grad, clip_gradient) + wd * weight
    mean = beta1 * mean + (1 - beta1) * g
    var = beta2 * var + (1 - beta2) * torch.square(g)
    w = weight - lr * mean / (torch.sqrt(var) + epsilon)
    return w, mean, var


def _write(dst, value):
    """Write ``value`` into the array ``dst`` in place."""
    with torch.no_grad():
        dst._data.copy_(value)


class Optimizer:
    """reference: optimizer.py:37 Optimizer base."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.lr, self.wd = learning_rate, wd
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            lr_scheduler.base_lr = learning_rate
        # per-index counters, all starting at begin_num_update
        self.begin_num_update = self.num_update = begin_num_update
        self._index_update_count = {}
        # per-parameter multiplier sources, in resolution order (_mult)
        self.param_dict = dict(param_dict or {})
        self.lr_mult, self.wd_mult = {}, {}
        self.idx2name = dict(param_idx2name or {})
        self.sym_info = () if sym is None else (sym.attr_dict(),
                                                sym.list_arguments())

    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        if self.multi_precision and weight.dtype == _np.float16:
            master = weight.astype(_np.float32)
            return (master,) + (self.create_state(index, master),)
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        if self.multi_precision and weight.dtype == _np.float16:
            master, original_state = state[0], state[1]
            self.update(index, master, grad.astype(_np.float32),
                        original_state)
            _write(weight, master._data)
        else:
            self.update(index, weight, grad, state)

    # -- lr/wd plumbing ----------------------------------------------------
    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = {}
        if self.sym_info:
            attr, arg_names = self.sym_info
            for name in arg_names:
                if name in attr and "__lr_mult__" in attr[name]:
                    self.lr_mult[name] = float(attr[name]["__lr_mult__"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        if self.sym_info:
            attr, arg_names = self.sym_info
            for name in arg_names:
                if name in attr and "__wd_mult__" in attr[name]:
                    self.wd_mult[name] = float(attr[name]["__wd_mult__"])
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        count = self._index_update_count.get(index,
                                             self.begin_num_update) + 1
        self._index_update_count[index] = count
        if count > self.num_update:
            self.num_update = count

    def _mult(self, index, attr):
        """The multiplier ``attr`` ('lr_mult' or 'wd_mult') of ``index``:
        a Gluon Parameter in param_dict wins; then a set_*_mult entry
        under the index; then one under its name (idx2name); else 1."""
        if index in self.param_dict:
            return getattr(self.param_dict[index], attr)
        table = getattr(self, attr)
        if index in table:
            return table[index]
        name = self.idx2name.get(index)
        return table.get(name, 1.0) if name is not None else 1.0

    def _get_lr(self, index):
        base = self.lr if self.lr_scheduler is None \
            else self.lr_scheduler(self.num_update)
        return base * self._mult(index, "lr_mult")

    def _get_wd(self, index):
        return self.wd * self._mult(index, "wd_mult")

    def _common_kwargs(self, index):
        clip = self.clip_gradient
        return {"lr": self._get_lr(index), "wd": self._get_wd(index),
                "rescale_grad": self.rescale_grad,
                "clip_gradient": -1.0 if clip is None else float(clip)}


@register
class SGD(Optimizer):
    """reference: optimizer.py:149 — momentum + multi-precision."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return zeros(weight.shape, ctx=weight.context,
                         dtype=weight.dtype)
        return None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        with torch.no_grad():
            if state is not None:
                new_w, new_m = _sgd_mom_update(
                    weight._data, grad._data, state._data,
                    momentum=self.momentum, **kw)
                _write(state, new_m)
            else:
                new_w = _sgd_update(weight._data, grad._data, **kw)
            _write(weight, new_w)


@register
class Adam(Optimizer):
    """reference: optimizer.py:390 (with bias correction)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (zeros(weight.shape, ctx=weight.context, dtype=weight.dtype),
                zeros(weight.shape, ctx=weight.context, dtype=weight.dtype))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        kw = self._common_kwargs(index)
        coef1 = 1.0 - self.beta1 ** t
        coef2 = 1.0 - self.beta2 ** t
        lr = kw.pop("lr") * coef2 ** 0.5 / coef1
        mean, var = state
        with torch.no_grad():
            new_w, new_m, new_v = _adam_update(
                weight._data, grad._data, mean._data, var._data, lr=lr,
                beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
                **kw)
            _write(mean, new_m)
            _write(var, new_v)
            _write(weight, new_w)


class Updater:
    """Per-key state container (reference: optimizer.py Updater)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        if not isinstance(weight, NDArray) or not isinstance(grad, NDArray):
            raise MXNetError("Updater takes NDArrays")
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def set_states(self, states):
        raise MXNetError("Updater.set_states is not yet ported (ROADMAP A8, "
                         "checkpoint/state)")

    def get_states(self, dump_optimizer=False):
        raise MXNetError("Updater.get_states is not yet ported (ROADMAP A8, "
                         "checkpoint/state)")


def get_updater(optimizer):
    return Updater(optimizer)
