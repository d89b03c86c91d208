"""Optimizers of the port: ``Optimizer``, the reference's fourteen
optimizers and ``Updater`` (reference: ``mxnet_tpu/optimizer.py`` L26-679).

This is the per-parameter update that ``Module`` runs through a kvstore or
its own ``Updater`` (``kvstore='local'``); the fused ``tpu_sync`` step has
its own prologue and update (``parallel/optim_update.py``, kernel #7),
written separately in the reference as here, for SGD and Adam only: under
``tpu_sync`` every other optimizer runs on the per-parameter updater.

Each update keeps the reference's order of operations on the weight's
device: ``g = grad * rescale_grad``, clipped when ``clip_gradient > 0``,
``+ wd * weight``, then the step. Where the reference calls an update op
(``signum_update``, ``rmsprop_update``, ``ftrl_update``, ...) the port
calls its own copy of that op (``ops/optimizer_ops.py``); where it writes
the step inline, so does the port, with correctly rounded square roots
(``optimizer_ops._sqrt``). The results are written into the weight and
state arrays in place (the reference swaps their buffers). lr and wd
multipliers resolve from ``idx2name`` and the symbol's
``__lr_mult__``/``__wd_mult__`` attributes as in the reference.

``SGLD`` draws its noise from ``mx.random``'s generator of the weight's
device (the reference draws from its JAX key): the same distribution,
torch's values. ``LBSGD`` reads two norms to the host for each leaf under
``warmup_strategy='lars'`` and seeds its accumulation counter with the
resume offset, as the reference does. ``Updater.get_states`` /
``set_states`` go through ``checkpoint/state.py``'s tagged payload.
"""
from __future__ import annotations

import math

import numpy as _np
import torch

from . import random as _random
from .base import MXNetError, Registry
from .ndarray.ndarray import NDArray, zeros
from .ops.optimizer_ops import _sqrt

__all__ = ["Optimizer", "SGD", "Signum", "NAG", "SGLD", "Adam", "AdaGrad",
           "RMSProp", "AdaDelta", "Ftrl", "Adamax", "Nadam", "FTML",
           "DCASGD", "LBSGD", "Updater", "get_updater", "create",
           "register", "opt_registry"]

opt_registry = Registry("optimizer")


def register(cls):
    opt_registry.register(cls)
    return cls


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    return opt_registry.get(name)(**kwargs)


#: update op name -> its OpDef, resolved on first use
_OPDEFS = {}


def _op(name, *tensors, **attrs):
    """The port's update op ``name`` on tensors: its outputs as tensors."""
    opdef = _OPDEFS.get(name)
    if opdef is None:
        from .ops.registry import get_op
        opdef = _OPDEFS[name] = get_op(name)
    return opdef.fn(opdef.param_cls(**attrs), *tensors)


def _write(dst, value):
    """Write ``value`` into the array ``dst`` in place."""
    with torch.no_grad():
        dst._data.copy_(value)


def _zeros_like(weight, dtype=None):
    return zeros(weight.shape, ctx=weight.context,
                 dtype=weight.dtype if dtype is None else dtype)


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

    create_optimizer = staticmethod(create)

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
    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("LRScheduler of the optimizer has already been "
                             "defined.")
        self.lr = lr

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

    def _prologue(self, grad, weight, wd):
        """rescale -> clip -> ``+ wd * weight``, as the reference's inline
        updates write it."""
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g + wd * weight


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
                new_w, new_m = _op("sgd_mom_update", weight._data,
                                   grad._data, state._data,
                                   momentum=self.momentum, **kw)
                _write(state, new_m)
            else:
                new_w = _op("sgd_update", weight._data, grad._data, **kw)
            _write(weight, new_w)


@register
class Signum(Optimizer):
    """reference: optimizer.py:194."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return _zeros_like(weight)
        return None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        with torch.no_grad():
            if state is not None:
                new_w, new_m = _op("signum_update", weight._data,
                                   grad._data, state._data,
                                   momentum=self.momentum,
                                   wd_lh=self.wd_lh, **kw)
                _write(state, new_m)
            else:
                new_w = _op("signsgd_update", weight._data, grad._data, **kw)
            _write(weight, new_w)


@register
class NAG(SGD):
    """Nesterov accelerated SGD (reference: optimizer.py:217)."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        with torch.no_grad():
            g = self._prologue(grad._data, weight._data, kw["wd"])
            if state is not None:
                # mom = momentum * mom + g; w -= lr * (g + momentum * mom)
                mom = self.momentum * state._data + g
                _write(state, mom)
                _write(weight, weight._data
                       - kw["lr"] * (g + self.momentum * mom))
            else:
                _write(weight, weight._data - kw["lr"] * g)


@register
class LBSGD(Optimizer):
    """Large-batch SGD with warmup or LARS lr scaling (reference:
    optimizer.py:237): gradients accumulate per leaf for ``batch_scale``
    updates, then one SGD step runs with the warmup- (or LARS-) scaled
    learning rate."""

    def __init__(self, momentum=0.0, multi_precision=False,
                 warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.multi_precision = multi_precision
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = batch_scale
        self.updates_per_epoch = updates_per_epoch
        self.init_updates = begin_epoch * updates_per_epoch
        self.num_epochs = num_epochs
        self.cumgrads = {}

    def create_state(self, index, weight):
        if self.multi_precision and weight.dtype == _np.float16:
            # float32 master copy + float32 momentum
            master = weight.astype(_np.float32)
            mom = (_zeros_like(weight, _np.float32)
                   if self.momentum != 0.0 else None)
            return (mom, master)
        if self.momentum != 0.0:
            return _zeros_like(weight)
        return None

    def _get_lbmult(self, nup):
        """Warmup lr multiplier ramping 1 -> batch_scale."""
        nwup = self.warmup_epochs * self.updates_per_epoch
        maxmult = float(self.batch_scale)
        if nup >= nwup:
            return maxmult
        if nwup <= 1:
            return 1.0
        if self.warmup_strategy == "linear":
            return 1.0 + (maxmult - 1) * nup / nwup
        if self.warmup_strategy == "power2":
            return 1.0 + (maxmult - 1) * (nup * nup) / (nwup * nwup)
        if self.warmup_strategy == "sqrt":
            return 1.0 + (maxmult - 1) * math.sqrt(float(nup) / nwup)
        return 1.0

    def _get_lars(self, weight, g, wd):
        """Layer-wise adaptive rate scaling, clamped to [0.01, 100]: two
        norms read to the host."""
        w2 = float(torch.sum(weight._data * weight._data))
        g2 = float(torch.sum(g * g))
        lars = math.sqrt(w2 / (g2 + wd * w2 + 1e-18))
        return min(max(lars, 0.01), 100.0)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        with torch.no_grad():
            cg = self.cumgrads.get(index)
            if cg and cg["num_cums"] > 0:
                cum_grad = cg["cum_grad"] + grad._data
                num_cums = cg["num_cums"] + 1
            else:
                cum_grad = grad._data.clone()
                # seeded with the resume offset, as the reference does
                # (its _cumulate_gradient: num_cums = init_updates + 1):
                # one counter for the warmup and the accumulation window
                num_cums = self.init_updates + 1
            self.cumgrads[index] = {"cum_grad": cum_grad,
                                    "num_cums": num_cums}
            if num_cums % self.batch_scale != 0:
                return  # accumulate only
            g = (cum_grad / self.batch_scale) * self.rescale_grad
            if self.clip_gradient is not None:
                g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
            if self.warmup_strategy == "lars":
                lbmult = self._get_lars(weight, g, wd)
            else:
                lbmult = self._get_lbmult(num_cums)
            lr = lr * lbmult
            use_mp = isinstance(state, tuple)
            mom, master = state if use_mp else (state, None)
            target = master if use_mp else weight
            g = g.float() if use_mp else g
            g = g + wd * target._data
            if mom is not None:
                _write(mom, self.momentum * mom._data + lr * g)
                _write(target, target._data - mom._data)
            else:
                _write(target, target._data - lr * g)
            if use_mp:  # the float32 master into the float16 weight
                _write(weight, target._data)
            self.cumgrads[index]["cum_grad"] = 0


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (reference: optimizer.py:337):
    the update adds lamda * g^2 * (w - w_prev)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = _zeros_like(weight) if self.momentum != 0.0 else None
        return (mom, weight.copy())

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        with torch.no_grad():
            g = grad._data * self.rescale_grad
            if self.clip_gradient is not None:
                g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
            mom, prev_w = state
            w = weight._data
            comp = g + wd * w + self.lamda * g * g * (w - prev_w._data)
            if mom is not None:
                _write(mom, self.momentum * mom._data - lr * comp)
                step = mom._data
            else:
                step = -lr * comp
            _write(prev_w, w)
            _write(weight, w + step)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (reference: optimizer.py:373):
    the noise comes from ``mx.random``'s generator of the weight's
    device."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        with torch.no_grad():
            w = weight._data
            g = self._prologue(grad._data, w, kw["wd"])
            noise = torch.randn(w.shape, dtype=torch.float32,
                                device=w.device,
                                generator=_random.generator(w.device)) \
                * kw["lr"] ** 0.5
            _write(weight, w - kw["lr"] / 2 * g + noise.to(w.dtype))


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
            new_w, new_m, new_v = _op(
                "adam_update", weight._data, grad._data, mean._data,
                var._data, lr=lr, beta1=self.beta1, beta2=self.beta2,
                epsilon=self.epsilon, **kw)
            _write(mean, new_m)
            _write(var, new_v)
            _write(weight, new_w)


@register
class AdaGrad(Optimizer):
    """reference: optimizer.py:435."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        with torch.no_grad():
            g = self._prologue(grad._data, weight._data, kw["wd"])
            _write(state, state._data + torch.square(g))
            _write(weight, weight._data - kw["lr"] * g / (
                _sqrt(state._data) + self.float_stable_eps))


@register
class RMSProp(Optimizer):
    """reference: optimizer.py:457 (centered: Graves 2013)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros_like(weight, _np.float32),
                    _zeros_like(weight, _np.float32),
                    _zeros_like(weight, _np.float32))
        return _zeros_like(weight, _np.float32)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        kw["epsilon"] = self.epsilon
        kw["gamma1"] = self.gamma1
        with torch.no_grad():
            if self.centered:
                n, gmean, delta = state
                new_w, new_n, new_g, new_d = _op(
                    "rmspropalex_update", weight._data, grad._data, n._data,
                    gmean._data, delta._data, gamma2=self.gamma2, **kw)
                _write(n, new_n)
                _write(gmean, new_g)
                _write(delta, new_d)
            else:
                if self.clip_weights:
                    kw["clip_weights"] = self.clip_weights
                new_w, new_n = _op("rmsprop_update", weight._data,
                                   grad._data, state._data, **kw)
                _write(state, new_n)
            _write(weight, new_w)


@register
class AdaDelta(Optimizer):
    """reference: optimizer.py:495."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight, _np.float32),
                _zeros_like(weight, _np.float32))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        with torch.no_grad():
            g = self._prologue(grad._data, weight._data, kw["wd"])
            acc_g, acc_delta = state
            _write(acc_g, self.rho * acc_g._data
                   + (1 - self.rho) * torch.square(g))
            delta = (_sqrt(acc_delta._data + self.epsilon)
                     / _sqrt(acc_g._data + self.epsilon)) * g
            _write(acc_delta, self.rho * acc_delta._data
                   + (1 - self.rho) * torch.square(delta))
            _write(weight, weight._data - delta)


@register
class Ftrl(Optimizer):
    """reference: optimizer.py:522."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros_like(weight, _np.float32),
                _zeros_like(weight, _np.float32))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        z, n = state
        with torch.no_grad():
            new_w, new_z, new_n = _op("ftrl_update", weight._data,
                                      grad._data, z._data, n._data,
                                      lamda1=self.lamda1, beta=self.beta,
                                      **kw)
            _write(z, new_z)
            _write(n, new_n)
            _write(weight, new_w)


@register
class Adamax(Optimizer):
    """reference: optimizer.py:542."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_zeros_like(weight, _np.float32),
                _zeros_like(weight, _np.float32))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        kw = self._common_kwargs(index)
        lr = kw["lr"] / (1.0 - self.beta1 ** t)
        with torch.no_grad():
            g = self._prologue(grad._data, weight._data, kw["wd"])
            m, u = state
            _write(m, self.beta1 * m._data + (1 - self.beta1) * g)
            _write(u, torch.maximum(self.beta2 * u._data, torch.abs(g)))
            _write(weight, weight._data - lr * m._data / (u._data + 1e-8))


@register
class Nadam(Optimizer):
    """reference: optimizer.py:569."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros_like(weight, _np.float32),
                _zeros_like(weight, _np.float32))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        kw = self._common_kwargs(index)
        momentum_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            (t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        with torch.no_grad():
            g = self._prologue(grad._data, weight._data, kw["wd"])
            m, v = state
            _write(m, self.beta1 * m._data + (1.0 - self.beta1) * g)
            _write(v, self.beta2 * v._data
                   + (1.0 - self.beta2) * torch.square(g))
            grad_prime = g / (1.0 - self.m_schedule)
            m_t_prime = m._data / (1.0 - m_schedule_next)
            v_t_prime = v._data / (1.0 - self.beta2 ** t)
            m_t_bar = ((1.0 - momentum_t) * grad_prime
                       + momentum_t_1 * m_t_prime)
            _write(weight, weight._data - kw["lr"] * m_t_bar / (
                _sqrt(v_t_prime) + self.epsilon))


@register
class FTML(Optimizer):
    """reference: optimizer.py:608."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight, _np.float32),
                _zeros_like(weight, _np.float32),
                _zeros_like(weight, _np.float32))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        kw = self._common_kwargs(index)
        with torch.no_grad():
            g = self._prologue(grad._data, weight._data, kw["wd"])
            d, sigma, z = state
            v_t = self.beta2 * sigma._data + (1 - self.beta2) * torch.square(g)
            d_t = (1 - self.beta1 ** t) / kw["lr"] * (
                _sqrt(v_t / (1 - self.beta2 ** t)) + self.epsilon)
            sigma_t = d_t - self.beta1 * d._data
            _write(z, self.beta1 * z._data + (1 - self.beta1) * g
                   - sigma_t * weight._data)
            _write(d, d_t)
            _write(sigma, v_t)
            _write(weight, -z._data / d_t)


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
        """Restore from ``get_states``' bytes, a legacy bare states pickle
        or a reference payload (``checkpoint.state.apply_updater_payload``;
        a payload that carries the optimizer also restores num_update and
        the lr scheduler's position)."""
        from .checkpoint.state import apply_updater_payload
        apply_updater_payload(self, states)

    def get_states(self, dump_optimizer=False):
        """The slots (and with ``dump_optimizer`` the optimizer's schedule
        counters) as ``checkpoint/state.py``'s tagged payload bytes."""
        from .checkpoint.state import updater_payload_bytes
        return updater_payload_bytes(self, dump_optimizer=dump_optimizer)


def get_updater(optimizer):
    return Updater(optimizer)
