"""Optimizer update ops of the port (``mxnet_tpu/ops/optimizer_ops.py``,
its 11 registrations; reference ``src/operator/optimizer_op.cc``).

Each op returns the new weight and the new state tensors, in the
reference's operations and order: the prologue rescale -> clip (when
``clip_gradient > 0``) -> ``+ wd * weight``, then the update. Called as
``mx.nd.sgd_mom_update(w, g, mom, out=w, ...)`` the ``mx.nd`` wrapper
writes the weight into ``out`` and the states back into their input
arrays, in place, as MXNet's ops mutate their state inputs.

``sgd_update`` and ``sgd_mom_update`` compute what kernel #7
(``kernels/opt_update.py``) computes for one leaf, operation for
operation (``_prologue`` and ``_plain_leaf``): on the card a loop of
these ops over a model's leaves equals one ``fused_update_step`` bit for
bit.
"""
from __future__ import annotations

import torch

from ..base import Params, param_field
from .registry import register_op


class SGDParam(Params):
    lr = param_field(float, required=True)
    wd = param_field(float, default=0.0)
    rescale_grad = param_field(float, default=1.0)
    clip_gradient = param_field(float, default=-1.0)
    lazy_update = param_field(bool, default=True)


def _prep_grad(params, grad):
    g = grad * params.rescale_grad
    if params.clip_gradient > 0:
        g = torch.clamp(g, -params.clip_gradient, params.clip_gradient)
    return g


def _sqrt(v):
    """The correctly rounded square root (``opt_update._sqrt``)."""
    return torch.sqrt(v.double()).to(v.dtype)


@register_op("sgd_update", param_cls=SGDParam, input_names=("weight", "grad"))
def _sgd_update(params, weight, grad):
    g = _prep_grad(params, grad) + params.wd * weight
    return weight - params.lr * g


class SGDMomParam(SGDParam):
    momentum = param_field(float, default=0.0)


@register_op("sgd_mom_update", param_cls=SGDMomParam,
             input_names=("weight", "grad", "mom"), num_outputs=2,
             state_outputs=True)
def _sgd_mom_update(params, weight, grad, mom):
    g = _prep_grad(params, grad) + params.wd * weight
    mom = params.momentum * mom - params.lr * g
    return weight + mom, mom


@register_op("mp_sgd_update", param_cls=SGDParam,
             input_names=("weight", "grad", "weight32"), num_outputs=2,
             state_outputs=True)
def _mp_sgd_update(params, weight, grad, weight32):
    g = _prep_grad(params, grad.float()) + params.wd * weight32
    w32 = weight32 - params.lr * g
    return w32.to(weight.dtype), w32


@register_op("mp_sgd_mom_update", param_cls=SGDMomParam,
             input_names=("weight", "grad", "mom", "weight32"), num_outputs=3,
             state_outputs=True)
def _mp_sgd_mom_update(params, weight, grad, mom, weight32):
    g = _prep_grad(params, grad.float()) + params.wd * weight32
    mom = params.momentum * mom - params.lr * g
    w32 = weight32 + mom
    return w32.to(weight.dtype), mom, w32


class AdamParam(SGDParam):
    beta1 = param_field(float, default=0.9)
    beta2 = param_field(float, default=0.999)
    epsilon = param_field(float, default=1e-8)


@register_op("adam_update", param_cls=AdamParam,
             input_names=("weight", "grad", "mean", "var"), num_outputs=3,
             state_outputs=True)
def _adam_update(params, weight, grad, mean, var):
    g = _prep_grad(params, grad) + params.wd * weight
    mean = params.beta1 * mean + (1 - params.beta1) * g
    var = params.beta2 * var + (1 - params.beta2) * torch.square(g)
    w = weight - params.lr * mean / (_sqrt(var) + params.epsilon)
    return w, mean, var


class RMSPropParam(SGDParam):
    gamma1 = param_field(float, default=0.95)
    gamma2 = param_field(float, default=0.9)
    epsilon = param_field(float, default=1e-8)
    centered = param_field(bool, default=False)
    clip_weights = param_field(float, default=-1.0)


@register_op("rmsprop_update", param_cls=RMSPropParam,
             input_names=("weight", "grad", "n"), num_outputs=2,
             state_outputs=True)
def _rmsprop_update(params, weight, grad, n):
    g = _prep_grad(params, grad) + params.wd * weight
    n = (1 - params.gamma1) * torch.square(g) + params.gamma1 * n
    w = weight - params.lr * g / _sqrt(n + params.epsilon)
    if params.clip_weights > 0:
        w = torch.clamp(w, -params.clip_weights, params.clip_weights)
    return w, n


@register_op("rmspropalex_update", param_cls=RMSPropParam,
             input_names=("weight", "grad", "n", "g", "delta"), num_outputs=4,
             state_outputs=True)
def _rmspropalex_update(params, weight, grad, n, gmean, delta):
    g = _prep_grad(params, grad) + params.wd * weight
    n = (1 - params.gamma1) * torch.square(g) + params.gamma1 * n
    gmean = (1 - params.gamma1) * g + params.gamma1 * gmean
    delta = (params.gamma2 * delta - params.lr * g
             / _sqrt(n - torch.square(gmean) + params.epsilon))
    return weight + delta, n, gmean, delta


class FtrlParam(SGDParam):
    lamda1 = param_field(float, default=0.01)
    beta = param_field(float, default=1.0)


@register_op("ftrl_update", param_cls=FtrlParam,
             input_names=("weight", "grad", "z", "n"), num_outputs=3,
             state_outputs=True)
def _ftrl_update(params, weight, grad, z, n):
    g = _prep_grad(params, grad)
    new_n = n + torch.square(g)
    sigma = (_sqrt(new_n) - _sqrt(n)) / params.lr
    z = z + g - sigma * weight
    w = torch.where(
        z.abs() > params.lamda1,
        -(z - torch.sign(z) * params.lamda1)
        / ((params.beta + _sqrt(new_n)) / params.lr + params.wd),
        torch.zeros((), dtype=weight.dtype, device=weight.device)
    ).to(weight.dtype)
    return w, z, new_n


@register_op("signsgd_update", param_cls=SGDParam,
             input_names=("weight", "grad"))
def _signsgd_update(params, weight, grad):
    g = _prep_grad(params, grad)
    return weight - params.lr * (torch.sign(g) + params.wd * weight)


class SignumParam(SGDMomParam):
    wd_lh = param_field(float, default=0.0)


@register_op("signum_update", param_cls=SignumParam,
             input_names=("weight", "grad", "mom"), num_outputs=2,
             state_outputs=True)
def _signum_update(params, weight, grad, mom):
    g = _prep_grad(params, grad) + params.wd * weight
    mom = params.momentum * mom - (1 - params.momentum) * g
    w = (1 - params.lr * params.wd_lh) * weight + params.lr * torch.sign(mom)
    return w, mom


class AdagradParam(Params):
    lr = param_field(float, required=True)
    epsilon = param_field(float, default=1e-7)
    wd = param_field(float, default=0.0)
    rescale_grad = param_field(float, default=1.0)
    clip_gradient = param_field(float, default=-1.0)


@register_op("_sparse_adagrad_update", aliases=("adagrad_update",),
             param_cls=AdagradParam,
             input_names=("weight", "grad", "history"), num_outputs=2,
             output_names=("out", "history_out"), state_outputs=True)
def _adagrad_update(params, weight, grad, history):
    """AdaGrad (optimizer_op.cc ``_sparse_adagrad_update``), dense."""
    g = _prep_grad(params, grad) + params.wd * weight
    h = history + g * g
    w = weight - params.lr * g / (_sqrt(h) + params.epsilon)
    return w, h
