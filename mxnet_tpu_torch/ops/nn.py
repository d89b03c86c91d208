"""Neural-network ops of the port, plain PyTorch on NCHW tensors.

Counterpart of the main-path subset of ``mxnet_tpu/ops/nn.py``:
FullyConnected (L70), Convolution (L112), Pooling (L187), Activation
(L242), BatchNorm (L339) and SoftmaxOutput (L589) with ``_loss_op``
(L519). Convolution, matmul and BatchNorm go to torch's own calls
(cuDNN/cuBLAS on the card), as the JAX package leaves them to XLA; the
conventions are the reference's, not torch's:

- Pooling: average pooling divides by the whole kernel, padding included;
  ``pooling_convention="full"`` pads only on the right (not torch's
  ``ceil_mode``); the global pool is a mean.
- BatchNorm: the batch variance is the biased one; the moving statistics
  update as ``mm * momentum + mean * (1 - momentum)`` (not torch's
  running-stat update, which keeps the unbiased variance);
  ``fix_gamma=True`` normalizes with ones and gives gamma a zero
  gradient; it computes in float32.
- SoftmaxOutput's gradient is the reference's ``(softmax - onehot) *
  grad_scale`` times the head gradient, not autograd of softmax; labels
  get a zero gradient.
"""
from __future__ import annotations

import math

import numpy as _np
import torch
import torch.nn.functional as F

from ..base import MXNetError, Params, param_field
from .registry import register_op

# ---------------------------------------------------------------------------
# FullyConnected (nn/fully_connected.cc)
# ---------------------------------------------------------------------------


class FCParam(Params):
    num_hidden = param_field(int, required=True)
    no_bias = param_field(bool, default=False)
    flatten = param_field(bool, default=True)


def _fc_inputs(p):
    if p is not None and p.no_bias:
        return ("data", "weight")
    return ("data", "weight", "bias")


@register_op("FullyConnected", param_cls=FCParam, input_names=_fc_inputs)
def _fully_connected(params, x, weight, bias=None):
    if params.flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    y = torch.matmul(x, weight.t())
    if bias is not None:
        y = y + bias
    return y


# ---------------------------------------------------------------------------
# Convolution (nn/convolution.cc)
# ---------------------------------------------------------------------------


class ConvParam(Params):
    kernel = param_field(tuple, required=True)
    stride = param_field(tuple, default=())
    dilate = param_field(tuple, default=())
    pad = param_field(tuple, default=())
    num_filter = param_field(int, required=True)
    num_group = param_field(int, default=1)
    no_bias = param_field(bool, default=False)
    workspace = param_field(int, default=1024)
    cudnn_tune = param_field(str, default=None)
    cudnn_off = param_field(bool, default=False)
    layout = param_field(str, default=None)


def _conv_inputs(p):
    if p is not None and p.no_bias:
        return ("data", "weight")
    return ("data", "weight", "bias")


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@register_op("Convolution", param_cls=ConvParam, input_names=_conv_inputs)
def _convolution(params, x, weight, bias=None):
    nd = len(params.kernel)
    if nd not in _CONV or params.layout not in (None, "NCW", "NCHW",
                                                 "NCDHW"):
        raise MXNetError("Convolution: %d-D kernels / layout %s are not yet "
                         "ported (ROADMAP A3)" % (nd, params.layout))
    return _CONV[nd](x, weight, bias, stride=params.stride or (1,) * nd,
                     padding=params.pad or (0,) * nd,
                     dilation=params.dilate or (1,) * nd,
                     groups=params.num_group)


# ---------------------------------------------------------------------------
# Pooling (nn/pooling.cc)
# ---------------------------------------------------------------------------


class PoolParam(Params):
    kernel = param_field(tuple, default=())
    pool_type = param_field(str, default="max", enum=("max", "avg", "sum"))
    global_pool = param_field(bool, default=False)
    stride = param_field(tuple, default=())
    pad = param_field(tuple, default=())
    pooling_convention = param_field(str, default="valid",
                                     enum=("valid", "full"))
    cudnn_off = param_field(bool, default=False)


_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


@register_op("Pooling", param_cls=PoolParam)
def _pooling(params, x):
    spatial = x.dim() - 2
    if params.global_pool:
        axes = tuple(range(2, x.dim()))
        if params.pool_type == "max":
            return torch.amax(x, dim=axes, keepdim=True)
        if params.pool_type == "sum":
            return torch.sum(x, dim=axes, keepdim=True)
        return torch.mean(x, dim=axes, keepdim=True)
    if spatial == 1:   # as 2-D with unit height, one path for both
        return _pooling(params.__class__(
            kernel=(1,) + params.kernel, pool_type=params.pool_type,
            stride=(1,) + (params.stride or (1,)),
            pad=(0,) + (params.pad or (0,)),
            pooling_convention=params.pooling_convention),
            x[:, :, None])[:, :, 0]
    if spatial not in _MAX_POOL:
        raise MXNetError("Pooling: %d-D input is not yet ported (ROADMAP A3)"
                         % spatial)
    kernel = tuple(params.kernel)
    stride = tuple(params.stride or (1,) * spatial)
    pad = tuple(params.pad or (0,) * spatial)
    extra = [0] * spatial
    if params.pooling_convention == "full":
        # ceil output size: pad extra on the RIGHT only (reference), which
        # is not torch's ceil_mode
        for i in range(spatial):
            rem = (x.shape[2 + i] + 2 * pad[i] - kernel[i]) % stride[i]
            extra[i] = (stride[i] - rem) % stride[i] if rem else 0
    native = not any(extra) and all(2 * p <= k for p, k in zip(pad, kernel))
    if not native:
        # explicit padding: -inf for max (the reference's init value), 0
        # for the sums; then pool without padding
        widths = []
        for i in reversed(range(spatial)):
            widths += [pad[i], pad[i] + extra[i]]
        fill = -math.inf if params.pool_type == "max" else 0.0
        x = F.pad(x, widths, value=fill)
        pad = (0,) * spatial
    if params.pool_type == "max":
        return _MAX_POOL[spatial](x, kernel, stride, pad)
    # the window SUM (zeros in the padding), then / kernel size for avg
    summed = _AVG_POOL[spatial](x, kernel, stride, pad,
                                count_include_pad=True, divisor_override=1)
    if params.pool_type == "sum":
        return summed
    return summed / float(_np.prod(kernel))


# ---------------------------------------------------------------------------
# Activation (nn/activation.cc)
# ---------------------------------------------------------------------------


class ActivationParam(Params):
    act_type = param_field(str, required=True,
                           enum=("relu", "sigmoid", "tanh", "softrelu",
                                 "softsign"))


_ACTS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    "softsign": F.softsign,
}


@register_op("Activation", param_cls=ActivationParam)
def _activation(params, x):
    return _ACTS[params.act_type](x)


# ---------------------------------------------------------------------------
# BatchNorm (nn/batch_norm.cc)
# ---------------------------------------------------------------------------


class BatchNormParam(Params):
    eps = param_field(float, default=1e-3)
    momentum = param_field(float, default=0.9)
    fix_gamma = param_field(bool, default=True)
    use_global_stats = param_field(bool, default=False)
    output_mean_var = param_field(bool, default=False)
    axis = param_field(int, default=1)
    cudnn_off = param_field(bool, default=False)


@register_op("BatchNorm", param_cls=BatchNormParam,
             input_names=("data", "gamma", "beta"),
             aux_names=("moving_mean", "moving_var"),
             num_outputs=lambda p: 3 if (p and p.output_mean_var) else 1,
             need_train=True)
def _batch_norm(params, x, gamma, beta, moving_mean, moving_var,
                is_train=False):
    if params.output_mean_var:
        raise MXNetError("BatchNorm(output_mean_var=True) is not yet ported "
                         "(ROADMAP A3)")
    ax = params.axis % x.dim()
    xf = x.float()
    if ax != 1:
        xf = xf.movedim(ax, 1)
    if params.fix_gamma:
        # ones carry no autograd history: gamma gets a zero gradient
        gamma = torch.ones_like(gamma)
    gamma, beta = gamma.float(), beta.float()
    if is_train and not params.use_global_stats:
        out = F.batch_norm(xf, None, None, gamma, beta, training=True,
                           eps=params.eps)
        with torch.no_grad():
            red = [d for d in range(xf.dim()) if d != 1]
            var, mean = torch.var_mean(xf, dim=red, correction=0)
            mom = params.momentum
            new_mean = moving_mean * mom + mean * (1 - mom)
            new_var = moving_var * mom + var * (1 - mom)
    else:
        out = F.batch_norm(xf, moving_mean, moving_var, gamma, beta,
                           training=False, eps=params.eps)
        new_mean, new_var = moving_mean, moving_var
    if ax != 1:
        out = out.movedim(1, ax)
    return out.to(x.dtype), new_mean, new_var


# ---------------------------------------------------------------------------
# Loss-layer ops with the reference's backward (they emit their own
# gradient; the head gradient enters multiplicatively)
# ---------------------------------------------------------------------------


class _LossOp(torch.autograd.Function):
    """``forward(data, label)`` -> out; d(data) = ``backward_grad(data,
    label) * g`` and d(label) = 0: the reference loss layers emit their
    own gradient, and the head gradient (ones in every standard backward)
    enters multiplicatively. The ``jax.custom_vjp`` of ``_loss_op``."""

    @staticmethod
    def forward(ctx, data, label, forward, backward_grad):
        ctx.backward_grad = backward_grad
        ctx.save_for_backward(data, label)
        return forward(data, label)

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        return ((ctx.backward_grad(data, label) * g).to(data.dtype),
                torch.zeros_like(label), None, None)


def _loss_op(forward, backward_grad):
    return lambda data, label: _LossOp.apply(data, label, forward,
                                             backward_grad)


class SoftmaxOutputParam(Params):
    grad_scale = param_field(float, default=1.0)
    ignore_label = param_field(float, default=-1.0)
    multi_output = param_field(bool, default=False)
    use_ignore = param_field(bool, default=False)
    preserve_shape = param_field(bool, default=False)
    normalization = param_field(str, default="null",
                                enum=("null", "batch", "valid"))
    out_grad = param_field(bool, default=False)
    smooth_alpha = param_field(float, default=0.0)


def _softmax_output_impl(params):
    def axis_of(data):
        return 1 if params.multi_output or data.dim() > 2 else -1

    def forward(data, label):
        return F.softmax(data, dim=axis_of(data))

    def backward_grad(data, label):
        axis = axis_of(data)
        prob = F.softmax(data, dim=axis)
        lab = label.to(torch.int32).long()
        # one-hot by comparison: a label outside [0, C) (the ignore label)
        # gives a zero row, as jax.nn.one_hot does
        classes = torch.arange(data.shape[axis], device=data.device)
        oh = (lab.unsqueeze(-1) == classes).to(prob.dtype)
        if axis == 1:
            oh = oh.movedim(-1, 1)
        grad = prob - oh
        valid = torch.ones(lab.shape, dtype=prob.dtype, device=prob.device)
        if params.use_ignore:
            valid = (lab != int(params.ignore_label)).to(prob.dtype)
            grad = grad * valid.unsqueeze(axis)
        if params.normalization == "batch":
            grad = grad / data.shape[0]
        elif params.normalization == "valid":
            grad = grad / torch.clamp(valid.sum(), min=1.0)
        return grad * params.grad_scale

    return forward, backward_grad


@register_op("SoftmaxOutput", aliases=("Softmax",),
             param_cls=SoftmaxOutputParam, input_names=("data", "label"))
def _softmax_output(params, data, label):
    return _loss_op(*_softmax_output_impl(params))(data, label)
