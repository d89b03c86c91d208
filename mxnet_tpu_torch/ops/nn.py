"""Neural-network ops of the port, plain PyTorch on NCHW tensors.

Counterpart of ``mxnet_tpu/ops/nn.py``: FullyConnected (L70), Convolution
(L112) and Deconvolution (L145), Pooling (L187), Activation and LeakyReLU
(L242-283), the softmax family (L296-320), BatchNorm (L339), LayerNorm,
InstanceNorm, L2Normalization and LRN (L375-442), Dropout (L456),
Embedding (L480), UpSampling (L498), the loss layers SoftmaxOutput, the
regression outputs, SVMOutput and MakeLoss (L519-675), with
``loss_grad_scale_scope`` (L26-51), and the fused RNN (L683-824) with its
packed parameter layout.
Convolution, matmul and BatchNorm go to torch's own calls (cuDNN/cuBLAS
on the card), as the JAX package leaves them to XLA; the conventions are
the reference's, not torch's:

- Pooling: average pooling divides by the whole kernel, padding included;
  ``pooling_convention="full"`` pads only on the right (not torch's
  ``ceil_mode``); the global pool is a mean; 4 and more spatial dims
  unfold every window and reduce it.
- BatchNorm: the batch variance is the biased one; the moving statistics
  update as ``mm * momentum + mean * (1 - momentum)`` (not torch's
  running-stat update, which keeps the unbiased variance);
  ``fix_gamma=True`` normalizes with ones and gives gamma a zero
  gradient; it computes in float32.
- SoftmaxOutput's gradient is the reference's ``(softmax - onehot) *
  grad_scale`` times the head gradient, not autograd of softmax; labels
  get a zero gradient. The other loss layers likewise emit the
  reference's gradient.
- Dropout and rrelu draw from the ``torch.Generator`` their caller hands
  them (``rng``); at ``p=0``, in predict mode and outside training they
  return their input itself.
- LeakyReLU's ``gelu`` is jax's default tanh approximation.
- RNN runs torch's cuDNN RNN (``torch._VF``) on CUDA tensors, over views
  into the reference's packed ``parameters``; on other devices a per-step
  loop that transcribes the reference's scan. Its dropout between layers
  draws from ``rng``, never from cuDNN's dropout state.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import numpy as _np
import torch
import torch.nn.functional as F

from ..base import MXNetError, Params, param_field
from .random_ops import uniform01
from .registry import register_op
from .tensor import index_of, one_hot

# ---------------------------------------------------------------------------
# The supervised step's loss scale for IMPLICIT loss sites (reference
# L26-51): a loss head gets the scale through its seed (``_LossOp``), but
# an op that injects a gradient mid-chain has no seed to carry it. The
# supervised step sets the scale (a 0-d tensor) around its forward and
# backward; such an op reads it in its forward and multiplies its injected
# gradient by it. None everywhere else.
# ---------------------------------------------------------------------------
_loss_grad_scale = contextvars.ContextVar("mx_loss_grad_scale", default=None)


def current_loss_grad_scale():
    """The loss scale of a supervised step in progress, or None."""
    return _loss_grad_scale.get()


@contextlib.contextmanager
def loss_grad_scale_scope(scale):
    token = _loss_grad_scale.set(scale)
    try:
        yield
    finally:
        _loss_grad_scale.reset(token)

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
    if nd not in _CONV:
        # the reference reads every layout as NC* (its `layout` attr is
        # accepted and ignored) and convolves 1-D to 3-D kernels
        raise MXNetError("Convolution: %d-D kernels are not supported, as "
                         "in the reference (1-D to 3-D)" % nd)
    return _CONV[nd](x, weight, bias, stride=params.stride or (1,) * nd,
                     padding=params.pad or (0,) * nd,
                     dilation=params.dilate or (1,) * nd,
                     groups=params.num_group)


class DeconvParam(ConvParam):
    adj = param_field(tuple, default=())
    target_shape = param_field(tuple, default=())


@register_op("Deconvolution", param_cls=DeconvParam, input_names=_conv_inputs)
def _deconvolution(params, x, weight, bias=None):
    """The transposed convolution, weight (C_in, F / num_group, kh, kw) as
    the reference's (and torch's); ``adj`` is the output padding."""
    nd = len(params.kernel)
    if nd != 2:
        raise MXNetError("Deconvolution only supports 2D kernels, as in "
                         "the reference")
    return F.conv_transpose2d(x, weight, bias,
                              stride=params.stride or (1, 1),
                              padding=params.pad or (0, 0),
                              output_padding=params.adj or (0, 0),
                              groups=params.num_group,
                              dilation=params.dilate or (1, 1))


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


def _pool_windows(x, kernel, stride, pool_type):
    """Pooling over 4 or more spatial dims of an input padded already:
    every window unfolded, then reduced. A max sends its gradient to the
    window's first maximum, as the reference's ``reduce_window`` and
    torch's pooling kernels do."""
    nd = len(kernel)
    for i in range(nd):
        x = x.unfold(2 + i, kernel[i], stride[i])
    win = x.reshape(x.shape[:2 + nd] + (-1,))
    if pool_type == "max":
        return win.max(dim=-1).values
    summed = win.sum(dim=-1)
    return summed if pool_type == "sum" else \
        summed / float(_np.prod(kernel))


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
    native = spatial in _MAX_POOL and not any(extra) and \
        all(2 * p <= k for p, k in zip(pad, kernel))
    if not native:
        # explicit padding: -inf for max (the reference's init value), 0
        # for the sums; then pool without padding
        widths = []
        for i in reversed(range(spatial)):
            widths += [pad[i], pad[i] + extra[i]]
        fill = -math.inf if params.pool_type == "max" else 0.0
        x = F.pad(x, widths, value=fill)
        pad = (0,) * spatial
    if spatial not in _MAX_POOL:
        return _pool_windows(x, kernel, stride, params.pool_type)
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


class LeakyReLUParam(Params):
    act_type = param_field(str, default="leaky",
                           enum=("leaky", "prelu", "elu", "selu", "rrelu",
                                 "gelu"))
    slope = param_field(float, default=0.25)
    lower_bound = param_field(float, default=0.125)
    upper_bound = param_field(float, default=0.334)


def _lrelu_inputs(p):
    if p is not None and p.act_type == "prelu":
        return ("data", "gamma")
    return ("data",)


@register_op("LeakyReLU", param_cls=LeakyReLUParam,
             input_names=_lrelu_inputs, need_rng=True, need_train=True)
def _leaky_relu(params, x, gamma=None, is_train=False, rng=None):
    t = params.act_type
    if t == "leaky":
        return torch.where(x > 0, x, params.slope * x)
    if t == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (x.dim() - 2)) \
            if gamma.dim() == 1 else gamma
        return torch.where(x > 0, x, g * x)
    if t == "elu":
        return torch.where(x > 0, x, params.slope * (torch.exp(x) - 1.0))
    if t == "selu":
        return 1.0507009873554805 * torch.where(
            x > 0, x, 1.6732632423543772 * (torch.exp(x) - 1.0))
    if t == "gelu":
        return F.gelu(x, approximate="tanh")
    # rrelu: a random slope a lane in training, the mean slope otherwise
    if is_train:
        lo, hi = params.lower_bound, params.upper_bound
        slope = uniform01(x.shape, rng, x.device, x.dtype) * (hi - lo) + lo
    else:
        slope = (params.lower_bound + params.upper_bound) / 2.0
    return torch.where(x > 0, x, slope * x)


# ---------------------------------------------------------------------------
# softmax family (nn/softmax.cc)
# ---------------------------------------------------------------------------


class SoftmaxParam(Params):
    axis = param_field(int, default=-1)
    temperature = param_field(float, default=None)


@register_op("softmax", param_cls=SoftmaxParam)
def _softmax(params, x):
    if params.temperature:
        x = x / params.temperature
    return F.softmax(x, dim=params.axis)


@register_op("log_softmax", param_cls=SoftmaxParam)
def _log_softmax(params, x):
    if params.temperature:
        x = x / params.temperature
    return F.log_softmax(x, dim=params.axis)


class SoftmaxActivationParam(Params):
    mode = param_field(str, default="instance", enum=("instance", "channel"))


@register_op("SoftmaxActivation", param_cls=SoftmaxActivationParam)
def _softmax_activation(params, x):
    if params.mode == "instance" and x.dim() > 2:
        return F.softmax(x.reshape(x.shape[0], -1), dim=-1).reshape(x.shape)
    return F.softmax(x, dim=1 if params.mode == "channel" else -1)


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
    if params.output_mean_var:
        # the statistics the output was normalized with, and the inverse
        # standard deviation (differentiable, as the reference's are)
        if is_train and not params.use_global_stats:
            red = [d for d in range(xf.dim()) if d != 1]
            var, mean = torch.var_mean(xf, dim=red, correction=0)
        else:
            mean, var = moving_mean, moving_var
        inv = torch.rsqrt(var + params.eps)
        return out.to(x.dtype), mean, inv, new_mean, new_var
    return out.to(x.dtype), new_mean, new_var


class LayerNormParam(Params):
    axis = param_field(int, default=-1)
    eps = param_field(float, default=1e-5)
    output_mean_var = param_field(bool, default=False)


@register_op("LayerNorm", param_cls=LayerNormParam,
             input_names=("data", "gamma", "beta"),
             num_outputs=lambda p: 3 if (p and p.output_mean_var) else 1)
def _layer_norm(params, x, gamma, beta):
    ax = params.axis % x.dim()
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=ax, keepdim=True, correction=0)
    inv = torch.rsqrt(var + params.eps)
    bshape = tuple(x.shape[ax] if i == ax else 1 for i in range(x.dim()))
    out = ((xf - mean) * inv * gamma.reshape(bshape)
           + beta.reshape(bshape)).to(x.dtype)
    if params.output_mean_var:
        return out, mean.squeeze(ax), inv.squeeze(ax)
    return out


class InstanceNormParam(Params):
    eps = param_field(float, default=1e-3)


@register_op("InstanceNorm", param_cls=InstanceNormParam,
             input_names=("data", "gamma", "beta"))
def _instance_norm(params, x, gamma, beta):
    red = tuple(range(2, x.dim()))
    var, mean = torch.var_mean(x, dim=red, keepdim=True, correction=0)
    bshape = (1, -1) + (1,) * (x.dim() - 2)
    return ((x - mean) * torch.rsqrt(var + params.eps)
            * gamma.reshape(bshape) + beta.reshape(bshape))


class L2NormParam(Params):
    eps = param_field(float, default=1e-10)
    mode = param_field(str, default="instance",
                       enum=("instance", "channel", "spatial"))


@register_op("L2Normalization", param_cls=L2NormParam)
def _l2_normalization(params, x):
    red = {"instance": tuple(range(1, x.dim())), "channel": (1,),
           "spatial": tuple(range(2, x.dim()))}[params.mode]
    norm = torch.sqrt(torch.sum(torch.square(x), dim=red, keepdim=True)
                      + params.eps)
    return x / norm


class LRNParam(Params):
    alpha = param_field(float, default=1e-4)
    beta = param_field(float, default=0.75)
    knorm = param_field(float, default=2.0)
    nsize = param_field(int, required=True)


@register_op("LRN", param_cls=LRNParam)
def _lrn(params, x):
    half = params.nsize // 2
    sq = F.pad(torch.square(x).movedim(1, -1), (half, half)).movedim(-1, 1)
    acc = torch.zeros_like(x)
    for i in range(params.nsize):
        acc = acc + sq.narrow(1, i, x.shape[1])
    scale = torch.pow(params.knorm + params.alpha * acc / params.nsize,
                      -params.beta)
    return x * scale


# ---------------------------------------------------------------------------
# Dropout (nn/dropout.cc)
# ---------------------------------------------------------------------------


class DropoutParam(Params):
    p = param_field(float, default=0.5)
    mode = param_field(str, default="training", enum=("training", "always"))
    axes = param_field(tuple, default=())


@register_op("Dropout", param_cls=DropoutParam, need_rng=True,
             need_train=True)
def _dropout(params, x, is_train=False, rng=None):
    """Keep each lane with probability ``1 - p`` and scale it by
    ``1 / (1 - p)``; ``axes`` share one draw along those dims. The input
    itself at ``p=0`` and outside training (unless ``mode="always"``)."""
    if params.p <= 0 or (not is_train and params.mode != "always"):
        return x
    keep = 1.0 - params.p
    shape = tuple(1 if i in params.axes else s for i, s in enumerate(x.shape))
    mask = uniform01(shape, rng, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


# ---------------------------------------------------------------------------
# Embedding (tensor/indexing_op.cc Embedding)
# ---------------------------------------------------------------------------


class EmbeddingParam(Params):
    input_dim = param_field(int, required=True)
    output_dim = param_field(int, required=True)
    dtype = param_field(str, default="float32")
    sparse_grad = param_field(bool, default=False)


@register_op("Embedding", param_cls=EmbeddingParam,
             input_names=("data", "weight"))
def _embedding(params, data, weight):
    return F.embedding(index_of(data), weight)


# ---------------------------------------------------------------------------
# UpSampling (upsampling.cc)
# ---------------------------------------------------------------------------


class UpSamplingParam(Params):
    scale = param_field(int, required=True)
    sample_type = param_field(str, default="nearest",
                              enum=("nearest", "bilinear"))
    num_args = param_field(int, default=1)
    num_filter = param_field(int, default=0)
    multi_input_mode = param_field(str, default="concat")


@register_op("UpSampling", param_cls=UpSamplingParam,
             key_var_num_args="num_args",
             input_names=lambda p: tuple(
                 "arg%d" % i for i in range(p.num_args if p else 1)))
def _upsampling(params, *args):
    """The first input scaled (the reference reads only ``args[0]``)."""
    x, s = args[0], params.scale
    if params.sample_type == "nearest":
        return x.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)
    # jax.image.resize's bilinear: half-pixel centres
    return F.interpolate(x, scale_factor=s, mode="bilinear",
                         align_corners=False)


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


class RegOutputParam(Params):
    grad_scale = param_field(float, default=1.0)


def _regression_output(name, forward, residual):
    @register_op(name, param_cls=RegOutputParam,
                 input_names=("data", "label"))
    def op(params, data, label):
        def backward_grad(d, lab):
            return residual(d, lab.reshape(d.shape)) * params.grad_scale \
                / d.shape[0]
        return _loss_op(lambda d, lab: forward(d), backward_grad)(data, label)
    return op


_regression_output("LinearRegressionOutput", lambda d: d,
                   lambda d, lab: d - lab)
_regression_output("MAERegressionOutput", lambda d: d,
                   lambda d, lab: torch.sign(d - lab))
_regression_output("LogisticRegressionOutput", torch.sigmoid,
                   lambda d, lab: torch.sigmoid(d) - lab)


class SVMOutputParam(Params):
    margin = param_field(float, default=1.0)
    regularization_coefficient = param_field(float, default=1.0)
    use_linear = param_field(bool, default=False)


@register_op("SVMOutput", param_cls=SVMOutputParam,
             input_names=("data", "label"))
def _svm_output(params, data, label):
    def backward_grad(d, lab):
        sign = one_hot(lab, d.shape[-1], d.dtype) * 2 - 1
        gap = params.margin - sign * d
        if params.use_linear:
            g = torch.where(gap > 0, -sign, torch.zeros_like(d))
        else:
            g = torch.where(gap > 0, -2 * gap * sign, torch.zeros_like(d))
        return g * params.regularization_coefficient

    return _loss_op(lambda d, lab: d, backward_grad)(data, label)


class MakeLossParam(Params):
    grad_scale = param_field(float, default=1.0)
    valid_thresh = param_field(float, default=0.0)
    normalization = param_field(str, default="null",
                                enum=("null", "batch", "valid"))


class _MakeLoss(torch.autograd.Function):
    """Forward identity; the backward seeds ``grad_scale`` (make_loss.cc),
    times the head gradient (ones but under a loss scale)."""

    @staticmethod
    def forward(ctx, d, params):
        ctx.params = params
        ctx.save_for_backward(d)
        return d.view_as(d)

    @staticmethod
    def backward(ctx, g):
        (d,) = ctx.saved_tensors
        p = ctx.params
        full = torch.full(d.shape, p.grad_scale, dtype=d.dtype,
                          device=d.device)
        if p.normalization == "batch":
            full = torch.full(d.shape, p.grad_scale / d.shape[0],
                              dtype=d.dtype, device=d.device)
        elif p.normalization == "valid":
            valid = torch.clamp((d > p.valid_thresh).float().sum(), min=1.0)
            full = full / valid
        return full * g, None


@register_op("MakeLoss", param_cls=MakeLossParam)
def _make_loss_op(params, data):
    return _MakeLoss.apply(data, params)


# ---------------------------------------------------------------------------
# Fused RNN (rnn-inl.h; reference L683-824, a lax.scan there). On the card
# the layers run torch's cuDNN RNN (``torch._VF``) over views into the one
# ``parameters`` tensor, so the gradient reaches it; elsewhere the plain
# per-step loop below, which transcribes the reference's scan.
# ---------------------------------------------------------------------------


class RNNParam(Params):
    state_size = param_field(int, required=True)
    num_layers = param_field(int, required=True)
    bidirectional = param_field(bool, default=False)
    mode = param_field(str, required=True,
                       enum=("rnn_relu", "rnn_tanh", "lstm", "gru"))
    p = param_field(float, default=0.0)
    state_outputs = param_field(bool, default=False)
    # accepted and never applied, as in the reference (ROADMAP §C)
    lstm_state_clip_min = param_field(float, default=None)
    lstm_state_clip_max = param_field(float, default=None)


def _rnn_inputs(p):
    if p is not None and p.mode == "lstm":
        return ("data", "parameters", "state", "state_cell")
    return ("data", "parameters", "state")


def _rnn_n_outputs(p):
    if p is None or not p.state_outputs:
        return 1
    return 3 if p.mode == "lstm" else 2


def _gates(mode):
    return {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]


def rnn_param_size(mode, input_size, state_size, num_layers, bidirectional):
    """Total packed parameter count. The packing: all weights (layer-major,
    direction-minor, i2h then h2h), then all biases in the same order."""
    g = _gates(mode)
    d = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        ins = input_size if layer == 0 else state_size * d
        size += d * g * state_size * (ins + state_size)
    return size + num_layers * d * 2 * g * state_size


def unpack_rnn_params(flat, mode, input_size, state_size, num_layers,
                      bidirectional):
    """``[layer][direction] -> [wi, wh, bi, bh]``, each a view into
    ``flat`` (reference ``_unpack_rnn_params`` L727)."""
    g = _gates(mode)
    d = 2 if bidirectional else 1
    H = state_size
    layers, off = [], 0
    for layer in range(num_layers):
        ins = input_size if layer == 0 else H * d
        dirs = []
        for _ in range(d):
            wi = flat[off:off + g * H * ins].reshape(g * H, ins)
            off += g * H * ins
            wh = flat[off:off + g * H * H].reshape(g * H, H)
            off += g * H * H
            dirs.append([wi, wh, None, None])
        layers.append(dirs)
    for layer in range(num_layers):
        for dd in range(d):
            layers[layer][dd][2] = flat[off:off + g * H]
            off += g * H
            layers[layer][dd][3] = flat[off:off + g * H]
            off += g * H
    return layers


def _rnn_cell_step(mode):
    """One step ``(carry, xw_t, wh, bh) -> (carry, out)`` (reference
    L746-774)."""
    if mode == "lstm":
        def step(carry, xw, wh, bh):
            h, c = carry
            gates = xw + h @ wh.t() + bh
            i, f, gg, o = gates.chunk(4, dim=-1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            c = f * c + i * torch.tanh(gg)
            h = o * torch.tanh(c)
            return (h, c), h
    elif mode == "gru":
        def step(carry, xw, wh, bh):
            (h,) = carry
            xr, xz, xn = xw.chunk(3, dim=-1)
            hr, hz, hn = (h @ wh.t() + bh).chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = (1 - z) * n + z * h
            return (h,), h
    else:
        act = torch.relu if mode == "rnn_relu" else torch.tanh

        def step(carry, xw, wh, bh):
            (h,) = carry
            h = act(xw + h @ wh.t() + bh)
            return (h,), h
    return step


def run_rnn_layer_plain(mode, x, wi, wh, bi, bh, h0, c0, reverse=False):
    """One direction of one layer: ``x`` (T, N, I) -> (out (T, N, H), h_T,
    c_T or None). The input products over all steps come first, as one
    matmul (reference L776-791)."""
    step = _rnn_cell_step(mode)
    xw = x @ wi.t() + bi
    carry = (h0, c0) if mode == "lstm" else (h0,)
    order = range(x.shape[0] - 1, -1, -1) if reverse else range(x.shape[0])
    outs = [None] * x.shape[0]
    for t in order:
        carry, outs[t] = step(carry, xw[t], wh, bh)
    return (torch.stack(outs), carry[0],
            carry[1] if mode == "lstm" else None)


#: calls of the RNN op by route ("cudnn": torch._VF on the card, "plain":
#: the per-step loop); the chip check and the tests read them
RNN_COUNTS = {"cudnn": 0, "plain": 0}


def rnn_route(device):
    """``"cudnn"`` for a CUDA tensor, ``"plain"`` elsewhere: on the card the
    op runs torch's cuDNN RNN or raises; it never falls back."""
    return "cudnn" if torch.device(device).type == "cuda" else "plain"


def _vf_layers(mode, x, weights, h0, c0, num_layers, bidirectional, train):
    """``num_layers`` layers through one ``torch._VF`` call (cuDNN on the
    card, torch's own RNN on the CPU) with dropout 0. ``weights``: per
    layer and direction ``[wi, wh, bi, bh]``, in torch's order."""
    flat = [w for dirs in weights for dd in dirs for w in dd]
    fn = getattr(torch._VF, mode)
    # cuDNN takes dense inputs and states only (a graph's zero states are
    # broadcast views)
    x, h0 = x.contiguous(), h0.contiguous()
    if mode == "lstm":
        c0 = c0.contiguous()
        out, hT, cT = fn(x, (h0, c0), flat, True, num_layers, 0.0, train,
                         bidirectional, False)
        return out, hT, cT
    out, hT = fn(x, h0, flat, True, num_layers, 0.0, train, bidirectional,
                 False)
    return out, hT, None


def rnn_forward(params, data, parameters, state, state_cell=None,
                is_train=False, rng=None, route=None):
    """The RNN op on tensors through ``route`` (``rnn_route`` of the data's
    device by default). Between layers, in training at ``p > 0``, each
    layer's output is masked from ``rng`` as Dropout masks (reference
    L814-818): the cuDNN route then runs one ``_VF`` call a layer, so
    cuDNN's own dropout state never draws."""
    mode, H = params.mode, params.state_size
    L, bi = params.num_layers, params.bidirectional
    d = 2 if bi else 1
    T, N, In = data.shape
    if data.device.type == "meta":
        out = torch.empty((T, N, d * H), dtype=data.dtype, device="meta")
        if not params.state_outputs:
            return out
        hs = torch.empty((L * d, N, H), dtype=data.dtype, device="meta")
        return (out, hs, hs.clone()) if mode == "lstm" else (out, hs)
    route = route or rnn_route(data.device)
    RNN_COUNTS[route] += 1
    layers = unpack_rnn_params(parameters, mode, In, H, L, bi)
    drop = params.p > 0 and is_train and L > 1
    x, h_states, c_states = data, [], []
    if route == "cudnn":
        # cuDNN keeps what its backward needs only in training mode
        train = bool(is_train or torch.is_grad_enabled())
        groups = [(li, li + 1) for li in range(L)] if drop else [(0, L)]
        for lo, hi in groups:
            c0 = state_cell[lo * d:hi * d] if mode == "lstm" else None
            x, hT, cT = _vf_layers(mode, x, layers[lo:hi],
                                   state[lo * d:hi * d], c0, hi - lo, bi,
                                   train)
            h_states.append(hT)
            if cT is not None:
                c_states.append(cT)
            if drop and hi < L:
                x = _dropout(DropoutParam(p=params.p), x, True, rng)
        hs = torch.cat(h_states)
        cs = torch.cat(c_states) if c_states else None
    else:
        for li, dirs in enumerate(layers):
            outs = []
            for di, (wi, wh, b_i, b_h) in enumerate(dirs):
                sidx = li * d + di
                c0 = state_cell[sidx] if mode == "lstm" else None
                o, hT, cT = run_rnn_layer_plain(mode, x, wi, wh, b_i, b_h,
                                                state[sidx], c0,
                                                reverse=(di == 1))
                outs.append(o)
                h_states.append(hT)
                if cT is not None:
                    c_states.append(cT)
            x = outs[0] if d == 1 else torch.cat(outs, dim=-1)
            if drop and li < L - 1:
                x = _dropout(DropoutParam(p=params.p), x, True, rng)
        hs = torch.stack(h_states)
        cs = torch.stack(c_states) if c_states else None
    if not params.state_outputs:
        return x
    return (x, hs, cs) if mode == "lstm" else (x, hs)


@register_op("RNN", param_cls=RNNParam, input_names=_rnn_inputs,
             num_outputs=_rnn_n_outputs, need_train=True, need_rng=True)
def _rnn(params, data, parameters, state, state_cell=None, is_train=False,
         rng=None):
    """data (T, N, I), state (L*D, N, H); outputs (T, N, D*H) and, with
    ``state_outputs``, h_T (and c_T for lstm). Reference
    src/operator/rnn-inl.h."""
    return rnn_forward(params, data, parameters, state, state_cell,
                       is_train=is_train, rng=rng)
