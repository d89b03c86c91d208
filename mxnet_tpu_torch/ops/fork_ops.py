"""The fork's own four ops, in the port: ``LSoftmax``, ``MultiLogistic``,
``WeightedL1`` and ``Correlation1D`` (``mxnet_tpu/ops/fork_ops.py``;
reference src/operator/{lsoftmax,multi_logistic,weighted_l1,
correlation1D}.cc).

- ``LSoftmax``'s large-margin logit exists only in training; in
  inference the op is the plain product with the weight. Its gradient is
  autograd's through the piecewise logit.
- ``MultiLogistic`` and ``WeightedL1`` are loss layers with the
  reference's hand-written backward: ``nn._loss_op``, whose gradient is
  ``backward_grad * g``, so a supervised step's loss-scale seed reaches
  them as it reaches ``SoftmaxOutput``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import Params, param_field
from .nn import _loss_op
from .registry import register_op


class LSoftmaxParam(Params):
    margin = param_field(int, default=2)
    beta = param_field(float, default=1.0)
    beta_min = param_field(float, default=0.0)
    scale = param_field(float, default=1.0)
    num_hidden = param_field(int, required=True)
    verbose = param_field(bool, default=False)


@register_op("LSoftmax", param_cls=LSoftmaxParam,
             input_names=("data", "weight", "label"), num_outputs=3,
             output_names=("output", "data_norm", "weight_norm"),
             need_train=True)
def _lsoftmax(params, x, w, label, is_train=False):
    """Large-margin softmax logits (lsoftmax.cu:81-89): in training,
    out[i, y_i] becomes ((-1)^k cos(m t) - 2k) |x_i| |w_y|, blended with
    the plain logit by ``beta``."""
    m = params.margin
    out = torch.matmul(x, w.t())
    x_norm = torch.sqrt(torch.sum(x * x, dim=1) + 1e-12)
    w_norm = torch.sqrt(torch.sum(w * w, dim=1) + 1e-12)
    if not is_train:
        return out, x_norm, w_norm
    yi = label.to(torch.int64)
    fo = out.gather(1, yi[:, None])[:, 0]
    wn_y = w_norm[yi]
    cos_t = torch.clamp(fo / (x_norm * wn_y), -1.0, 1.0)
    # k with cos_t in [cos((k+1) pi / m), cos(k pi / m)]
    table = torch.tensor([math.cos(i * math.pi / m) for i in range(1, m + 1)],
                         dtype=out.dtype, device=out.device)
    k = (cos_t[:, None] < table).to(torch.int32).sum(dim=1).to(out.dtype)
    # cos(m t) by the binomial expansion
    sin2 = 1.0 - cos_t * cos_t
    cos_mt = torch.zeros_like(cos_t)
    for j in range(m // 2 + 1):
        cos_mt = cos_mt + ((-1) ** j) * math.comb(m, 2 * j) * \
            torch.pow(cos_t, m - 2 * j) * torch.pow(sin2, j)
    psi = torch.pow(torch.full_like(k, -1.0), k) * cos_mt - 2.0 * k
    blended = (psi * x_norm * wn_y + params.beta * fo) / (1.0 + params.beta)
    hit = F.one_hot(yi, out.shape[1]).to(torch.bool)
    return torch.where(hit, blended[:, None], out), x_norm, w_norm


class MultiLogisticParam(Params):
    grad_scale = param_field(float, default=1.0)
    p = param_field(float, default=2.0)
    weight = param_field(float, default=1.0)


@register_op("MultiLogistic", param_cls=MultiLogisticParam,
             input_names=("data", "label"))
def _multi_logistic(params, data, label):
    """Sigmoid forward; backward (sig - label) * (w label + (1 - label))
    * grad_scale (multi_logistic-inl.h Backward)."""
    def backward_grad(d, lab):
        grad = torch.sigmoid(d) - lab
        return params.grad_scale * (grad * lab * params.weight
                                    + grad * (1 - lab))

    return _loss_op(lambda d, lab: torch.sigmoid(d), backward_grad)(data,
                                                                   label)


class WeightedL1Param(Params):
    grad_scale = param_field(float, default=1.0)


@register_op("WeightedL1", param_cls=WeightedL1Param,
             input_names=("data", "label"))
def _weighted_l1(params, data, label):
    """Identity forward; backward grad_scale * sign(out - label) where
    label != 0 (weighted_l1-inl.h Backward with its binary mask)."""
    def backward_grad(d, lab):
        return params.grad_scale * torch.sign(d - lab) * \
            (lab != 0).to(d.dtype)

    return _loss_op(lambda d, lab: d, backward_grad)(data, label)


class Correlation1DParam(Params):
    kernel_size = param_field(int, default=1)
    max_displacement = param_field(int, default=1)
    stride1 = param_field(int, default=1)
    stride2 = param_field(int, default=1)
    pad_size = param_field(int, default=0)
    single_side = param_field(int, default=0)
    is_multiply = param_field(bool, default=True)


@register_op("Correlation1D", param_cls=Correlation1DParam,
             input_names=("data1", "data2"))
def _correlation1d(params, data1, data2):
    """Horizontal cost volume (correlation1D-inl.h): out[:, d, y, x] is
    the mean over the kernel window and the channels of data1[..., x] *
    data2[..., x + disp_d], the displacements one- or two-sided. The
    shifts roll around the padded width, as the reference's do."""
    pad = params.pad_size
    k = params.kernel_size
    kr = (k - 1) // 2
    s2 = params.stride2
    ngr = params.max_displacement // s2
    if params.single_side == 0:
        disps = [d * s2 for d in range(-ngr, ngr + 1)]
    elif params.single_side < 0:
        disps = [d * s2 for d in range(-ngr, 1)]
    else:
        disps = [d * s2 for d in range(0, ngr + 1)]
    p1 = F.pad(data1, (pad, pad))
    p2 = F.pad(data2, (pad, pad))
    W = data1.shape[3]
    outs = []
    for d in disps:
        prod = p1 * torch.roll(p2, -d, dims=3)
        if k > 1:
            prod = sum(torch.roll(prod, -o, dims=3)
                       for o in range(-kr, kr + 1)) / k
        outs.append(prod.mean(dim=1)[:, :, pad:pad + W])
    return torch.stack(outs, dim=1)
