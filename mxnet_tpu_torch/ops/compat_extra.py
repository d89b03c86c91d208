"""The catalog-completing ops of the port and the reference's legacy
aliases (``mxnet_tpu/ops/compat_extra.py``; reference contrib/
psroi_pooling.cc, the rcnn proposal_target, identity_attach_KL_sparse_reg
.cc, tensor/ batch_take, reshape_like, softmax_cross_entropy, _eye,
sparse_retain, cast_storage, the image normalize / to_tensor ops,
ftml_update, the _slice_assign / _scatter family, contrib bipartite
matching, generalized negative binomial sampling, _hypot_scalar and
broadcast_axis).

- ``_contrib_ProposalTarget`` and ``_random_generalized_negative_binomial``
  draw from the op's generator (``rng``), as ``random_ops`` does; they are
  held to the reference by reproducibility and moments, never bit for
  bit. ProposalTarget's shuffled priority takes equal draws in index
  order (a stable sort), as ``lax.top_k`` does.
- ``IdentityAttachKLSparseReg`` is the identity whose backward adds the KL
  sparsity penalty's gradient; a supervised step's loss scale
  (``nn.current_loss_grad_scale``, read in the forward) multiplies the
  penalty, since no head gradient carries the scale to it.
- ``_COMPAT_ALIASES`` resolves the capitalised, ``_v1``, ``_linalg_*``,
  ``_sparse_*`` and other legacy names to their ops;
  ``_register_compat_aliases`` raises when a target is missing.
"""
from __future__ import annotations

import torch

from ..base import MXNetError, Params, param_field
from .elemwise import _scalar_like, round_half_away, torch_dtype
from .multibox import stable_order
from .nn import current_loss_grad_scale
from .random_ops import _gamma, _poisson, uniform01
from .registry import OPS, _ALIASES, find_op, register_op
from .vision import bin_masks, divide, ps_select


# ---------------------------------------------------------------------------
# PSROIPooling (contrib/psroi_pooling.cc)
# ---------------------------------------------------------------------------


class PSROIPoolParam(Params):
    spatial_scale = param_field(float, required=True)
    output_dim = param_field(int, required=True)
    pooled_size = param_field(int, required=True)
    group_size = param_field(int, default=0)


@register_op("_contrib_PSROIPooling", param_cls=PSROIPoolParam,
             input_names=("data", "rois"), aliases=("_contrib_psroi_pooling",))
def _psroi_pooling(params, data, rois):
    """Position-sensitive ROI average pooling: bin (i, j) of a ROI
    averages its channel block over the bin's pixels."""
    k = params.pooled_size
    gs = params.group_size or k
    scale = params.spatial_scale
    _, _, H, W = data.shape
    x1 = round_half_away(rois[:, 1]) * scale
    y1 = round_half_away(rois[:, 2]) * scale
    x2 = (round_half_away(rois[:, 3]) + 1.0) * scale
    y2 = (round_half_away(rois[:, 4]) + 1.0) * scale
    bh = divide(torch.clamp_min(y2 - y1, 0.1)[:, None], k)
    bw = divide(torch.clamp_min(x2 - x1, 0.1)[:, None], k)
    i = torch.arange(k, dtype=torch.float32, device=data.device)
    ymask = bin_masks(torch.floor(y1[:, None] + i * bh),
                      torch.ceil(y1[:, None] + (i + 1) * bh), H)
    xmask = bin_masks(torch.floor(x1[:, None] + i * bw),
                      torch.ceil(x1[:, None] + (i + 1) * bw), W)
    mask = (ymask[:, :, None, :, None]
            & xmask[:, None, :, None, :]).to(data.dtype)   # (R, k, k, H, W)
    counts = torch.clamp_min(mask.sum(dim=(-1, -2)), 1.0)
    img = data[rois[:, 0].to(torch.int64)]
    sums = torch.einsum("rchw,rijhw->rcij", img, mask)
    avg = sums / counts[:, None]
    return ps_select(avg, params.output_dim, gs, k).to(data.dtype)


# ---------------------------------------------------------------------------
# ProposalTarget (the rcnn training target)
# ---------------------------------------------------------------------------


class ProposalTargetParam(Params):
    num_classes = param_field(int, required=True)
    batch_images = param_field(int, required=True)
    batch_rois = param_field(int, required=True)
    fg_fraction = param_field(float, default=0.25)
    fg_overlap = param_field(float, default=0.5)
    box_stds = param_field(tuple, default=(0.1, 0.1, 0.2, 0.2))


@register_op("_contrib_ProposalTarget", param_cls=ProposalTargetParam,
             input_names=("rois", "gt_boxes"), num_outputs=4, need_rng=True,
             output_names=("rois_output", "label", "bbox_target",
                           "bbox_weight"),
             aliases=("_contrib_proposal_target", "ProposalTarget"))
def _proposal_target(params, rois, gt_boxes, rng=None):
    """rois (R, 5); gt_boxes (G, 5) = (x1, y1, x2, y2, cls). Samples
    ``batch_rois`` proposals, ``fg_fraction`` of them foreground, with
    their class labels and class-specific regression targets."""
    R = rois.shape[0]
    n_out = params.batch_rois
    dev = rois.device
    n_fg_max = int(round(params.fg_fraction * n_out))
    boxes = rois[:, 1:5]
    gt = gt_boxes[:, :4]
    gt_cls = gt_boxes[:, 4]
    valid_gt = gt_boxes[:, 2] > gt_boxes[:, 0]
    iw = torch.clamp_min(torch.minimum(boxes[:, 2:3], gt[None, :, 2])
                         - torch.maximum(boxes[:, 0:1], gt[None, :, 0])
                         + 1.0, 0.0)
    ih = torch.clamp_min(torch.minimum(boxes[:, 3:4], gt[None, :, 3])
                         - torch.maximum(boxes[:, 1:2], gt[None, :, 1])
                         + 1.0, 0.0)
    inter = iw * ih
    area_r = (boxes[:, 2] - boxes[:, 0] + 1.0) * (boxes[:, 3] - boxes[:, 1]
                                                  + 1.0)
    area_g = (gt[:, 2] - gt[:, 0] + 1.0) * (gt[:, 3] - gt[:, 1] + 1.0)
    iou = inter / (area_r[:, None] + area_g[None, :] - inter)
    iou = torch.where(valid_gt[None, :], iou, torch.full_like(iou, -1.0))
    best_iou = torch.amax(iou, dim=1)
    best_gt = torch.argmax(iou, dim=1)
    is_fg = best_iou >= params.fg_overlap
    # a shuffled priority: foreground first, then background
    u = uniform01((R,), rng, dev)
    two = torch.full_like(u, 2.0)
    fg_order = stable_order(torch.where(is_fg, u, two), descending=False)
    bg_order = stable_order(torch.where(is_fg, two, u), descending=False)
    n_fg = torch.clamp_max(is_fg.sum(), n_fg_max)
    slot = torch.arange(n_out, device=dev)
    fg_pick = fg_order[torch.clamp(slot, 0, R - 1)]
    bg_pick = bg_order[torch.clamp(slot - n_fg, 0, R - 1)]
    fg_sel = slot < n_fg
    sel = torch.clamp(torch.where(fg_sel, fg_pick, bg_pick), 0, R - 1)
    out_rois = rois[sel]
    matched = best_gt[sel]
    label = torch.where(fg_sel, gt_cls[matched], torch.zeros_like(
        gt_cls[matched]))
    b = boxes[sel]
    g = gt[matched]
    bw = b[:, 2] - b[:, 0] + 1.0
    bh = b[:, 3] - b[:, 1] + 1.0
    bcx = b[:, 0] + 0.5 * (bw - 1)
    bcy = b[:, 1] + 0.5 * (bh - 1)
    gw = g[:, 2] - g[:, 0] + 1.0
    gh = g[:, 3] - g[:, 1] + 1.0
    gcx = g[:, 0] + 0.5 * (gw - 1)
    gcy = g[:, 1] + 0.5 * (gh - 1)
    stds = torch.tensor(params.box_stds, dtype=torch.float32, device=dev)
    t = torch.stack([(gcx - bcx) / bw, (gcy - bcy) / bh,
                     torch.log(gw / bw), torch.log(gh / bh)], dim=1) / stds
    K = params.num_classes
    col = label.to(torch.int64)[:, None] * 4 + torch.arange(4, device=dev)
    hot = torch.zeros((n_out, 4 * K), dtype=torch.bool, device=dev).scatter_(
        1, col, True) & fg_sel[:, None]
    tgt = torch.zeros((n_out, 4 * K), dtype=torch.float32, device=dev)
    tgt = torch.where(hot, tgt.scatter(1, col, t.to(torch.float32)), tgt)
    return out_rois, label, tgt, hot.to(torch.float32)


# ---------------------------------------------------------------------------
# IdentityAttachKLSparseReg (identity_attach_KL_sparse_reg.cc)
# ---------------------------------------------------------------------------


class KLSparseRegParam(Params):
    sparseness_target = param_field(float, default=0.1)
    penalty = param_field(float, default=0.001)
    momentum = param_field(float, default=0.9)


class _KLSparseReg(torch.autograd.Function):
    """Identity forward; the backward adds ``penalty * (-rho / a + (1 -
    rho) / (1 - a))`` for the momentum-averaged activation mean ``a``,
    times a supervised step's loss scale."""

    @staticmethod
    def forward(ctx, x, avg, params, scale):
        a = torch.clamp(avg, 1e-6, 1 - 1e-6)
        rho = params.sparseness_target
        reg = params.penalty * (-rho / a + (1 - rho) / (1 - a))
        if scale is not None:
            reg = reg * scale.to(reg.dtype)
        ctx.save_for_backward(reg)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (reg,) = ctx.saved_tensors
        return g + reg[None], None, None, None


@register_op("IdentityAttachKLSparseReg", param_cls=KLSparseRegParam,
             input_names=("data",), aux_names=("moving_avg",))
def _identity_attach_kl_sparse_reg(params, data, moving_avg):
    mom = params.momentum
    new_avg = mom * moving_avg + (1 - mom) * torch.mean(data, dim=0)
    out = _KLSparseReg.apply(data, new_avg.detach(), params,
                             current_loss_grad_scale())
    return out, new_avg


# ---------------------------------------------------------------------------
# small tensor ops
# ---------------------------------------------------------------------------


@register_op("batch_take", input_names=("a", "indices"))
def _batch_take(params, a, indices):
    """out[i] = a[i, indices[i]]."""
    return a.gather(1, indices.to(torch.int64).reshape(-1, 1))[:, 0]


@register_op("reshape_like", input_names=("lhs", "rhs"))
def _reshape_like(params, lhs, rhs):
    return lhs.reshape(rhs.shape)


class SoftmaxCEParam(Params):
    pass


@register_op("softmax_cross_entropy", param_cls=SoftmaxCEParam,
             input_names=("data", "label"))
def _softmax_cross_entropy(params, data, label):
    """The summed cross-entropy of softmax(data) and integer labels, as a
    (1,) tensor (loss_binary_op.cc)."""
    logp = torch.log_softmax(data, dim=-1)
    picked = logp.gather(1, label.to(torch.int64).reshape(-1, 1))
    return -picked.sum().reshape(1)


class EyeParam(Params):
    N = param_field(int, required=True)
    M = param_field(int, default=0)
    k = param_field(int, default=0)
    dtype = param_field(str, default="float32")
    ctx = param_field(str, default=None)


@register_op("_eye", param_cls=EyeParam, input_names=(), aliases=("eye",))
def _eye(params, device=None):
    M = params.M or params.N
    rows = torch.arange(params.N, device=device)[:, None]
    cols = torch.arange(M, device=device)[None, :]
    return (cols - rows == params.k).to(torch_dtype(params.dtype))


@register_op("_grad_add", input_names=("lhs", "rhs"))
def _grad_add(params, lhs, rhs):
    return lhs + rhs


@register_op("_identity_with_attr_like_rhs", input_names=("lhs", "rhs"))
def _identity_with_attr_like_rhs(params, lhs, rhs):
    return lhs


@register_op("sparse_retain", input_names=("data", "indices"))
def _sparse_retain_op(params, data, indices):
    """The given rows kept, the others zero (the dense form of the rsp
    kernel); indices out of range are dropped."""
    n = data.shape[0]
    idx = indices.to(torch.int64).reshape(-1)
    idx = torch.where(idx < 0, idx + n, idx)
    idx = idx[(idx >= 0) & (idx < n)]
    keep = torch.zeros(n, dtype=torch.bool, device=data.device)
    keep[idx] = True
    return torch.where(keep.reshape((-1,) + (1,) * (data.dim() - 1)), data,
                       torch.zeros_like(data))


class CastStorageParam(Params):
    stype = param_field(str, required=True)


@register_op("cast_storage", param_cls=CastStorageParam,
             input_names=("data",))
def _cast_storage(params, data):
    """Values are dense in the port: the identity, for the API."""
    return data


# ---------------------------------------------------------------------------
# image normalize / to_tensor (image/image_random.cc)
# ---------------------------------------------------------------------------


class ImageNormalizeParam(Params):
    mean = param_field(tuple, default=(0.0,))
    std = param_field(tuple, default=(1.0,))


@register_op("_image_normalize", param_cls=ImageNormalizeParam,
             input_names=("data",))
def _image_normalize(params, data):
    """(data - mean) / std over the channel axis of CHW or NCHW."""
    shape = (1,) * (data.dim() - 3) + (-1, 1, 1)
    mean = torch.tensor(params.mean, dtype=data.dtype, device=data.device)
    std = torch.tensor(params.std, dtype=data.dtype, device=data.device)
    return (data - mean.reshape(shape)) / std.reshape(shape)


@register_op("_image_to_tensor", input_names=("data",))
def _image_to_tensor(params, data):
    """HWC [0, 255] -> CHW float32 [0, 1] (NHWC -> NCHW)."""
    out = data.to(torch.float32) / 255.0
    if data.dim() == 3:
        return out.permute(2, 0, 1)
    return out.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# ftml_update (optimizer_op.cc)
# ---------------------------------------------------------------------------


class FTMLParam(Params):
    lr = param_field(float, required=True)
    beta1 = param_field(float, default=0.6)
    beta2 = param_field(float, default=0.999)
    epsilon = param_field(float, default=1e-8)
    t = param_field(int, required=True)
    wd = param_field(float, default=0.0)
    rescale_grad = param_field(float, default=1.0)
    clip_grad = param_field(float, default=-1.0)


@register_op("ftml_update", param_cls=FTMLParam,
             input_names=("weight", "grad", "d", "v", "z"), num_outputs=4,
             output_names=("out", "d_out", "v_out", "z_out"))
def _ftml_update(params, weight, grad, d, v, z):
    """Follow The Moving Leader (Zheng & Kwok 2017)."""
    b1, b2, eps, t = params.beta1, params.beta2, params.epsilon, params.t
    g = grad * params.rescale_grad + params.wd * weight
    if params.clip_grad > 0:
        g = torch.clamp(g, -params.clip_grad, params.clip_grad)
    v_t = b2 * v + (1 - b2) * g * g
    d_t = (1 - b1 ** t) / params.lr * (torch.sqrt(v_t / (1 - b2 ** t)) + eps)
    z_t = b1 * z + (1 - b1) * g - (d_t - b1 * d) * weight
    return -z_t / d_t, d_t, v_t, z_t


# ---------------------------------------------------------------------------
# slice / scatter assignment (tensor/matrix_op.cc _slice_assign,
# indexing_op.cc _scatter_set_nd; _crop_assign is the legacy name)
# ---------------------------------------------------------------------------


class SliceAssignParam(Params):
    begin = param_field(tuple, required=True)
    end = param_field(tuple, required=True)
    step = param_field(tuple, default=())


def _assign(params, x, value):
    """``x`` with ``x[begin:end:step] = value``, out of place (a negative
    step too, through index lists)."""
    step = params.step or (None,) * len(params.begin)
    sl = [slice(b, e, s) for b, e, s in zip(params.begin, params.end, step)]
    out = x.clone()
    if all(s.step is None or s.step > 0 for s in sl):
        out[tuple(sl)] = value
        return out
    idx = [torch.tensor(range(n)[s], dtype=torch.int64, device=x.device)
           for s, n in zip(sl, x.shape)]
    grids = torch.meshgrid(*idx, indexing="ij")
    return out.index_put(grids, torch.as_tensor(value, dtype=x.dtype,
                                                device=x.device)
                         .expand(grids[0].shape + x.shape[len(sl):]))


@register_op("_slice_assign", input_names=("lhs", "rhs"),
             param_cls=SliceAssignParam, aliases=("_crop_assign",))
def _slice_assign(params, lhs, rhs):
    return _assign(params, lhs, rhs)


class SliceAssignScalarParam(SliceAssignParam):
    scalar = param_field(float, default=0.0)


@register_op("_slice_assign_scalar", input_names=("data",),
             param_cls=SliceAssignScalarParam,
             aliases=("_crop_assign_scalar",))
def _slice_assign_scalar(params, data):
    return _assign(params, data, torch.tensor(params.scalar,
                                              dtype=data.dtype,
                                              device=data.device))


class ScatterNDParam(Params):
    shape = param_field(tuple, required=True)


@register_op("_scatter_set_nd", input_names=("lhs", "rhs", "indices"),
             param_cls=ScatterNDParam)
def _scatter_set_nd(params, lhs, rhs, indices):
    """lhs with lhs[indices] = rhs, indices (M, K) (gather_nd's
    inverse)."""
    return lhs.index_put(tuple(indices.to(torch.int64)), rhs)


class ScatterScalarParam(Params):
    scalar = param_field(float, default=0.0)


@register_op("_scatter_plus_scalar", input_names=("data",),
             param_cls=ScatterScalarParam)
def _scatter_plus_scalar(params, data):
    """Values are dense: elementwise (keeping the nonzero structure is an
    rsp storage notion)."""
    return data + _scalar_like(data, params.scalar)


@register_op("_scatter_minus_scalar", input_names=("data",),
             param_cls=ScatterScalarParam)
def _scatter_minus_scalar(params, data):
    return data - _scalar_like(data, params.scalar)


@register_op("_scatter_elemwise_div", input_names=("lhs", "rhs"))
def _scatter_elemwise_div(params, lhs, rhs):
    return lhs / rhs


# ---------------------------------------------------------------------------
# bipartite matching (contrib/bounding_box.cc)
# ---------------------------------------------------------------------------


class BipartiteMatchingParam(Params):
    threshold = param_field(float, required=True)
    is_ascend = param_field(bool, default=False)
    topk = param_field(int, default=-1)


def bipartite_match(scores, n_iter, passes):
    """``n_iter`` greedy steps over a batch of score matrices (B, N, M):
    each step takes every matrix's first maximum, records the pair when
    it is finite and ``passes``, and retires its row and column."""
    B, N, M = scores.shape
    dev = scores.device
    rows = torch.full((B, N), -1.0, device=dev)
    cols = torch.full((B, M), -1.0, device=dev)
    r_at = torch.arange(N, device=dev)
    c_at = torch.arange(M, device=dev)
    gone = torch.full((), -float("inf"), dtype=scores.dtype, device=dev)
    for _ in range(n_iter):
        flat = scores.reshape(B, -1)
        best = torch.argmax(flat, dim=1)
        val = flat.gather(1, best[:, None])[:, 0]
        r, c = best // M, best % M
        do = (val > -float("inf")) & passes(val)
        at_r = do[:, None] & (r_at == r[:, None])
        at_c = do[:, None] & (c_at == c[:, None])
        rows = torch.where(at_r, c[:, None].to(rows.dtype), rows)
        cols = torch.where(at_c, r[:, None].to(cols.dtype), cols)
        scores = torch.where(at_r[:, :, None] | at_c[:, None, :], gone,
                             scores)
    return rows, cols


@register_op("_contrib_bipartite_matching", param_cls=BipartiteMatchingParam,
             input_names=("data",), num_outputs=2,
             output_names=("row_ids", "col_ids"))
def _bipartite_matching(params, data):
    """Greedy matching on scores (..., N, M): the best remaining pair
    first. Returns each row's column and each column's row, -1 for none
    (float32, as the reference)."""
    batch_shape = data.shape[:-2]
    N, M = data.shape[-2:]
    n_iter = min(N, M) if params.topk < 0 else min(params.topk, N, M)
    flat = data.reshape(-1, N, M).detach()
    if params.is_ascend:
        flat = -flat
    if data.device.type == "meta":
        rows = torch.empty((flat.shape[0], N), device="meta")
        cols = torch.empty((flat.shape[0], M), device="meta")
    else:
        rows, cols = bipartite_match(
            flat, n_iter, lambda v: (-v <= params.threshold)
            if params.is_ascend else (v >= params.threshold))
    return (rows.reshape(batch_shape + (N,)),
            cols.reshape(batch_shape + (M,)))


# ---------------------------------------------------------------------------
# generalized negative binomial with scalar parameters (sample_op.cc)
# ---------------------------------------------------------------------------


class GenNegBinParam(Params):
    mu = param_field(float, default=1.0)
    alpha = param_field(float, default=1.0)
    shape = param_field(tuple, default=())
    dtype = param_field(str, default="float32")
    ctx = param_field(str, default=None)


@register_op("_random_generalized_negative_binomial",
             aliases=("random_generalized_negative_binomial",),
             param_cls=GenNegBinParam, input_names=(), need_rng=True)
def _random_gen_neg_binomial(params, rng=None, device=None):
    # GNB(mu, alpha) = Poisson(Gamma(1 / alpha, mu * alpha))
    a = max(params.alpha, 1e-6)
    shape = torch.full(params.shape, 1.0 / a, device=device)
    lam = _gamma(shape, rng) * params.mu * a
    return _poisson(lam, rng).to(torch_dtype(params.dtype))


@register_op("_hypot_scalar", input_names=("data",),
             param_cls=ScatterScalarParam)
def _hypot_scalar(params, data):
    return torch.hypot(data, _scalar_like(data, params.scalar))


class BroadcastAxisParam(Params):
    axis = param_field(tuple, default=())
    size = param_field(tuple, default=())


@register_op("broadcast_axis", param_cls=BroadcastAxisParam,
             input_names=("data",))
def _broadcast_axis(params, data):
    """Size-1 axes broadcast to the given sizes."""
    axes = params.axis if isinstance(params.axis, tuple) else (params.axis,)
    sizes = params.size if isinstance(params.size, tuple) else (params.size,)
    tgt = list(data.shape)
    for ax, sz in zip(axes, sizes):
        tgt[int(ax)] = int(sz)
    return data.expand(tuple(tgt))


# ---------------------------------------------------------------------------
# the legacy alias surface (the reference keeps these for old graphs)
# ---------------------------------------------------------------------------

_COMPAT_ALIASES = {
    # capitalised scalar and comparison names
    "_PlusScalar": "_plus_scalar", "_MinusScalar": "_minus_scalar",
    "_RMinusScalar": "_rminus_scalar", "_MulScalar": "_mul_scalar",
    "_DivScalar": "_div_scalar", "_RDivScalar": "_rdiv_scalar",
    "_PowerScalar": "_power_scalar", "_RPowerScalar": "_rpower_scalar",
    "_ModScalar": "_mod_scalar", "_RModScalar": "_rmod_scalar",
    "_MaximumScalar": "_maximum_scalar", "_MinimumScalar": "_minimum_scalar",
    "_EqualScalar": "_equal_scalar", "_GreaterScalar": "_greater_scalar",
    "_GreaterEqualScalar": "_greater_equal_scalar",
    "_LesserScalar": "_lesser_scalar",
    "_LesserEqualScalar": "_lesser_equal_scalar",
    "_NotEqualScalar": "_not_equal_scalar",
    "_Equal": "_equal", "_Not_Equal": "_not_equal", "_Greater": "_greater",
    "_Greater_Equal": "_greater_equal", "_Lesser": "_lesser",
    "_Lesser_Equal": "_lesser_equal", "_Mod": "_mod",
    "_Hypot": "_hypot", "_HypotScalar": "_hypot_scalar",
    # v1 names resolve to the current ops
    "BatchNorm_v1": "BatchNorm", "Convolution_v1": "Convolution",
    "Pooling_v1": "Pooling", "ROIPooling_v1": "ROIPooling",
    # the underscore linalg names
    "_linalg_gemm": "linalg_gemm", "_linalg_gemm2": "linalg_gemm2",
    "_linalg_potrf": "linalg_potrf", "_linalg_potri": "linalg_potri",
    "_linalg_trmm": "linalg_trmm", "_linalg_trsm": "linalg_trsm",
    "_linalg_sumlogdiag": "linalg_sumlogdiag",
    "_linalg_syrk": "linalg_syrk", "_linalg_syevd": "linalg_syevd",
    "_linalg_gelqf": "linalg_gelqf",
    # contrib alternates
    "_contrib_ROIAlign_v2": "_contrib_ROIAlign",
    "_contrib_box_non_maximum_suppression": "_contrib_box_nms",
    "_contrib_SparseEmbedding": "Embedding",
    # sparse-storage dispatch names (values are dense)
    "_sparse_retain": "sparse_retain",
    "_sparse_cast_storage": "cast_storage",
    "_sparse_dot": "dot",
    "_sparse_zeros_like": "zeros_like",
    "broadcast_axes": "broadcast_axis",
}


def _register_compat_aliases():
    missing = []
    for alias, target in _COMPAT_ALIASES.items():
        if find_op(target) is None:
            missing.append((alias, target))
            continue
        if alias not in OPS and alias not in _ALIASES:
            _ALIASES[alias] = target if target in OPS else _ALIASES[target]
    if missing:
        raise MXNetError("compat aliases with no target: %r" % missing)


_register_compat_aliases()
