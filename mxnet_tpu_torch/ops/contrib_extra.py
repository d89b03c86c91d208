"""Contrib detection and math ops of the port: ``DeformableConvolution``,
``ROIAlign``, ``DeformablePSROIPooling``, ``Proposal``,
``MultiProposal``, ``count_sketch`` and ``khatri_rao``
(``mxnet_tpu/ops/contrib_extra.py``; reference src/operator/contrib/
{deformable_convolution,deformable_psroi_pooling,proposal,
multi_proposal,roi_align,count_sketch,krprod}.cc).

- Deformable convolution samples every kernel tap bilinearly at its
  offset-shifted position (four gathers a tap, zero outside the image)
  and contracts the samples with the weight in one einsum; the gradient
  into the offsets is autograd's through the bilinear weights, as the
  reference's is jax's.
- The proposals' NMS takes the top ``rpn_pre_nms_top_n`` by a stable
  sort (equal scores in index order, as ``lax.top_k``), then
  ``multibox.greedy_keep`` over every image at once, and keeps the first
  ``rpn_post_nms_top_n`` survivors, padding with the best box.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError, Params, param_field
from .elemwise import round_half_away
from .multibox import greedy_keep, stable_order
from .registry import register_op
from .vision import ps_select


def bilinear_gather(img, ys, xs):
    """img (B, C, H, W); ys / xs (B, *S) sample coordinates -> (B, C,
    *S). Taps outside [0, H-1] x [0, W-1] read 0, and a sample outside
    (-1, H) x (-1, W) is 0 (the reference's im2col_bilinear and ROIAlign
    interpolation)."""
    B, C, H, W = img.shape
    S = ys.shape[1:]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1 = ys - y0
    wx1 = xs - x0
    wy0 = 1.0 - wy1
    wx0 = 1.0 - wx1
    valid = (ys > -1.0) & (ys < H) & (xs > -1.0) & (xs < W)
    flat = img.reshape(B, C, H * W)

    def tap(yc, xc, w):
        inb = (yc >= 0) & (yc < H) & (xc >= 0) & (xc < W)
        idx = (torch.clamp(yc, 0, H - 1).to(torch.int64) * W
               + torch.clamp(xc, 0, W - 1).to(torch.int64))
        v = flat.gather(2, idx.reshape(B, 1, -1).expand(B, C, -1))
        return v.reshape((B, C) + S) * (w * inb).to(img.dtype)[:, None]

    out = (tap(y0, x0, wy0 * wx0) + tap(y0, x0 + 1, wy0 * wx1)
           + tap(y0 + 1, x0, wy1 * wx0) + tap(y0 + 1, x0 + 1, wy1 * wx1))
    return out * valid.to(img.dtype)[:, None]


# ---------------------------------------------------------------------------
# DeformableConvolution (contrib/deformable_convolution.cc)
# ---------------------------------------------------------------------------


class DeformableConvParam(Params):
    kernel = param_field(tuple, required=True)
    stride = param_field(tuple, default=())
    dilate = param_field(tuple, default=())
    pad = param_field(tuple, default=())
    num_filter = param_field(int, required=True)
    num_group = param_field(int, default=1)
    num_deformable_group = param_field(int, default=1)
    no_bias = param_field(bool, default=False)
    workspace = param_field(int, default=1024)
    layout = param_field(str, default=None)


def _defconv_inputs(p):
    if p is not None and p.no_bias:
        return ("data", "offset", "weight")
    return ("data", "offset", "weight", "bias")


@register_op("_contrib_DeformableConvolution", param_cls=DeformableConvParam,
             input_names=_defconv_inputs,
             aliases=("_contrib_deformable_convolution",))
def _deformable_convolution(params, data, offset, weight, bias=None):
    """data (N, C, H, W); offset (N, 2 * ndg * kh * kw, Ho, Wo), per
    deformable group and tap (dy, dx); weight (F, C / num_group, kh,
    kw)."""
    kh, kw = params.kernel
    sh, sw = params.stride or (1, 1)
    dh, dw = params.dilate or (1, 1)
    ph, pw = params.pad or (0, 0)
    ndg = params.num_deformable_group
    N, C, H, W = data.shape
    F = params.num_filter
    Ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    K = kh * kw
    dev = data.device
    oy = torch.arange(Ho, device=dev) * sh - ph
    ox = torch.arange(Wo, device=dev) * sw - pw
    ky, kx = torch.meshgrid(torch.arange(kh, device=dev) * dh,
                            torch.arange(kw, device=dev) * dw, indexing="ij")
    base_y = (ky.reshape(K, 1, 1) + oy[None, :, None]).to(data.dtype)
    base_x = (kx.reshape(K, 1, 1) + ox[None, None, :]).to(data.dtype)
    off = offset.reshape(N * ndg, K, 2, Ho, Wo)
    ys = base_y + off[:, :, 0]
    xs = base_x + off[:, :, 1]
    cols = bilinear_gather(data.reshape(N * ndg, C // ndg, H, W), ys, xs)
    g = params.num_group
    cols = cols.reshape(N, g, C // g, K, Ho, Wo)
    wg = weight.reshape(g, F // g, C // g, K)
    out = torch.einsum("ngckhw,gfck->ngfhw", cols, wg).reshape(N, F, Ho, Wo)
    if bias is not None:
        out = out + bias.reshape(1, F, 1, 1)
    return out.to(data.dtype)


# ---------------------------------------------------------------------------
# ROIAlign (roi_align_v2's semantics: no rounding, averaged bilinear
# samples)
# ---------------------------------------------------------------------------


class ROIAlignParam(Params):
    pooled_size = param_field(tuple, required=True)
    spatial_scale = param_field(float, required=True)
    sample_ratio = param_field(int, default=-1)


@register_op("_contrib_ROIAlign", param_cls=ROIAlignParam,
             input_names=("data", "rois"), aliases=("_contrib_roi_align",))
def _roi_align(params, data, rois):
    """data (N, C, H, W); rois (R, 5) = (batch index, x1, y1, x2, y2)."""
    ph, pw = params.pooled_size
    scale = params.spatial_scale
    sr = params.sample_ratio if params.sample_ratio > 0 else 2
    R = rois.shape[0]
    dev = data.device
    x1, y1, x2, y2 = (rois[:, i] * scale for i in (1, 2, 3, 4))
    bin_h = (torch.clamp_min(y2 - y1, 1.0) / ph)[:, None, None]
    bin_w = (torch.clamp_min(x2 - x1, 1.0) / pw)[:, None, None]
    iy = torch.arange(ph, dtype=torch.float32, device=dev)
    ix = torch.arange(pw, dtype=torch.float32, device=dev)
    s = torch.arange(sr, dtype=torch.float32, device=dev)
    ys = y1[:, None, None] + bin_h * (iy[:, None] + (s[None, :] + 0.5) / sr)
    xs = x1[:, None, None] + bin_w * (ix[:, None] + (s[None, :] + 0.5) / sr)
    shape = (R, ph, sr, pw, sr)
    vals = bilinear_gather(data[rois[:, 0].to(torch.int64)],
                           ys.reshape(R, ph, sr, 1, 1).expand(shape),
                           xs.reshape(R, 1, 1, pw, sr).expand(shape))
    return vals.mean(dim=(3, 5)).to(data.dtype)


# ---------------------------------------------------------------------------
# DeformablePSROIPooling (contrib/deformable_psroi_pooling.cc)
# ---------------------------------------------------------------------------


class DeformablePSROIParam(Params):
    spatial_scale = param_field(float, required=True)
    output_dim = param_field(int, required=True)
    group_size = param_field(int, required=True)
    pooled_size = param_field(int, required=True)
    part_size = param_field(int, default=0)
    sample_per_part = param_field(int, default=1)
    trans_std = param_field(float, default=0.0)
    no_trans = param_field(bool, default=False)


def _defpsroi_inputs(p):
    if p is not None and p.no_trans:
        return ("data", "rois")
    return ("data", "rois", "trans")


@register_op("_contrib_DeformablePSROIPooling", param_cls=DeformablePSROIParam,
             input_names=_defpsroi_inputs,
             aliases=("_contrib_deformable_psroi_pooling",))
def _deformable_psroi_pooling(params, data, rois, trans=None):
    """Position-sensitive ROI pooling with per-part learned offsets: data
    (N, output_dim * group_size^2, H, W), rois (R, 5), trans (R, 2,
    part, part)."""
    k = params.pooled_size
    gs = params.group_size
    spp = params.sample_per_part
    part = params.part_size or k
    scale = params.spatial_scale
    R = rois.shape[0]
    dev = data.device
    # the ROI snapped to a 0.5-aligned grid
    x1 = round_half_away(rois[:, 1]) * scale - 0.5
    y1 = round_half_away(rois[:, 2]) * scale - 0.5
    x2 = (round_half_away(rois[:, 3]) + 1.0) * scale - 0.5
    y2 = (round_half_away(rois[:, 4]) + 1.0) * scale - 0.5
    rw = torch.clamp_min(x2 - x1, 0.1)
    rh = torch.clamp_min(y2 - y1, 0.1)
    bin_h, bin_w = rh / k, rw / k
    sub_h, sub_w = bin_h / spp, bin_w / spp
    i = torch.arange(k, device=dev)
    pi = torch.clamp((i * part) // k, 0, part - 1)
    if trans is None:
        dy = torch.zeros((R, k, k), device=dev)
        dx = torch.zeros((R, k, k), device=dev)
    else:
        tr = trans.reshape(R, 2, part, part)[:, :, pi[:, None], pi[None, :]]
        dy = tr[:, 0] * params.trans_std * rh[:, None, None]
        dx = tr[:, 1] * params.trans_std * rw[:, None, None]
    s = torch.arange(spp, dtype=torch.float32, device=dev)

    def r4(v):
        return v.reshape(R, 1, 1, 1, 1)

    ys = (r4(y1) + i.reshape(1, k, 1, 1, 1) * r4(bin_h) + dy[..., None, None]
          + (s.reshape(1, 1, 1, spp, 1) + 0.5) * r4(sub_h))
    xs = (r4(x1) + i.reshape(1, 1, k, 1, 1) * r4(bin_w) + dx[..., None, None]
          + (s.reshape(1, 1, 1, 1, spp) + 0.5) * r4(sub_w))
    shape = (R, k, k, spp, spp)
    vals = bilinear_gather(data[rois[:, 0].to(torch.int64)],
                           ys.expand(shape), xs.expand(shape))
    vals = vals.mean(dim=(-1, -2))
    return ps_select(vals, params.output_dim, gs, k).to(data.dtype)


# ---------------------------------------------------------------------------
# Proposal / MultiProposal (contrib/proposal.cc, multi_proposal.cc)
# ---------------------------------------------------------------------------


class ProposalParam(Params):
    rpn_pre_nms_top_n = param_field(int, default=6000)
    rpn_post_nms_top_n = param_field(int, default=300)
    threshold = param_field(float, default=0.7)
    rpn_min_size = param_field(int, default=16)
    scales = param_field(tuple, default=(4.0, 8.0, 16.0, 32.0))
    ratios = param_field(tuple, default=(0.5, 1.0, 2.0))
    feature_stride = param_field(int, default=16)
    output_score = param_field(bool, default=False)
    iou_loss = param_field(bool, default=False)
    workspace = param_field(int, default=256)


def generate_anchors(scales, ratios, stride):
    """The reference's anchor enumeration (proposal.cc GenerateAnchors):
    base box [0, 0, stride - 1, stride - 1], ratios then scales."""
    base = _np.array([0, 0, stride - 1, stride - 1], dtype=_np.float32)
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    cx = base[0] + 0.5 * (w - 1)
    cy = base[1] + 0.5 * (h - 1)
    anchors = []
    for r in ratios:
        ws = round(_np.sqrt(w * h / r))
        hs = round(ws * r)
        for s in scales:
            wss, hss = ws * s, hs * s
            anchors.append([cx - 0.5 * (wss - 1), cy - 0.5 * (hss - 1),
                            cx + 0.5 * (wss - 1), cy + 0.5 * (hss - 1)])
    return _np.array(anchors, dtype=_np.float32)


def _bbox_transform(anchors, deltas, iou_loss):
    """Regression deltas applied to anchors (proposal.cc
    BBoxTransformInv); (..., 4) -> (..., 4)."""
    w = anchors[..., 2] - anchors[..., 0] + 1.0
    h = anchors[..., 3] - anchors[..., 1] + 1.0
    cx = anchors[..., 0] + 0.5 * (w - 1.0)
    cy = anchors[..., 1] + 0.5 * (h - 1.0)
    if iou_loss:
        return anchors + deltas
    pcx = deltas[..., 0] * w + cx
    pcy = deltas[..., 1] * h + cy
    pw = torch.exp(deltas[..., 2]) * w
    ph = torch.exp(deltas[..., 3]) * h
    return torch.stack([pcx - 0.5 * (pw - 1.0), pcy - 0.5 * (ph - 1.0),
                        pcx + 0.5 * (pw - 1.0), pcy + 0.5 * (ph - 1.0)],
                       dim=-1)


def nms_fixed(boxes, scores, thresh, pre_n, post_n):
    """Greedy IoU NMS of a batch over each image's top ``pre_n`` boxes:
    boxes (B, M, 4), scores (B, M) -> (B, post_n, 4), (B, post_n), the
    survivors in score order, padded with the best box."""
    B = boxes.shape[0]
    n = min(pre_n, scores.shape[1])
    order = stable_order(scores)[:, :n]
    sc = scores.gather(1, order)
    bx = boxes.gather(1, order[..., None].expand(B, n, 4))
    x1, y1, x2, y2 = bx.unbind(-1)
    areas = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    iw = torch.clamp_min(torch.minimum(x2[:, :, None], x2[:, None, :])
                         - torch.maximum(x1[:, :, None], x1[:, None, :])
                         + 1.0, 0.0)
    ih = torch.clamp_min(torch.minimum(y2[:, :, None], y2[:, None, :])
                         - torch.maximum(y1[:, :, None], y1[:, None, :])
                         + 1.0, 0.0)
    inter = iw * ih
    iou = inter / (areas[:, :, None] + areas[:, None, :] - inter)
    keep = greedy_keep(iou > thresh, torch.ones_like(sc, dtype=torch.bool))
    # the kept indices first, in score order
    kept = stable_order(keep.to(torch.int8))
    if post_n > n:
        kept = torch.cat([kept, kept[:, :1].expand(B, post_n - n)], dim=1)
    slot = torch.arange(post_n, device=boxes.device)
    out_idx = torch.where(slot < keep.sum(dim=1, keepdim=True),
                          kept[:, :post_n], kept[:, :1])
    return (bx.gather(1, out_idx[..., None].expand(B, post_n, 4)),
            sc.gather(1, out_idx))


def _proposals(params, cls_prob, bbox_pred, im_info):
    """Every image's proposals: cls_prob (N, 2A, H, W), bbox_pred (N, 4A,
    H, W), im_info (N, 3) -> boxes (N, post_n, 4), scores (N, post_n)."""
    anchors = torch.from_numpy(generate_anchors(
        params.scales, params.ratios, params.feature_stride)).to(
        cls_prob.device)
    A = anchors.shape[0]
    N, _, H, W = cls_prob.shape
    dev = cls_prob.device
    stride = params.feature_stride
    sx = (torch.arange(W, device=dev) * stride).to(torch.float32)
    sy = (torch.arange(H, device=dev) * stride).to(torch.float32)
    shifts = torch.stack([sx[None, :].expand(H, W), sy[:, None].expand(H, W),
                          sx[None, :].expand(H, W), sy[:, None].expand(H, W)],
                         dim=-1)
    all_anchors = (anchors[None, None] + shifts[:, :, None]).reshape(-1, 4)
    scores = cls_prob[:, A:].permute(0, 2, 3, 1).reshape(N, -1)
    deltas = bbox_pred.reshape(N, A, 4, H, W).permute(0, 3, 4, 1, 2) \
        .reshape(N, -1, 4)
    props = _bbox_transform(all_anchors, deltas, params.iou_loss)
    im_h = im_info[:, 0:1] - 1.0
    im_w = im_info[:, 1:2] - 1.0
    zero = torch.zeros((), device=dev)
    props = torch.stack([
        torch.minimum(torch.maximum(props[..., 0], zero), im_w),
        torch.minimum(torch.maximum(props[..., 1], zero), im_h),
        torch.minimum(torch.maximum(props[..., 2], zero), im_w),
        torch.minimum(torch.maximum(props[..., 3], zero), im_h)], dim=-1)
    min_size = params.rpn_min_size * im_info[:, 2:3]
    ws = props[..., 2] - props[..., 0] + 1.0
    hs = props[..., 3] - props[..., 1] + 1.0
    valid = (ws >= min_size) & (hs >= min_size)
    scores = torch.where(valid, scores, torch.full_like(scores, -1.0))
    return nms_fixed(props, scores, params.threshold,
                     params.rpn_pre_nms_top_n, params.rpn_post_nms_top_n)


def _proposal_outputs(p):
    return 2 if (p is not None and p.output_score) else 1


@register_op("_contrib_Proposal", param_cls=ProposalParam,
             input_names=("cls_prob", "bbox_pred", "im_info"),
             num_outputs=_proposal_outputs, aliases=("_contrib_proposal",))
def _proposal(params, cls_prob, bbox_pred, im_info):
    """The first image's RPN proposals: (post_n, 5) = (0, x1, y1, x2,
    y2)."""
    boxes, scores = _proposals(params, cls_prob[:1], bbox_pred[:1],
                               im_info[:1])
    boxes, scores = boxes[0], scores[0]
    out = torch.cat([torch.zeros((boxes.shape[0], 1), dtype=boxes.dtype,
                                 device=boxes.device), boxes], dim=1)
    if params.output_score:
        return out, scores[:, None]
    return out


@register_op("_contrib_MultiProposal", param_cls=ProposalParam,
             input_names=("cls_prob", "bbox_pred", "im_info"),
             num_outputs=_proposal_outputs,
             aliases=("_contrib_multi_proposal",))
def _multi_proposal(params, cls_prob, bbox_pred, im_info):
    """Every image's proposals: (N * post_n, 5), the batch index in
    column 0."""
    boxes, scores = _proposals(params, cls_prob, bbox_pred, im_info)
    N, P = boxes.shape[:2]
    bidx = torch.arange(N, dtype=boxes.dtype,
                        device=boxes.device).repeat_interleave(P)[:, None]
    out = torch.cat([bidx, boxes.reshape(N * P, 4)], dim=1)
    if params.output_score:
        return out, scores.reshape(N * P, 1)
    return out


# ---------------------------------------------------------------------------
# count_sketch (contrib/count_sketch.cc)
# ---------------------------------------------------------------------------


class CountSketchParam(Params):
    out_dim = param_field(int, required=True)
    processing_batch_size = param_field(int, default=32)


@register_op("_contrib_count_sketch", param_cls=CountSketchParam,
             input_names=("data", "h", "s"))
def _count_sketch(params, data, h, s):
    """data (N, d); h (1, d) buckets in [0, out_dim); s (1, d) signs:
    out[n, h[i]] += s[i] * data[n, i]; a bucket out of range is
    dropped."""
    idx = h.reshape(-1).to(torch.int64)
    contrib = data * s.reshape(-1).to(data.dtype)[None, :]
    inside = (idx >= 0) & (idx < params.out_dim)
    out = torch.zeros((data.shape[0], params.out_dim), dtype=data.dtype,
                      device=data.device)
    return out.index_add(1, idx[inside], contrib[:, inside])


# ---------------------------------------------------------------------------
# khatri_rao (contrib/krprod.cc)
# ---------------------------------------------------------------------------


class KhatriRaoParam(Params):
    num_args = param_field(int, default=1)


@register_op("khatri_rao", param_cls=KhatriRaoParam,
             key_var_num_args="num_args",
             input_names=lambda p: tuple(
                 "arg%d" % i for i in range(p.num_args if p else 1)))
def _khatri_rao(params, *mats):
    """The column-wise Kronecker product: (r_i, k) inputs -> (prod r_i,
    k)."""
    if not mats:
        raise MXNetError("khatri_rao needs at least one input")
    out = mats[0]
    for m in mats[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(
            out.shape[0] * m.shape[0], out.shape[1])
    return out
