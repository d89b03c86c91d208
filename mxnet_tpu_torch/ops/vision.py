"""Vision ops of the port: ``ROIPooling``, ``Crop``, ``GridGenerator``,
``BilinearSampler``, ``SpatialTransformer``, ``Correlation`` and the
contrib ``BilinearResize2D``, ``AdaptiveAvgPooling2D``, ``box_iou`` and
``box_nms`` (``mxnet_tpu/ops/vision.py``; reference src/operator/
{roi_pooling,crop,spatial_transformer,bilinear_sampler,grid_generator,
correlation}.cc and contrib/{bilinear_resize,adaptive_avg_pooling,
bounding_box}.cc).

The reference's formulations, batched: ROI pooling is a masked max over
every ROI at once (no data-dependent slices), bilinear sampling is four
gathers and a lerp, correlation a loop over the static displacement
grid, adaptive pooling an integral image with static bin edges, and
``box_nms`` the greedy recursion of ``multibox.greedy_keep`` over every
batch row. Gradients are autograd's through these, as the reference's
are jax's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError, Params, param_field
from .elemwise import round_half_away
from .multibox import greedy_keep, stable_order
from .registry import register_op


# ---------------------------------------------------------------------------
# ROIPooling (roi_pooling.cc)
# ---------------------------------------------------------------------------


class ROIPoolParam(Params):
    pooled_size = param_field(tuple, required=True)
    spatial_scale = param_field(float, required=True)


def divide(x, n):
    """``x / n`` for a Python number ``n``, rounded as a division on every
    device: CUDA divides by a host scalar as a product with its
    reciprocal, which moves a pooling bin's edge that falls on an
    integer."""
    return x / torch.full((), n, dtype=x.dtype, device=x.device)


def bin_masks(start, end, size):
    """(R, bins, size) masks of the pixels ``start <= p < end``."""
    pos = torch.arange(size, dtype=torch.float32, device=start.device)
    return (pos >= start[..., None]) & (pos < end[..., None])


def ps_select(vals, od, gs, k):
    """Position-sensitive channel selection: (R, C, k, k) -> (R, od, k,
    k), bin (i, j) reading channel block gy * gs + gx."""
    dev = vals.device
    g = torch.clamp((torch.arange(k, device=dev) * gs) // k, 0, gs - 1)
    sel = g[:, None] * gs + g[None, :]
    R = vals.shape[0]
    vals = vals.reshape(R, od, gs * gs, k, k)
    return vals.gather(2, sel.expand(R, od, 1, k, k))[:, :, 0]


@register_op("ROIPooling", param_cls=ROIPoolParam,
             input_names=("data", "rois"))
def _roi_pooling(params, data, rois):
    """data (N, C, H, W); rois (R, 5) = (batch index, x1, y1, x2, y2) in
    image coordinates -> (R, C, ph, pw)."""
    ph, pw = params.pooled_size
    _, _, H, W = data.shape
    scale = params.spatial_scale
    # C round(): ties away from zero
    x1, y1, x2, y2 = (round_half_away(rois[:, i] * scale) for i in (1, 2,
                                                                    3, 4))
    bin_h = divide(torch.clamp_min(y2 - y1 + 1.0, 1.0), ph)
    bin_w = divide(torch.clamp_min(x2 - x1 + 1.0, 1.0), pw)
    iy = torch.arange(ph, dtype=torch.float32, device=data.device)
    ix = torch.arange(pw, dtype=torch.float32, device=data.device)
    ymask = bin_masks(torch.floor(y1[:, None] + iy * bin_h[:, None]),
                      torch.ceil(y1[:, None] + (iy + 1) * bin_h[:, None]), H)
    xmask = bin_masks(torch.floor(x1[:, None] + ix * bin_w[:, None]),
                      torch.ceil(x1[:, None] + (ix + 1) * bin_w[:, None]), W)
    mask = ymask[:, :, None, :, None] & xmask[:, None, :, None, :]
    img = data[rois[:, 0].to(torch.int64)]                 # (R, C, H, W)
    neg = torch.finfo(data.dtype).min
    vals = torch.where(mask[:, None], img[:, :, None, None],
                       torch.full((), neg, dtype=data.dtype,
                                  device=data.device))
    pooled = torch.amax(vals, dim=(-1, -2))
    empty = ~mask.any(dim=-1).any(dim=-1)
    return torch.where(empty[:, None], torch.zeros_like(pooled), pooled)


# ---------------------------------------------------------------------------
# Crop (crop.cc)
# ---------------------------------------------------------------------------


class CropParam(Params):
    num_args = param_field(int, default=1)
    offset = param_field(tuple, default=(0, 0))
    h_w = param_field(tuple, default=(0, 0))
    center_crop = param_field(bool, default=False)


def _crop_inputs(p):
    if p is not None and p.num_args == 2:
        return ("data", "crop_like")
    return ("data",)


@register_op("Crop", param_cls=CropParam, input_names=_crop_inputs)
def _crop(params, data, crop_like=None):
    H, W = data.shape[2], data.shape[3]
    if crop_like is not None:
        th, tw = crop_like.shape[2], crop_like.shape[3]
    else:
        th, tw = params.h_w
        if th == 0:
            raise MXNetError("Crop needs h_w or a second input")
    if params.center_crop:
        y0, x0 = (H - th) // 2, (W - tw) // 2
    else:
        y0, x0 = params.offset
    return data[:, :, y0:y0 + th, x0:x0 + tw]


# ---------------------------------------------------------------------------
# GridGenerator / BilinearSampler / SpatialTransformer
# ---------------------------------------------------------------------------


class GridGenParam(Params):
    transform_type = param_field(str, required=True)
    target_shape = param_field(tuple, default=(0, 0))


def _affine_grid(theta6, h, w):
    """(N, 6) affine parameters -> (N, 2, h, w) sampling grid in [-1, 1]."""
    dev = theta6.device
    theta = theta6.reshape(-1, 2, 3)
    ys = torch.linspace(-1.0, 1.0, h, device=dev)
    xs = torch.linspace(-1.0, 1.0, w, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx.reshape(-1), gy.reshape(-1),
                        torch.ones(h * w, device=dev)])
    return torch.matmul(theta.to(torch.float32), base).reshape(-1, 2, h, w)


@register_op("GridGenerator", param_cls=GridGenParam)
def _grid_generator(params, data):
    if params.transform_type == "affine":
        h, w = params.target_shape
        return _affine_grid(data, h, w).to(data.dtype)
    if params.transform_type == "warp":
        # data (N, 2, H, W) flow; grid = identity + flow, normalised
        _, _, h, w = data.shape
        ys = torch.arange(h, dtype=torch.float32, device=data.device)
        xs = torch.arange(w, dtype=torch.float32, device=data.device)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        nx = (data[:, 0] + gx) * 2.0 / max(w - 1, 1) - 1.0
        ny = (data[:, 1] + gy) * 2.0 / max(h - 1, 1) - 1.0
        return torch.stack([nx, ny], dim=1).to(data.dtype)
    raise MXNetError("unknown transform_type %r" % params.transform_type)


def bilinear_sample(img, grid):
    """img (N, C, H, W), grid (N, 2, Ho, Wo) of (x, y) in [-1, 1] ->
    (N, C, Ho, Wo); taps outside the image read 0."""
    N, C, H, W = img.shape
    gx = (grid[:, 0] + 1.0) * (W - 1) / 2.0
    gy = (grid[:, 1] + 1.0) * (H - 1) / 2.0
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = (gx - x0)[:, None]
    wy = (gy - y0)[:, None]
    flat = img.reshape(N, C, H * W)

    def at(yi, xi):
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = (torch.clamp(yi, 0, H - 1).to(torch.int64) * W
               + torch.clamp(xi, 0, W - 1).to(torch.int64))
        v = flat.gather(2, idx.reshape(N, 1, -1).expand(N, C, -1))
        v = v.reshape((N, C) + yi.shape[1:])
        return torch.where(valid[:, None], v, torch.zeros_like(v))

    top = at(y0, x0) * (1 - wx) + at(y0, x0 + 1) * wx
    bot = at(y0 + 1, x0) * (1 - wx) + at(y0 + 1, x0 + 1) * wx
    return (top * (1 - wy) + bot * wy).to(img.dtype)


@register_op("BilinearSampler", input_names=("data", "grid"))
def _bilinear_sampler(params, data, grid):
    return bilinear_sample(data, grid.to(torch.float32))


class STParam(Params):
    transform_type = param_field(str, required=True)
    sampler_type = param_field(str, required=True)
    target_shape = param_field(tuple, default=(0, 0))


@register_op("SpatialTransformer", param_cls=STParam,
             input_names=("data", "loc"))
def _spatial_transformer(params, data, loc):
    if params.transform_type != "affine" or params.sampler_type != "bilinear":
        raise MXNetError("SpatialTransformer supports affine/bilinear")
    h, w = params.target_shape
    if h == 0:
        h, w = data.shape[2], data.shape[3]
    return bilinear_sample(data, _affine_grid(loc, h, w))


# ---------------------------------------------------------------------------
# Correlation (correlation.cc)
# ---------------------------------------------------------------------------


class CorrelationParam(Params):
    kernel_size = param_field(int, default=1)
    max_displacement = param_field(int, default=1)
    stride1 = param_field(int, default=1)
    stride2 = param_field(int, default=1)
    pad_size = param_field(int, default=0)
    is_multiply = param_field(bool, default=True)


def window_sum_same(m, k):
    """The k x k window sum of (N, 1, H, W) at stride 1 with "SAME"
    zero padding (the extra row and column after, as XLA pads)."""
    lo = (k - 1) // 2
    m = F.pad(m, (lo, k - 1 - lo, lo, k - 1 - lo))
    return F.avg_pool2d(m, k, stride=1, divisor_override=1)


@register_op("Correlation", param_cls=CorrelationParam,
             input_names=("data1", "data2"))
def _correlation(params, data1, data2):
    k = params.kernel_size
    s2 = params.stride2
    ngr = params.max_displacement // s2
    pad = params.pad_size
    _, _, h, w = data1.shape
    p1 = F.pad(data1, (pad, pad, pad, pad))
    p2 = F.pad(data2, (pad, pad, pad, pad))
    ph, pw = p1.shape[2], p1.shape[3]
    dmax = ngr * s2
    # a zero halo, so a shift never wraps
    p2z = F.pad(p2, (dmax, dmax, dmax, dmax))
    disps = [i * s2 for i in range(-ngr, ngr + 1)]
    maps = []
    for dy in disps:
        for dx in disps:
            shifted = p2z[:, :, dmax + dy:dmax + dy + ph,
                          dmax + dx:dmax + dx + pw]
            prod = p1 * shifted if params.is_multiply else \
                (p1 - shifted).abs()
            m = prod.mean(dim=1, keepdim=True)
            if k > 1:
                m = window_sum_same(m, k) / (k * k)
            maps.append(m)
    out = torch.cat(maps, dim=1)
    if pad:
        out = out[:, :, pad:pad + h, pad:pad + w]
    if params.stride1 > 1:
        out = out[:, :, ::params.stride1, ::params.stride1]
    return out.to(data1.dtype)


# ---------------------------------------------------------------------------
# contrib: BilinearResize2D, AdaptiveAvgPooling2D
# ---------------------------------------------------------------------------


class ResizeParam(Params):
    height = param_field(int, required=True)
    width = param_field(int, required=True)


def _interp_axis(x, out_size, axis):
    """align_corners linear interpolation along one axis (the reference's
    bilinear_resize-inl.h convention)."""
    in_size = x.shape[axis]
    if out_size == in_size:
        return x
    dev = x.device
    if in_size == 1 or out_size == 1:
        return x.index_select(axis, torch.zeros(out_size, dtype=torch.int64,
                                                device=dev))
    pos = torch.arange(out_size, device=dev) * ((in_size - 1.0)
                                                / (out_size - 1.0))
    lo = torch.clamp_max(torch.floor(pos).to(torch.int64), in_size - 2)
    shape = [1] * x.dim()
    shape[axis] = out_size
    frac = (pos - lo).to(x.dtype).reshape(shape)
    a = x.index_select(axis, lo)
    b = x.index_select(axis, lo + 1)
    return a * (1 - frac) + b * frac


@register_op("_contrib_BilinearResize2D", param_cls=ResizeParam)
def _bilinear_resize(params, data):
    out = _interp_axis(data, params.height, 2)
    return _interp_axis(out, params.width, 3).to(data.dtype)


class AdaptivePoolParam(Params):
    output_size = param_field(tuple, default=(1, 1))


@register_op("_contrib_AdaptiveAvgPooling2D", param_cls=AdaptivePoolParam)
def _adaptive_avg_pool(params, data):
    oh, ow = (params.output_size if len(params.output_size) == 2
              else (params.output_size[0],) * 2)
    _, _, h, w = data.shape
    # an integral image with static, overlapping bin edges: start =
    # floor(i * h / oh), end = ceil((i + 1) * h / oh)
    integ = F.pad(torch.cumsum(torch.cumsum(data, dim=2), dim=3),
                  (1, 0, 1, 0))

    def edges(size, bins):
        return [((i * size) // bins, -((-(i + 1) * size) // bins))
                for i in range(bins)]

    rows = []
    for y0, y1 in edges(h, oh):
        cols = []
        for x0, x1 in edges(w, ow):
            s = (integ[:, :, y1, x1] - integ[:, :, y0, x1]
                 - integ[:, :, y1, x0] + integ[:, :, y0, x0])
            cols.append(s / ((y1 - y0) * (x1 - x0)))
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2).to(data.dtype)


# ---------------------------------------------------------------------------
# contrib: box_iou, box_nms (bounding_box.cc)
# ---------------------------------------------------------------------------


class BoxIouParam(Params):
    format = param_field(str, default="corner")


def to_corner(boxes, fmt):
    if fmt == "corner":
        return boxes
    x, y, w, h = boxes.unbind(-1)
    return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], dim=-1)


def _to_center(boxes):
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1],
                       dim=-1)


def _plain_iou(a, b):
    """IoU of corner boxes (..., N, 4) x (..., M, 4) without clamping the
    areas (box_iou's and box_nms's formula)."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp_min(br - tl, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1]))[..., :, None]
    area_b = ((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]))[..., None, :]
    return inter / torch.clamp_min(area_a + area_b - inter, 1e-12)


@register_op("_contrib_box_iou", param_cls=BoxIouParam,
             input_names=("lhs", "rhs"))
def _box_iou(params, lhs, rhs):
    a = to_corner(lhs, params.format).reshape(-1, 4)
    b = to_corner(rhs, params.format).reshape(-1, 4)
    iou = _plain_iou(a, b)
    return iou.reshape(lhs.shape[:-1] + rhs.shape[:-1]).to(lhs.dtype)


class BoxNMSParam(Params):
    overlap_thresh = param_field(float, default=0.5)
    valid_thresh = param_field(float, default=0.0)
    topk = param_field(int, default=-1)
    coord_start = param_field(int, default=2)
    score_index = param_field(int, default=1)
    id_index = param_field(int, default=-1)
    force_suppress = param_field(bool, default=False)
    in_format = param_field(str, default="corner")
    out_format = param_field(str, default="corner")


@register_op("_contrib_box_nms", param_cls=BoxNMSParam)
def _box_nms(params, data):
    """data (..., N, K): each row set sorted by score, greedy NMS;
    suppressed and invalid rows become all -1."""
    cs, si, ii = params.coord_start, params.score_index, params.id_index
    shape = data.shape
    flat = data.reshape((-1,) + tuple(shape[-2:]))
    if data.device.type == "meta":
        return torch.empty(shape, dtype=data.dtype, device="meta")
    B, n = flat.shape[0], flat.shape[1]
    order = stable_order(flat[..., si])
    items = flat.gather(1, order[..., None].expand(flat.shape))
    boxes = to_corner(items[..., cs:cs + 4], params.in_format)
    suppress = _plain_iou(boxes, boxes) > params.overlap_thresh
    if not (params.force_suppress or ii < 0):
        suppress = suppress & (items[..., ii][..., :, None]
                               == items[..., ii][..., None, :])
    valid = items[..., si] > params.valid_thresh
    if params.topk > 0:
        valid = valid & (torch.arange(n, device=data.device) < params.topk)
    keep = greedy_keep(suppress, valid) & valid
    if params.out_format != params.in_format:
        coords = items[..., cs:cs + 4]
        conv = to_corner(coords, params.in_format) \
            if params.out_format == "corner" else _to_center(coords)
        items = torch.cat([items[..., :cs], conv.to(items.dtype),
                           items[..., cs + 4:]], dim=-1)
    out = torch.where(keep[..., None], items, -torch.ones_like(items))
    return out.reshape(shape).to(data.dtype)
