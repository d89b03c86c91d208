"""SSD's multibox ops of the port: ``MultiBoxPrior``, ``MultiBoxTarget``,
``MultiBoxDetection`` (``mxnet_tpu/ops/multibox.py``; reference
src/operator/contrib/multibox_{prior,target,detection}-inl.h).

Every op works on the whole batch at once:

- ``MultiBoxPrior`` is a closed-form broadcast over the (H, W, anchor)
  grid.
- ``MultiBoxTarget``'s greedy bipartite match is a loop over the ground
  truths whose step serves every sample (one argmax over each sample's
  flattened IoU matrix, the first maximum as the reference takes it);
  then the threshold match and the hard-negative mining, whose ranking
  is a stable sort.
- ``MultiBoxDetection``'s NMS is the greedy recursion ``keep[i] = no
  kept, valid j < i suppresses i``, solved by iterating it over the
  whole (batch, k, k) suppression matrix until nothing changes: the
  first t entries are final after t passes, and a suppression chain of
  depth d settles in d + 1, so a pass count is the chain's depth, not
  ``nms_topk``. The fixed point is the reference's loop's result.

Neither target nor detection has a gradient: both detach their inputs,
and the executor gives zeros to inputs that ask for one (the reference's
backward writes zeros).

The hard-negative ranking score ``1 - softmax(cls_pred)[0]`` is float32,
as the reference's: scores that float32 rounds equal keep their index
order. Two scores an ulp apart could rank otherwise where the card's
``exp`` and the CPU's differ in that ulp (ROADMAP §C).
"""
from __future__ import annotations

import torch

from ..base import Params, param_field
from .registry import register_op


def corner_iou(a, b):
    """IoU of corner boxes ``a`` (..., N, 4) and ``b`` (..., M, 4) ->
    (..., N, M), in the reference's operation order (its float32 results
    are then the same on every device)."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp_min(br - tl, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.clamp_min(a[..., 2] - a[..., 0], 0.0) * \
        torch.clamp_min(a[..., 3] - a[..., 1], 0.0)
    area_b = torch.clamp_min(b[..., 2] - b[..., 0], 0.0) * \
        torch.clamp_min(b[..., 3] - b[..., 1], 0.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / torch.clamp_min(union, 1e-12),
                       torch.zeros_like(inter))


def greedy_keep(suppress, valid):
    """The greedy NMS of a batch: ``suppress`` (B, k, k) bool, ``[b, j,
    i]`` when box j would suppress box i; ``valid`` (B, k) the boxes that
    may keep and suppress. Returns ``keep`` (B, k): box i is kept when no
    kept, valid box j < i suppresses it (a box that is not valid
    suppresses nothing). Solved by iterating the
    recursion to its fixed point (module docstring)."""
    k = suppress.shape[-1]
    later = torch.ones(k, k, dtype=torch.bool,
                       device=suppress.device).triu(1)
    # float32 counts of at most k ones are exact on every device
    weight = (suppress & later).to(torch.float32)
    keep = torch.ones(valid.shape, dtype=torch.bool, device=valid.device)
    for _ in range(k + 1):
        active = (keep & valid).to(torch.float32)[:, None, :]
        new = torch.bmm(active, weight)[:, 0] == 0
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def stable_order(score, descending=True):
    """``argsort`` that keeps equal scores in index order, as
    ``jnp.argsort`` (stable) and ``lax.top_k`` do."""
    return torch.sort(score, dim=-1, descending=descending,
                      stable=True).indices


# ---------------------------------------------------------------------------
# MultiBoxPrior (multibox_prior-inl.h)
# ---------------------------------------------------------------------------


class MultiBoxPriorParam(Params):
    sizes = param_field(tuple, default=(1.0,))
    ratios = param_field(tuple, default=(1.0,))
    clip = param_field(bool, default=False)
    steps = param_field(tuple, default=(-1.0, -1.0))
    offsets = param_field(tuple, default=(0.5, 0.5))


@register_op("_contrib_MultiBoxPrior", aliases=("MultiBoxPrior",),
             param_cls=MultiBoxPriorParam)
def _multibox_prior(params, data):
    """Anchors over the feature map (1, H*W*A, 4), corner format in
    [0, 1]: each size at ratio 1, then sizes[0] at each further ratio."""
    in_h, in_w = data.shape[2], data.shape[3]
    dev = data.device
    sizes = [float(s) for s in params.sizes]
    ratios = [float(r) for r in params.ratios]
    step_y, step_x = params.steps
    if step_y <= 0:
        step_y = 1.0 / in_h
    if step_x <= 0:
        step_x = 1.0 / in_w
    off_y, off_x = params.offsets
    cy = (torch.arange(in_h, dtype=torch.float32, device=dev) + off_y) * step_y
    cx = (torch.arange(in_w, dtype=torch.float32, device=dev) + off_x) * step_x
    # half-widths and heights (in_h / in_w keeps ratio-1 anchors square in
    # pixels, as the reference kernel does)
    ws = [s * in_h / in_w / 2.0 for s in sizes]
    hs = [s / 2.0 for s in sizes]
    for r in ratios[1:]:
        sr = r ** 0.5
        ws.append(sizes[0] * in_h / in_w * sr / 2.0)
        hs.append(sizes[0] / sr / 2.0)
    w = torch.tensor(ws, dtype=torch.float32, device=dev)
    h = torch.tensor(hs, dtype=torch.float32, device=dev)
    cyg = cy[:, None, None]
    cxg = cx[None, :, None]
    boxes = torch.stack(torch.broadcast_tensors(
        cxg - w, cyg - h, cxg + w, cyg + h), dim=-1)
    out = boxes.reshape(1, -1, 4)
    if params.clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out


# ---------------------------------------------------------------------------
# MultiBoxTarget (multibox_target-inl.h)
# ---------------------------------------------------------------------------


class MultiBoxTargetParam(Params):
    overlap_threshold = param_field(float, default=0.5)
    ignore_label = param_field(float, default=-1.0)
    negative_mining_ratio = param_field(float, default=-1.0)
    negative_mining_thresh = param_field(float, default=0.5)
    minimum_negative_samples = param_field(int, default=0)
    variances = param_field(tuple, default=(0.1, 0.1, 0.2, 0.2))


def _encode_targets(anchors, gt, variances):
    """Corner boxes -> (dx, dy, dw, dh) targets; ``anchors`` (N, 4),
    ``gt`` (B, N, 4)."""
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) * 0.5
    acy = (anchors[:, 1] + anchors[:, 3]) * 0.5
    gw = torch.clamp_min(gt[..., 2] - gt[..., 0], 1e-8)
    gh = torch.clamp_min(gt[..., 3] - gt[..., 1], 1e-8)
    gcx = (gt[..., 0] + gt[..., 2]) * 0.5
    gcy = (gt[..., 1] + gt[..., 3]) * 0.5
    v0, v1, v2, v3 = variances
    tx = (gcx - acx) / torch.clamp_min(aw, 1e-8) / v0
    ty = (gcy - acy) / torch.clamp_min(ah, 1e-8) / v1
    tw = torch.log(gw / torch.clamp_min(aw, 1e-8)) / v2
    th = torch.log(gh / torch.clamp_min(ah, 1e-8)) / v3
    return torch.stack([tx, ty, tw, th], dim=-1)


def multibox_match(anchors, label, cls_pred, p):
    """Targets of a batch: ``anchors`` (N, 4), ``label`` (B, O, >=5) with
    class -1 rows as padding, ``cls_pred`` (B, C, N). Returns box_target
    (B, N, 4), box_mask (B, N, 4) and cls_target (B, N)."""
    B, O = label.shape[0], label.shape[1]
    N = anchors.shape[0]
    dev = anchors.device
    gt_cls = label[..., 0]
    gt_boxes = label[..., 1:5]
    iou = corner_iou(anchors.expand(B, N, 4), gt_boxes)      # (B, N, O)
    iou = torch.where((gt_cls >= 0)[:, None, :], iou, torch.zeros_like(iou))

    # stage 1: greedy bipartite matching, highest pair first; one step
    # serves every sample
    rows = torch.arange(N, device=dev)
    cols = torch.arange(O, device=dev)
    matched = torch.full((B, N), -1, dtype=torch.int64, device=dev)
    work = iou.clone()
    for _ in range(O):
        flat = torch.argmax(work.reshape(B, -1), dim=1)       # first max
        best = work.reshape(B, -1).gather(1, flat[:, None])[:, 0]
        ai, gi = flat // O, flat % O
        hit = best > 1e-12
        at_row = hit[:, None] & (rows[None, :] == ai[:, None])
        matched = torch.where(at_row, gi[:, None], matched)
        retire = at_row[:, :, None] | (hit[:, None] & (
            cols[None, :] == gi[:, None]))[:, None, :]
        work = torch.where(retire, torch.full_like(work, -1.0), work)

    # stage 2: threshold matching of the anchors still unmatched
    best_iou = torch.amax(iou, dim=2)
    best_gt = torch.argmax(iou, dim=2)       # the first maximum
    thresh = (matched < 0) & (best_iou >= p.overlap_threshold)
    matched = torch.where(thresh, best_gt, matched)
    is_pos = matched >= 0
    safe = torch.clamp_min(matched, 0)
    zero = torch.zeros((), dtype=label.dtype, device=dev)
    cls_target = torch.where(is_pos, gt_cls.gather(1, safe) + 1.0, zero)

    if p.negative_mining_ratio > 0:
        neg_cand = (~is_pos) & (best_iou < p.negative_mining_thresh)
        bg = torch.softmax(cls_pred, dim=1)[:, 0]    # (B, N)
        neg_score = torch.where(neg_cand, 1.0 - bg,
                                torch.full_like(bg, -float("inf")))
        num_pos = is_pos.sum(dim=1).to(torch.float32)
        # a float32 product truncated to int32, as the reference
        max_neg = torch.clamp_min(
            (torch.tensor(p.negative_mining_ratio, dtype=torch.float32,
                          device=dev) * num_pos).to(torch.int32),
            p.minimum_negative_samples)
        order = stable_order(neg_score)
        rank = torch.empty_like(order).scatter_(
            1, order, rows.expand(B, N).contiguous())
        keep_neg = neg_cand & (rank < max_neg[:, None])
        cls_target = torch.where(is_pos, cls_target, torch.where(
            keep_neg, zero, torch.full_like(cls_target, p.ignore_label)))

    gt_sel = gt_boxes.gather(1, safe[..., None].expand(B, N, 4))
    targets = _encode_targets(anchors, gt_sel, p.variances)
    box_mask = is_pos[..., None].to(torch.float32).expand(B, N, 4)
    return targets * box_mask, box_mask, cls_target


@register_op("_contrib_MultiBoxTarget", aliases=("MultiBoxTarget",),
             param_cls=MultiBoxTargetParam,
             input_names=("anchor", "label", "cls_pred"), num_outputs=3,
             output_names=("box_target", "box_mask", "cls_target"))
def _multibox_target(params, anchor, label, cls_pred):
    anchor, label, cls_pred = (t.detach() for t in (anchor, label, cls_pred))
    anchors = anchor.reshape(-1, 4)
    if label.dim() == 2:
        label = label[None]
    B, N = label.shape[0], anchors.shape[0]
    if anchor.device.type == "meta":
        return (torch.empty((B, N * 4), device="meta"),
                torch.empty((B, N * 4), device="meta"),
                torch.empty((B, N), device="meta"))
    box_t, box_m, cls_t = multibox_match(anchors, label, cls_pred, params)
    return box_t.reshape(B, -1), box_m.reshape(B, -1).contiguous(), cls_t


# ---------------------------------------------------------------------------
# MultiBoxDetection (multibox_detection-inl.h)
# ---------------------------------------------------------------------------


class MultiBoxDetectionParam(Params):
    clip = param_field(bool, default=True)
    threshold = param_field(float, default=0.01)
    background_id = param_field(int, default=0)
    nms_threshold = param_field(float, default=0.5)
    force_suppress = param_field(bool, default=False)
    variances = param_field(tuple, default=(0.1, 0.1, 0.2, 0.2))
    nms_topk = param_field(int, default=-1)


def _decode_boxes(anchors, loc, variances, clip):
    """``anchors`` (N, 4), ``loc`` (B, N, 4) -> corner boxes (B, N, 4)."""
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) * 0.5
    acy = (anchors[:, 1] + anchors[:, 3]) * 0.5
    v0, v1, v2, v3 = variances
    cx = loc[..., 0] * v0 * aw + acx
    cy = loc[..., 1] * v1 * ah + acy
    w = torch.exp(loc[..., 2] * v2) * aw * 0.5
    h = torch.exp(loc[..., 3] * v3) * ah * 0.5
    out = torch.stack([cx - w, cy - h, cx + w, cy + h], dim=-1)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out


def multibox_detect(cls_prob, loc_pred, anchors, p):
    """Detections of a batch: ``cls_prob`` (B, C, N), ``loc_pred`` (B,
    N*4), ``anchors`` (N, 4) -> (B, N, 6) rows [id, score, x1, y1, x2,
    y2] sorted by score; suppressed and sub-threshold rows have id -1."""
    B, N = cls_prob.shape[0], anchors.shape[0]
    boxes = _decode_boxes(anchors, loc_pred.reshape(B, -1, 4), p.variances,
                          p.clip)
    bg = p.background_id
    fg = torch.cat([cls_prob[:, :bg], cls_prob[:, bg + 1:]], dim=1)
    best = torch.argmax(fg, dim=1)          # the first maximum
    score = torch.amax(fg, dim=1)
    minus = torch.full_like(score, -1.0)
    cls_id = torch.where(score >= p.threshold, best.to(score.dtype), minus)
    score = torch.where(cls_id >= 0, score, torch.zeros_like(score))
    order = stable_order(score)
    sid = cls_id.gather(1, order)
    sscore = score.gather(1, order)
    sboxes = boxes.gather(1, order[..., None].expand(B, N, 4))
    if 0.0 < p.nms_threshold <= 1.0:
        k = min(p.nms_topk if p.nms_topk > 0 else N, N)
        top = sboxes[:, :k]
        suppress = corner_iou(top, top) > p.nms_threshold
        if not p.force_suppress:
            suppress = suppress & (sid[:, :k, None] == sid[:, None, :k])
        keep = greedy_keep(suppress, sid[:, :k] >= 0)
        sid = torch.cat([torch.where(keep, sid[:, :k], minus[:, :k]),
                         minus[:, k:]], dim=1)
    return torch.cat([sid[..., None], sscore[..., None], sboxes], dim=-1)


@register_op("_contrib_MultiBoxDetection", aliases=("MultiBoxDetection",),
             param_cls=MultiBoxDetectionParam,
             input_names=("cls_prob", "loc_pred", "anchor"))
def _multibox_detection(params, cls_prob, loc_pred, anchor):
    cls_prob, loc_pred, anchor = (t.detach()
                                  for t in (cls_prob, loc_pred, anchor))
    anchors = anchor.reshape(-1, 4)
    if anchor.device.type == "meta":
        return torch.empty((cls_prob.shape[0], anchors.shape[0], 6),
                           device="meta")
    return multibox_detect(cls_prob, loc_pred, anchors, params)
