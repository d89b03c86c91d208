"""Flash attention of the port: plain PyTorch versions, the kernel tier
resolver, and the autograd Functions over the hand-written CUDA kernels.

Counterpart of ``mxnet_tpu/kernels/flash_attention.py``. Shapes follow
``[batch, heads, seq, head_dim]`` throughout, as there.

- ``attention_with_lse`` / ``merge_attention`` / ``blockwise_attention``
  are the plain versions, with the same ``q_offset``/``k_offset``
  semantics: a query row at global position ``q_offset + i`` sees a key at
  ``k_offset + j`` iff ``q_offset + i >= k_offset + j``; fully masked rows
  get out 0 and lse pinned to -1e30.
- Two kernel families, each kernel library with its plain version here.
  ``variant="stream"``: ``csrc/flash_fwd_offs.cu`` (TPU kernel
  ``_flash_fwd_offs_kernel``; plain ``flash_fwd_offs_plain``),
  ``csrc/flash_fwd.cu`` (``_flash_fwd_kernel``; ``flash_fwd_plain``) and
  ``csrc/flash_bwd_offs.cu`` (the pair ``_flash_bwd_dq_offs_kernel``/
  ``_flash_bwd_dkv_offs_kernel``; ``flash_bwd_offs_plain``).
  ``variant="grid"``, split-KV: ``csrc/flash_fwd_offs_grid.cu``
  (``_flash_fwd_offs_grid_kernel``; ``flash_fwd_offs_grid_plain``),
  ``csrc/flash_fwd_grid.cu`` (``_flash_fwd_grid_kernel``;
  ``flash_fwd_grid_plain``) and ``csrc/flash_bwd_grid.cu``
  (``_flash_bwd_dq_grid_kernel``/``_flash_bwd_dkv_grid_kernel``;
  ``flash_bwd_offs_grid_plain``). Where the TPU grid walks the key axis as
  a sequential grid dimension, the grid kernels split it across blocks of
  ``block_k`` keys (rounded up to the kernels' 32-key split unit,
  :func:`split_width`) and a second pass merges (forward) or sums
  (backward) the splits in split order; the plain versions compute the
  same per-split partials and the same merge.
- ``_FlashWithLse`` (behind ``flash_attention_with_lse``) and
  ``_FlashAttention`` (behind ``flash_attention``) are the
  ``torch.autograd.Function`` counterparts of the JAX package's two
  ``custom_vjp``s, for both variants: forward by the offset or the plain
  forward kernel, backward by the backward pair of the same variant (with
  the real lse cotangent, or at ``offs = [0, 0]`` with none). On CUDA
  tensors they launch the kernels or raise; on CPU tensors they run the
  plain versions; any other device raises. There is no fallback from the
  card to the plain version, nor from one variant to the other.
- Dtypes: float32, bfloat16 and float16 in every kernel. The two 16-bit
  types take the 16-bit bodies (``csrc/flash_fwd_half.cuh`` and
  ``csrc/flash_bwd_half.cuh``, one template for both: one 16-bit
  tensor-core product a step), the grid kernels over the same splits with
  float32 partials and a combine or reduce pass that rounds once; their
  plain versions round where the JAX kernels round on 16-bit inputs: q
  folded and rounded, scores, softmax statistics, split partials and
  every sum in float32, ``p`` and ``ds`` rounded to the operand's dtype
  before their products (float16 keeps its subnormals), outputs rounded
  once at the end, lse float32. q, k and v (and ``do``) share one dtype;
  a mix, or another dtype, raises.
- ``resolve_kernel_tier`` keeps the JAX package's tier vocabulary
  (``MXNET_SERVING_DECODE_FLASH``, ``MXNET_TPU_MESH_KERNEL_TIER``): auto |
  1/on | 0/off, where ``interpret`` has no counterpart (a CUDA kernel has
  no interpret mode) and raises.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..base import MXNetError

__all__ = ["attention_with_lse", "merge_attention", "blockwise_attention",
           "flash_fwd_offs_plain", "flash_fwd_plain", "flash_bwd_offs_plain",
           "flash_fwd_grid_plain", "flash_fwd_offs_grid_plain",
           "flash_bwd_offs_grid_plain", "split_width", "fwd_grid_parts",
           "bwd_grid_parts",
           "flash_attention_with_lse", "flash_attention",
           "resolve_kernel_tier", "kernel_status", "masked_value"]

_NEG_INF = -1e30

#: Launches of each CUDA kernel (plain-version calls are not counted);
#: callers may reset them to 0. ``launches``: the offset forward
#: (``flash_fwd_offs.cu``); ``launches_fwd``: the plain forward
#: (``flash_fwd.cu``); ``launches_bwd_dq`` / ``launches_bwd_dkv``: the
#: backward pair (``flash_bwd_offs.cu``). The grid variant:
#: ``launches_fwd_grid`` and ``launches_fwd_grid_combine``
#: (``flash_fwd_grid.cu``), ``launches_fwd_offs_grid`` and
#: ``launches_fwd_offs_grid_combine`` (``flash_fwd_offs_grid.cu``),
#: ``launches_bwd_dq_grid`` / ``launches_bwd_dkv_grid`` and their
#: ``_reduce`` passes (``flash_bwd_grid.cu``). A combine or reduce pass
#: runs only when there is more than one split. Each counter's ``_bf16``
#: and ``_f16`` siblings (``launches_bf16``, ``launches_fwd_grid_f16``,
#: ``launches_bwd_dkv_grid_reduce_bf16``, ...) count the bf16 and float16
#: instantiations of the same kernel (the same library, entries
#: ``mx_*_bf16`` and ``mx_*_f16``).
launches = 0
launches_fwd = 0
launches_bwd_dq = 0
launches_bwd_dkv = 0
launches_fwd_grid = 0
launches_fwd_grid_combine = 0
launches_fwd_offs_grid = 0
launches_fwd_offs_grid_combine = 0
launches_bwd_dq_grid = 0
launches_bwd_dq_grid_reduce = 0
launches_bwd_dkv_grid = 0
launches_bwd_dkv_grid_reduce = 0
launches_bf16 = 0
launches_fwd_bf16 = 0
launches_bwd_dq_bf16 = 0
launches_bwd_dkv_bf16 = 0
launches_fwd_grid_bf16 = 0
launches_fwd_grid_combine_bf16 = 0
launches_fwd_offs_grid_bf16 = 0
launches_fwd_offs_grid_combine_bf16 = 0
launches_bwd_dq_grid_bf16 = 0
launches_bwd_dq_grid_reduce_bf16 = 0
launches_bwd_dkv_grid_bf16 = 0
launches_bwd_dkv_grid_reduce_bf16 = 0
launches_f16 = 0
launches_fwd_f16 = 0
launches_bwd_dq_f16 = 0
launches_bwd_dkv_f16 = 0
launches_fwd_grid_f16 = 0
launches_fwd_grid_combine_f16 = 0
launches_fwd_offs_grid_f16 = 0
launches_fwd_offs_grid_combine_f16 = 0
launches_bwd_dq_grid_f16 = 0
launches_bwd_dq_grid_reduce_f16 = 0
launches_bwd_dkv_grid_f16 = 0
launches_bwd_dkv_grid_reduce_f16 = 0

_HEAD_DIMS = (32, 64, 128)
# the split unit, 32 rows (the kernels walk 64-row tiles, 32 at D = 128,
# from a split's first row and mask past its end)
_TILE = 32


@functools.lru_cache(maxsize=None)
def masked_value(dtype):
    """The mask value -1e30 as jnp casts it to ``dtype``, a Python float:
    float16 has no such magnitude and rounds it to -inf (an exp of 0
    either way). On CUDA torch refuses a scalar its dtype cannot hold."""
    return float(torch.tensor(_NEG_INF).to(dtype))


def _fold_scale(q, sm_scale):
    """q * sm_scale rounded back to q's dtype, once per call — the kernels
    fold identically, and the backward recomputes scores from the same
    rounded q."""
    return (q.float() * sm_scale).to(q.dtype)


def _visible(q_len, k_len, q_offset, k_offset, device):
    """Causal visibility of a q block at a global offset against a k block.
    Offsets may be Python ints or 0-d tensors on ``device``."""
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    k_pos = k_offset + torch.arange(k_len, device=device)[None, :]
    return q_pos >= k_pos


def _causal_mask(q_len, k_len, q_offset, k_offset, dtype, device):
    """Additive causal mask for a q block at global offset vs a k block."""
    return torch.where(_visible(q_len, k_len, q_offset, k_offset, device),
                       0.0, _NEG_INF).to(dtype)


def attention_with_lse(q, k, v, *, causal=False, sm_scale=None,
                       q_offset=0, k_offset=0, bias=None):
    """Softmax attention returning (out, lse).

    q: [..., Sq, D], k/v: [..., Sk, D]. ``lse[..., Sq]`` is the
    logsumexp of the scaled (and masked) logits over the key axis."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("...qd,...kd->...qk", q, k) * sm_scale
    if bias is not None:
        logits = logits + bias
    if causal:
        logits = logits + _causal_mask(q.shape[-2], k.shape[-2], q_offset,
                                       k_offset, logits.dtype, q.device)
    lse = torch.logsumexp(logits, dim=-1)
    weights = torch.exp(logits - lse[..., None])
    # fully-masked rows: every logit is -1e30, so zero the output and pin
    # lse to -1e30 so merge_attention gives such chunks no weight
    live = lse > _NEG_INF / 2
    weights = torch.where(live[..., None], weights, 0.0)
    lse = torch.where(live, lse, masked_value(lse.dtype))
    out = torch.einsum("...qk,...kd->...qd", weights, v)
    return out, lse


def merge_attention(out_a, lse_a, out_b, lse_b):
    """Exactly combine two partial attentions over disjoint key sets."""
    m = torch.maximum(lse_a, lse_b)
    m = torch.where(m > _NEG_INF / 2, m, 0.0)  # both fully masked: no nan
    wa = torch.exp(lse_a - m)
    wb = torch.exp(lse_b - m)
    s = wa + wb
    denom = torch.where(s == 0.0, 1.0, s)
    out = (out_a * wa[..., None] + out_b * wb[..., None]) / denom[..., None]
    # guarded log: s == 0 (both fully masked) stays at -1e30, not -inf
    lse = torch.where(s > 0.0, m + torch.log(denom), _NEG_INF)
    return out, lse


def blockwise_attention(q, k, v, *, causal=False, sm_scale=None,
                        block_k=256, q_offset=0, k_offset=0):
    """Attention as a loop over KV blocks merged with ``merge_attention``
    (online softmax); peak memory O(Sq * block_k). The merged output is
    carried in float32 at least and returned in q's dtype (the JAX
    version's scan refuses the float32 carry that bf16 inputs produce)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    sk = k.shape[-2]
    block_k = min(block_k, sk)
    if sk % block_k != 0:   # one block if it does not divide
        block_k = sk
    out = torch.zeros(q.shape[:-1] + (v.shape[-1],),
                      dtype=torch.promote_types(q.dtype, torch.float32),
                      device=q.device)
    lse = torch.full(q.shape[:-1], _NEG_INF, dtype=torch.float32,
                     device=q.device)
    for i in range(sk // block_k):
        sl = slice(i * block_k, (i + 1) * block_k)
        ob, lb = attention_with_lse(
            q, k[..., sl, :], v[..., sl, :], causal=causal,
            sm_scale=sm_scale, q_offset=q_offset,
            k_offset=k_offset + i * block_k)
        out, lse = merge_attention(out, lse, ob, lb)
    return out.to(q.dtype), lse


def _rounded_parts(qs, k, v, causal, q_offset, k_offset):
    """(out, lse) in float32 of the stream forward's maths on
    low-precision inputs, before the output's rounding: ``qs`` the folded
    q in q's dtype, scores and softmax statistics in float32, ``p = exp(s
    - m)`` against the row max rounded to v's dtype before ``p @ v`` with
    a float32 sum, out normalized in float32. A row with no visible key
    gets out 0 and lse -1e30."""
    s = torch.einsum("...qd,...kd->...qk", qs.float(), k.float())
    if causal:
        s = torch.where(_visible(qs.shape[-2], k.shape[-2], q_offset,
                                 k_offset, qs.device), s, _NEG_INF)
    m = s.amax(-1)
    m_safe = torch.where(m > _NEG_INF / 2, m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    l = p.sum(-1)
    o = torch.einsum("...qk,...kd->...qd", p.to(v.dtype).float(), v.float())
    denom = torch.where(l > 0.0, l, 1.0)
    return (o / denom[..., None],
            torch.where(l > 0.0, m_safe + torch.log(denom), _NEG_INF))


def _attention_rounded(q, k, v, causal, q_offset, k_offset, sm_scale):
    """(out, lse) of the stream forward on low-precision inputs, rounded
    where the JAX kernels round (``_flash_fwd_kernel`` L205-260): the
    folded q in q's dtype, scores and softmax statistics in float32,
    ``p = exp(s - m)`` against the row max rounded to v's dtype before
    ``p @ v`` with a float32 sum, out rounded to q's dtype at the end
    (:func:`_rounded_parts`). The kernels take the max over key tiles as
    they go; this takes the row's max at once, so ``p`` rounds at another
    scale (within a bf16 ulp of out). A row with no visible key gets out
    0 and lse -1e30."""
    out, lse = _rounded_parts(_fold_scale(q, sm_scale), k, v, causal,
                              q_offset, k_offset)
    return out.to(q.dtype), lse


def flash_fwd_offs_plain(q, k, v, offs, sm_scale=None, causal=True):
    """Plain version of the offset-aware flash forward: the same folded
    scale and masking as the kernel, as one full softmax. ``offs`` is an
    int tensor ``[q0, k0]`` of global offsets on q's device. Inputs that
    are not float32 take the kernel's roundings
    (:func:`_attention_rounded`)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.dtype != torch.float32:
        return _attention_rounded(q, k, v, causal, offs[0], offs[1],
                                  sm_scale)
    return attention_with_lse(_fold_scale(q, sm_scale), k, v, causal=causal,
                              sm_scale=1.0, q_offset=offs[0],
                              k_offset=offs[1])


def flash_fwd_plain(q, k, v, sm_scale=None, causal=False):
    """Plain version of the flash forward without offsets (the TPU kernel
    ``_flash_fwd_kernel``): ``(out, lse)`` with the kernel's folded scale.
    Without offsets no causal row is fully masked. Inputs that are not
    float32 take the kernel's roundings (:func:`_attention_rounded`)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.dtype != torch.float32:
        return _attention_rounded(q, k, v, causal, 0, 0, sm_scale)
    return attention_with_lse(_fold_scale(q, sm_scale), k, v, causal=causal,
                              sm_scale=1.0)


def _deff(do, out, dlse):
    """delta_eff = rowsum(do * out) - dlse in float32 (``_bwd_staging``):
    the lse cotangent folds into the per-row scalar of the backward. A
    ``None`` dlse counts as zeros."""
    delta = (do.float() * out.float()).sum(-1)
    return delta if dlse is None else delta - dlse.float()


def _bwd_terms(q, k, v, offs, do, dlse, out, lse, sm_scale, causal):
    """(folded q, p, ds) of the backward kernels' formulas, in float32.
    Scores come from the folded q, as in the forward; ``do`` enters the
    products in v's dtype (the JAX kernels cast it once), ``deff`` from
    ``do`` as given. Rows with lse pinned to -1e30 (no visible key) use a
    +1e30 substitute, so ``exp`` gives exactly 0 there."""
    qs = _fold_scale(q, sm_scale)
    s = torch.einsum("...qd,...kd->...qk", qs.float(), k.float())
    if causal:
        s = torch.where(_visible(q.shape[-2], k.shape[-2], offs[0], offs[1],
                                 q.device), s, _NEG_INF)
    lse = lse.float()
    lse_safe = torch.where(lse > _NEG_INF / 2, lse, -_NEG_INF)
    p = torch.exp(s - lse_safe[..., None])
    dp = torch.einsum("...qd,...kd->...qk", do.to(v.dtype).float(),
                      v.float())
    ds = p * (dp - _deff(do, out, dlse)[..., None])
    return qs, p, ds


def flash_bwd_offs_plain(q, k, v, offs, do, dlse, out, lse, sm_scale=None,
                         causal=True):
    """Plain version of the backward pair at global offsets ``offs =
    [q0, k0]``: ``(dq, dk, dv)`` written out from the kernels' formulas
    (:func:`_bwd_terms`), not by autograd. ``dk`` accumulates against the
    folded q (no further ``sm_scale``) and ``dq`` takes ``sm_scale``
    once. ``ds`` and ``p`` round to the dtype of the operand they meet
    before each product, as the JAX kernels round them (L433, L485-488);
    the sums are float32 and the results round once, at the end. On
    float32 inputs the roundings are no-ops."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    qs, p, ds = _bwd_terms(q, k, v, offs, do, dlse, out, lse, sm_scale,
                           causal)
    do = do.to(v.dtype)
    dq = torch.einsum("...qk,...kd->...qd", ds.to(k.dtype).float(),
                      k.float()) * sm_scale
    dk = torch.einsum("...qk,...qd->...kd", ds.to(qs.dtype).float(),
                      qs.float())
    dv = torch.einsum("...qk,...qd->...kd", p.to(do.dtype).float(),
                      do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def split_width(block, n):
    """Rows (keys or queries) per split of the grid kernels: the JAX
    call's block size, ``min(block, n)`` as the JAX launchers take it,
    rounded up to the kernels' 32-row split unit. Idempotent. The split
    count ``ceil(n / width)`` thus depends on shapes and arguments only,
    never on the device, which keeps serving bit-identical under
    batching."""
    b = max(1, min(int(block), n))
    return -(-b // _TILE) * _TILE


def _splits(n, width):
    """The ``ceil(n / width)`` split ranges of an axis of length ``n``
    (at least one)."""
    return [slice(i, min(i + width, n))
            for i in range(0, max(n, 1), width)]


def _combine_splits(out_part, lse_part):
    """Merge per-split partials ``[n_split, ..., sq, D]`` /
    ``[n_split, ..., sq]`` (normalized outs and their lse) with
    :func:`merge_attention`'s maths, summing in split order: the grid
    combine kernel's function. Splits a row cannot see hold (0, -1e30)
    and weigh exactly 0; a row that sees none gets (0, -1e30)."""
    m = lse_part.max(0).values
    m = torch.where(m > _NEG_INF / 2, m, 0.0)   # no live split: no nan
    wts = torch.exp(lse_part - m)
    acc, l = out_part[0] * wts[0][..., None], wts[0]
    for s in range(1, lse_part.shape[0]):
        acc = acc + out_part[s] * wts[s][..., None]
        l = l + wts[s]
    denom = torch.where(l == 0.0, 1.0, l)
    lse = torch.where(l > 0.0, m + torch.log(denom), _NEG_INF)
    return acc / denom[..., None], lse


def _sum_splits(parts):
    """Sum over the leading split axis in split order (the reduce
    kernels' order)."""
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return acc


def fwd_grid_parts(q, k, v, q0, k0, sm_scale, causal, block_k):
    """The split forward's per-split partials ``(out_part [n_split, ...,
    sq, D], lse_part [n_split, ..., sq])``: each split's own softmax over
    its :func:`split_width` ``(block_k)`` keys, with the kernel's folded
    scale; a row that sees no key of a split holds (0, -1e30) there.
    Inputs that are not float32 take the stream forward's roundings
    (:func:`_rounded_parts`: scores, statistics and sums in float32, ``p``
    rounded before ``p @ v``) and give float32 partials, as the JAX grid
    kernels carry their float32 scratch across key blocks."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    qs = _fold_scale(q, sm_scale)
    sk = k.shape[-2]
    if q.dtype == torch.float32:
        def part(sl):
            return attention_with_lse(qs, k[..., sl, :], v[..., sl, :],
                                      causal=causal, sm_scale=1.0,
                                      q_offset=q0, k_offset=k0 + sl.start)
    else:
        def part(sl):
            return _rounded_parts(qs, k[..., sl, :], v[..., sl, :], causal,
                                  q0, k0 + sl.start)
    parts = [part(sl) for sl in _splits(sk, split_width(block_k, sk))]
    return (torch.stack([o for o, _ in parts]),
            torch.stack([l for _, l in parts]))


def _fwd_grid_plain(q, k, v, q0, k0, sm_scale, causal, block_k):
    """(out, lse): the partials merged (one split: its partial), out
    rounded to q's dtype once, at the end; lse float32 for inputs that
    are not float32."""
    out_part, lse_part = fwd_grid_parts(q, k, v, q0, k0, sm_scale, causal,
                                        block_k)
    if out_part.shape[0] == 1:     # one split: its partial is the result
        out, lse = out_part[0], lse_part[0]
    else:
        out, lse = _combine_splits(out_part, lse_part)
    return out.to(q.dtype), lse


def flash_fwd_grid_plain(q, k, v, sm_scale=None, causal=False, block_k=512):
    """Plain version of the split-KV forward without offsets (TPU kernel
    ``_flash_fwd_grid_kernel``): per-split ``(out, lse)`` over
    :func:`split_width` ``(block_k)`` keys each, merged by
    :func:`_combine_splits`, with the kernel's folded scale."""
    return _fwd_grid_plain(q, k, v, 0, 0, sm_scale, causal, block_k)


def flash_fwd_offs_grid_plain(q, k, v, offs, sm_scale=None, causal=True,
                              block_k=512):
    """Plain version of the split-KV forward at global offsets ``offs =
    [q0, k0]`` (TPU kernel ``_flash_fwd_offs_grid_kernel``): as
    :func:`flash_fwd_grid_plain`; rows with no visible key get out 0 and
    lse -1e30 exactly."""
    return _fwd_grid_plain(q, k, v, offs[0], offs[1], sm_scale, causal,
                           block_k)


def flash_bwd_offs_grid_plain(q, k, v, offs, do, dlse, out, lse,
                              sm_scale=None, causal=True, block_q=512,
                              block_k=512):
    """Plain version of the split backward (TPU kernels
    ``_flash_bwd_dq_grid_kernel`` / ``_flash_bwd_dkv_grid_kernel``): the
    formulas of :func:`flash_bwd_offs_plain`, with ``dq`` summed over key
    splits of :func:`split_width` ``(block_k)`` and ``dk``/``dv`` over
    query splits of ``split_width(block_q)``, each in split order, then
    ``dq`` scaled by ``sm_scale`` once."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    dq, dk, dv = bwd_grid_parts(q, k, v, offs, do, dlse, out, lse, sm_scale,
                                causal, block_q, block_k)
    return ((_sum_splits(dq) * sm_scale).to(q.dtype),
            _sum_splits(dk).to(k.dtype), _sum_splits(dv).to(v.dtype))


def bwd_grid_parts(q, k, v, offs, do, dlse, out, lse, sm_scale, causal,
                   block_q, block_k):
    """The split backward's per-split partials in float32: unscaled
    ``dq`` over key splits of :func:`split_width` ``(block_k)``, ``dk`` and
    ``dv`` over query splits of ``split_width(block_q)``, each stacked on
    a leading split axis; a split a row (key) cannot see holds zeros.
    ``ds`` and ``p`` round to the dtype of the operand they meet before
    each product, as in :func:`flash_bwd_offs_plain` (no-ops on float32);
    the partials stay float32."""
    qs, p, ds = _bwd_terms(q, k, v, offs, do, dlse, out, lse, sm_scale,
                           causal)
    do = do.to(v.dtype)
    sq, sk = q.shape[-2], k.shape[-2]
    kf, qsf, dof = k.float(), qs.float(), do.float()
    ds_k = ds.to(k.dtype).float()
    ds_q = ds.to(qs.dtype).float()
    p_do = p.to(do.dtype).float()
    dq = torch.stack([ds_k[..., sl] @ kf[..., sl, :]
                      for sl in _splits(sk, split_width(block_k, sk))])
    q_splits = _splits(sq, split_width(block_q, sq))
    dk = torch.stack([ds_q[..., sl, :].transpose(-1, -2) @ qsf[..., sl, :]
                      for sl in q_splits])
    dv = torch.stack([p_do[..., sl, :].transpose(-1, -2) @ dof[..., sl, :]
                      for sl in q_splits])
    return dq, dk, dv


def resolve_kernel_tier(mode, device):
    """-> True when the kernel tier runs for tensors on ``device``.

    ``auto``: the kernel on CUDA, the plain version on the CPU; ``1``/
    ``on``: the kernel, and a CPU device raises; ``0``/``off``: the plain
    version, by explicit choice. ``interpret`` (the JAX package's Pallas
    interpret mode) has no counterpart and raises; so does any other
    value — a typo'd tier silently running the plain path is exactly the
    failure this guards."""
    mode = str(mode).strip().lower()
    device = torch.device(device)
    if mode in ("auto", ""):
        return device.type == "cuda"
    if mode in ("1", "on", "pallas", "kernel"):
        if device.type != "cuda":
            raise MXNetError("kernel tier %r needs CUDA tensors, got device "
                             "%s" % (mode, device))
        return True
    if mode in ("0", "off", "lax"):
        return False
    if mode == "interpret":
        raise MXNetError("kernel tier 'interpret' has no counterpart in the "
                         "port: a CUDA kernel runs only on the card (use "
                         "auto, on or off)")
    raise MXNetError("kernel tier %r not understood (auto | 1/on | 0/off)"
                     % (mode,))


def kernel_status():
    """(available, reason): "cuda" when the card and ``nvcc`` are there,
    else "no-cuda" or "no-nvcc"."""
    from . import _build
    if not torch.cuda.is_available():
        return False, "no-cuda"
    if _build.nvcc_path() is None:
        return False, "no-nvcc"
    return True, "cuda"


# --- the CUDA wrappers -----------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C entry -> (library, argument types); every entry returns a CUDA error.
_ENTRIES = {
    "mx_flash_fwd_offs_f32": ("flash_fwd_offs",
                              [_P] * 6 + [_I] * 4 + [_F, _I, _P]),
    "mx_flash_fwd_f32": ("flash_fwd", [_P] * 5 + [_I] * 4 + [_F, _I, _P]),
    "mx_flash_bwd_dq_f32": ("flash_bwd_offs",
                            [_P] * 8 + [_I] * 4 + [_F, _I, _P]),
    "mx_flash_bwd_dkv_f32": ("flash_bwd_offs",
                             [_P] * 9 + [_I] * 4 + [_F, _I, _P]),
    "mx_flash_fwd_grid_f32": ("flash_fwd_grid",
                              [_P] * 5 + [_I] * 6 + [_F, _I, _P]),
    "mx_flash_fwd_grid_combine_f32": ("flash_fwd_grid",
                                      [_P] * 4 + [_I] * 6 + [_P]),
    "mx_flash_fwd_offs_grid_f32": ("flash_fwd_offs_grid",
                                   [_P] * 6 + [_I] * 6 + [_F, _I, _P]),
    "mx_flash_fwd_offs_grid_combine_f32": ("flash_fwd_offs_grid",
                                           [_P] * 5 + [_I] * 6 + [_P]),
    "mx_flash_bwd_dq_grid_f32": ("flash_bwd_grid",
                                 [_P] * 8 + [_I] * 6 + [_F, _I, _P]),
    "mx_flash_bwd_dkv_grid_f32": ("flash_bwd_grid",
                                  [_P] * 9 + [_I] * 6 + [_F, _I, _P]),
    "mx_flash_bwd_dq_grid_reduce_f32": ("flash_bwd_grid",
                                        [_P] * 3 + [_I] * 5 + [_F, _I, _P]),
    "mx_flash_bwd_dkv_grid_reduce_f32": ("flash_bwd_grid",
                                         [_P] * 5 + [_I] * 7 + [_P]),
    "mx_flash_fwd_offs_bf16": ("flash_fwd_offs",
                               [_P] * 6 + [_I] * 4 + [_F, _I, _P]),
    "mx_flash_fwd_bf16": ("flash_fwd", [_P] * 5 + [_I] * 4 + [_F, _I, _P]),
    "mx_flash_bwd_dq_bf16": ("flash_bwd_offs",
                             [_P] * 8 + [_I] * 4 + [_F, _I, _P]),
    "mx_flash_bwd_dkv_bf16": ("flash_bwd_offs",
                              [_P] * 9 + [_I] * 4 + [_F, _I, _P]),
}
# the grid kernels' 16-bit entries take the float32 entries' arguments (an
# output is 16-bit with one split, the float32 workspace with several)
_ENTRIES.update({name[:-3] + "bf16": spec for name, spec in _ENTRIES.items()
                 if "_grid" in name})
# the float16 entries take the bf16 entries' arguments
_ENTRIES.update({name[:-4] + "f16": spec for name, spec in _ENTRIES.items()
                 if name.endswith("_bf16")})
#: what the kernels take, -> the suffix of their C entries
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.float16: "f16"}
_fns = {}


def _entry(name):
    """The C entry ``name``, its library built on first use."""
    fn = _fns.get(name)
    if fn is None:
        from . import _build
        lib, argtypes = _ENTRIES[name]
        fn = getattr(_build.load(lib), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _launch(name, *args, device):
    """Call C entry ``name`` on ``device``'s current stream; raise on a
    refused launch."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _entry(name)(*args, stream)
    if err != 0:
        raise MXNetError("%s launch failed: CUDA error %d" % (name, err))


def _count(counter, suffix):
    """One launch more on ``counter``, or on its ``_bf16`` or ``_f16``
    sibling."""
    name = counter if suffix == "f32" else counter + "_" + suffix
    globals()[name] += 1


def _check(where, name, t, device, dtype, ndim):
    if t.device != device:
        raise MXNetError("%s: %s on %s, q on %s" % (where, name, t.device,
                                                    device))
    if t.dtype != dtype:
        raise MXNetError("%s: %s is %s, the kernel takes %s"
                         % (where, name, t.dtype, dtype))
    if t.dim() != ndim:
        raise MXNetError("%s: %s has %d dims, want %d" % (where, name,
                                                          t.dim(), ndim))
    if not t.is_contiguous():
        raise MXNetError("%s: %s is not contiguous" % (where, name))


def _check_qkv(where, q, k, v, offs=None):
    """Shapes (b, h, sq, d) / (b, h, sk, d), contiguous, one device, q's
    dtype one of ``_DTYPES`` and k's and v's the same; d in the kernels'
    set. -> (b, h, sq, sk, d)."""
    dev = q.device
    dtype = q.dtype if q.dtype in _DTYPES else torch.float32
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(where, name, t, dev, dtype, 4)
    if offs is not None:
        _check(where, "offs", offs, dev, torch.int32, 1)
        if offs.numel() != 2:
            raise MXNetError("%s: offs must be int32[2]" % where)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if tuple(k.shape) != (b, h, sk, d) or tuple(v.shape) != (b, h, sk, d):
        raise MXNetError("%s: k %s / v %s do not match q %s"
                         % (where, tuple(k.shape), tuple(v.shape),
                            tuple(q.shape)))
    if d not in _HEAD_DIMS:
        raise MXNetError("%s: head dim %d not in %s" % (where, d,
                                                        _HEAD_DIMS))
    return b, h, sq, sk, d


def _check_bwd(where, q, k, v, offs, do, deff, lse):
    """The backward kernels' inputs (``_check_qkv`` plus do in q's dtype,
    lse and deff in float32)."""
    b, h, sq, sk, d = _check_qkv(where, q, k, v, offs)
    _check(where, "do", do, q.device, q.dtype, 4)
    if tuple(do.shape) != tuple(q.shape):
        raise MXNetError("%s: do %s, want %s" % (where, tuple(do.shape),
                                                 tuple(q.shape)))
    for name, t in (("lse", lse), ("deff", deff)):
        _check(where, name, t, q.device, torch.float32, 3)
        if tuple(t.shape) != (b, h, sq):
            raise MXNetError("%s: %s %s, want %s" % (where, name,
                                                     tuple(t.shape),
                                                     (b, h, sq)))
    return b, h, sq, sk, d


def _flash_fwd_offs_cuda(q, k, v, offs, sm_scale, causal):
    """(out, lse) by ``flash_fwd_offs.cu`` (#1), float32, bf16 or
    float16."""
    b, h, sq, sk, d = _check_qkv("flash_attention_with_lse", q, k, v, offs)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if b * h * sq == 0:
        return out, lse
    suffix = _DTYPES[q.dtype]
    _launch("mx_flash_fwd_offs_" + suffix, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), offs.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b * h, sq, sk, d, float(sm_scale), int(bool(causal)),
            device=q.device)
    _count("launches", suffix)
    return out, lse


def _flash_fwd_cuda(q, k, v, sm_scale, causal):
    """(out, lse) by ``flash_fwd.cu`` (#5), float32, bf16 or float16."""
    b, h, sq, sk, d = _check_qkv("flash_attention", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if b * h * sq == 0:
        return out, lse
    suffix = _DTYPES[q.dtype]
    _launch("mx_flash_fwd_" + suffix, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), lse.data_ptr(), b * h, sq, sk, d,
            float(sm_scale), int(bool(causal)), device=q.device)
    _count("launches_fwd", suffix)
    return out, lse


def _flash_bwd_cuda(q, k, v, offs, do, deff, lse, sm_scale, causal):
    """dq, dk, dv by the backward pair (#2), float32, bf16 or float16.
    ``deff`` is ``_deff``'s output; ``do`` is in q's dtype."""
    b, h, sq, sk, d = _check_bwd("flash attention backward", q, k, v, offs,
                                 do, deff, lse)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if b * h * sq == 0 or sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    suffix = _DTYPES[q.dtype]
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), offs.data_ptr(),
              do.data_ptr(), lse.data_ptr(), deff.data_ptr())
    tail = (b * h, sq, sk, d, float(sm_scale), int(bool(causal)))
    _launch("mx_flash_bwd_dq_" + suffix, *common, dq.data_ptr(), *tail,
            device=q.device)
    _count("launches_bwd_dq", suffix)
    _launch("mx_flash_bwd_dkv_" + suffix, *common, dk.data_ptr(),
            dv.data_ptr(), *tail, device=q.device)
    _count("launches_bwd_dkv", suffix)
    return dq, dk, dv


def _check_width(where, width):
    if width <= 0 or width % _TILE:
        raise MXNetError("%s: split width %d is not a positive multiple of "
                         "%d (split_width)" % (where, width, _TILE))


def _flash_fwd_grid_cuda(q, k, v, offs, sm_scale, causal, width):
    """(out, lse) by the split-KV forward, float32, bf16 or float16:
    ``flash_fwd_offs_grid.cu`` (#3) with ``offs``, ``flash_fwd_grid.cu``
    (#6) when ``offs`` is None. Pass 1 over ``ceil(sk / width)`` key
    splits, then, with more than one, the combine pass over a float32
    workspace allocated here on q's device (the caller's stream orders its
    reuse), which writes out in q's dtype."""
    where = "flash_attention%s(variant='grid')" % (
        "" if offs is None else "_with_lse")
    b, h, sq, sk, d = _check_qkv(where, q, k, v, offs)
    _check_width(where, width)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if b * h * sq == 0:
        return out, lse
    suffix = _DTYPES[q.dtype]
    n_split = len(_splits(sk, width))
    if n_split == 1:
        dst_out, dst_lse = out, lse
    else:
        dst_out = torch.empty((n_split,) + tuple(q.shape),
                              dtype=torch.float32, device=q.device)
        dst_lse = torch.empty((n_split, b, h, sq), dtype=torch.float32,
                              device=q.device)
    geo = (b * h, sq, sk, d, width, n_split, float(sm_scale),
           int(bool(causal)))
    if offs is None:
        _launch("mx_flash_fwd_grid_" + suffix, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), dst_out.data_ptr(), dst_lse.data_ptr(), *geo,
                device=q.device)
        _count("launches_fwd_grid", suffix)
    else:
        _launch("mx_flash_fwd_offs_grid_" + suffix, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), offs.data_ptr(),
                dst_out.data_ptr(), dst_lse.data_ptr(), *geo,
                device=q.device)
        _count("launches_fwd_offs_grid", suffix)
    if n_split > 1:
        tail = (dst_out.data_ptr(), dst_lse.data_ptr(), out.data_ptr(),
                lse.data_ptr(), b * h, sq, d, width, n_split,
                int(bool(causal)))
        if offs is None:
            _launch("mx_flash_fwd_grid_combine_" + suffix, *tail,
                    device=q.device)
            _count("launches_fwd_grid_combine", suffix)
        else:
            _launch("mx_flash_fwd_offs_grid_combine_" + suffix,
                    offs.data_ptr(), *tail, device=q.device)
            _count("launches_fwd_offs_grid_combine", suffix)
    return out, lse


def _flash_bwd_grid_cuda(q, k, v, offs, do, deff, lse, sm_scale, causal,
                         splits):
    """dq, dk, dv by ``flash_bwd_grid.cu`` (#4), float32, bf16 or
    float16: dq over key splits of ``splits[1]`` keys, dk/dv over query
    splits of ``splits[0]`` rows, each followed by its reduce pass
    (float32 workspaces; the outputs in q's dtype) when there is more
    than one split. ``deff`` is ``_deff``'s output."""
    where = "flash attention backward (variant='grid')"
    b, h, sq, sk, d = _check_bwd(where, q, k, v, offs, do, deff, lse)
    wq, wk = splits
    _check_width(where, wq)
    _check_width(where, wk)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if b * h * sq == 0 or sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    suffix = _DTYPES[q.dtype]
    nq, nk = len(_splits(sq, wq)), len(_splits(sk, wk))
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), offs.data_ptr(),
              do.data_ptr(), lse.data_ptr(), deff.data_ptr())
    flags = (float(sm_scale), int(bool(causal)))
    dev = q.device

    def workspace(n, like):
        return torch.empty((n,) + tuple(like.shape), dtype=torch.float32,
                           device=dev)

    dq_dst = dq if nk == 1 else workspace(nk, q)
    _launch("mx_flash_bwd_dq_grid_" + suffix, *common, dq_dst.data_ptr(),
            b * h, sq, sk, d, wk, nk, *flags, device=dev)
    _count("launches_bwd_dq_grid", suffix)
    if nk > 1:
        _launch("mx_flash_bwd_dq_grid_reduce_" + suffix, offs.data_ptr(),
                dq_dst.data_ptr(), dq.data_ptr(), b * h, sq, d, wk, nk,
                *flags, device=dev)
        _count("launches_bwd_dq_grid_reduce", suffix)
    dk_dst, dv_dst = (dk, dv) if nq == 1 else (workspace(nq, k),
                                               workspace(nq, v))
    _launch("mx_flash_bwd_dkv_grid_" + suffix, *common, dk_dst.data_ptr(),
            dv_dst.data_ptr(), b * h, sq, sk, d, wq, nq, *flags, device=dev)
    _count("launches_bwd_dkv_grid", suffix)
    if nq > 1:
        _launch("mx_flash_bwd_dkv_grid_reduce_" + suffix, offs.data_ptr(),
                dk_dst.data_ptr(), dv_dst.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), b * h, sq, sk, d, wq, nq, flags[1],
                device=dev)
        _count("launches_bwd_dkv_grid_reduce", suffix)
    return dq, dk, dv


# --- autograd Functions ----------------------------------------------------

def _on_cuda(t, where):
    """True on CUDA, False on the CPU; any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise MXNetError("%s: no kernel for device %s" % (where, t.device))


_zero_offs = {}


def _offs0(device):
    """The cached device ``int32[2]`` of zeros the plain path's backward
    passes as offsets (one per device, never copied per call)."""
    t = _zero_offs.get(device)
    if t is None:
        t = _zero_offs[device] = torch.zeros(2, dtype=torch.int32,
                                             device=device)
    return t


def _flash_bwd(q, k, v, offs, do, dlse, out, lse, sm_scale, causal, splits):
    """dq, dk, dv by the backward of the variant: ``splits`` None is the
    stream pair, ``(wq, wk)`` the split (grid) pair."""
    if _on_cuda(q, "flash attention backward"):
        deff = _deff(do, out, dlse).contiguous()
        # in v's dtype, as the JAX kernels cast it; one copy at most
        do = do.to(v.dtype).contiguous()
        if splits is None:
            return _flash_bwd_cuda(q, k, v, offs, do, deff, lse, sm_scale,
                                   causal)
        return _flash_bwd_grid_cuda(q, k, v, offs, do, deff, lse, sm_scale,
                                    causal, splits)
    if splits is None:
        return flash_bwd_offs_plain(q, k, v, offs, do, dlse, out, lse,
                                    sm_scale, causal)
    return flash_bwd_offs_grid_plain(q, k, v, offs, do, dlse, out, lse,
                                     sm_scale, causal, *splits)


class _FlashWithLse(torch.autograd.Function):
    """(out, lse) at global offsets, the lse cotangent included
    (counterpart of the ``custom_vjp`` ``flash_attention_with_lse``).
    ``splits`` None: forward ``flash_fwd_offs.cu``, backward
    ``flash_bwd_offs.cu``; ``(wq, wk)``: forward ``flash_fwd_offs_grid.cu``
    over key splits of ``wk``, backward ``flash_bwd_grid.cu``."""

    @staticmethod
    def forward(ctx, q, k, v, offs, sm_scale, causal, splits=None):
        if _on_cuda(q, "flash_attention_with_lse"):
            if splits is None:
                out, lse = _flash_fwd_offs_cuda(q, k, v, offs, sm_scale,
                                                causal)
            else:
                out, lse = _flash_fwd_grid_cuda(q, k, v, offs, sm_scale,
                                                causal, splits[1])
        elif splits is None:
            out, lse = flash_fwd_offs_plain(q, k, v, offs, sm_scale, causal)
        else:
            out, lse = flash_fwd_offs_grid_plain(q, k, v, offs, sm_scale,
                                                 causal, splits[1])
        ctx.save_for_backward(q, k, v, offs, out, lse)
        ctx.sm_scale, ctx.causal, ctx.splits = sm_scale, causal, splits
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, offs, out, lse = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        dq, dk, dv = _flash_bwd(q, k, v, offs, dout, dlse, out, lse,
                                ctx.sm_scale, ctx.causal, ctx.splits)
        return dq, dk, dv, None, None, None, None


class _FlashAttention(torch.autograd.Function):
    """Attention without offsets (counterpart of the ``custom_vjp``
    ``_flash_attention_tpu``). ``splits`` None: forward ``flash_fwd.cu``,
    backward ``flash_bwd_offs.cu``; ``(wq, wk)``: forward
    ``flash_fwd_grid.cu`` over key splits of ``wk``, backward
    ``flash_bwd_grid.cu``; the backward at ``offs = [0, 0]`` with no lse
    cotangent."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal, splits=None):
        if _on_cuda(q, "flash_attention"):
            if splits is None:
                out, lse = _flash_fwd_cuda(q, k, v, sm_scale, causal)
            else:
                out, lse = _flash_fwd_grid_cuda(q, k, v, None, sm_scale,
                                                causal, splits[1])
        elif splits is None:
            out, lse = flash_fwd_plain(q, k, v, sm_scale, causal)
        else:
            out, lse = flash_fwd_grid_plain(q, k, v, sm_scale, causal,
                                            splits[1])
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.sm_scale, ctx.causal, ctx.splits = sm_scale, causal, splits
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, _offs0(q.device), dout, None, out,
                                lse, ctx.sm_scale, ctx.causal, ctx.splits)
        return dq, dk, dv, None, None, None


def _splits_of(where, variant, q, k, block_q, block_k):
    """None for ``"stream"``; for ``"grid"`` the split widths ``(wq, wk)``
    of :func:`split_width` from the JAX call's block sizes (None: 512, the
    JAX ``flash_attention`` default). Any other variant raises."""
    if variant == "stream":
        return None
    if variant != "grid":
        raise MXNetError("%s: unknown variant %r" % (where, variant))
    return (split_width(512 if block_q is None else block_q, q.shape[-2]),
            split_width(512 if block_k is None else block_k, k.shape[-2]))


def flash_attention_with_lse(q, k, v, offs, sm_scale=None, causal=True,
                             block_q=None, block_k=None, variant="stream"):
    """Fused (out, lse) attention at dynamic global offsets
    ``offs = int32[2] = [q0, k0]``, differentiable in q, k and v with the
    lse cotangent included (the JAX package's ``custom_vjp``).

    On CUDA tensors: the CUDA kernels of ``variant``, or an error. On CPU
    tensors: their plain versions (:func:`flash_fwd_offs_plain` and
    :func:`flash_bwd_offs_plain`; :func:`flash_fwd_offs_grid_plain` and
    :func:`flash_bwd_offs_grid_plain`). ``variant="stream"`` ignores
    ``block_q``/``block_k`` (the kernels pick their own tiles).
    ``variant="grid"`` splits the key axis of the forward and of dq into
    :func:`split_width` ``(block_k)`` keys and the query axis of dk/dv into
    ``split_width(block_q)`` rows (None: 512 each); where the JAX grid
    launcher raises because the blocks do not divide the sequence, the
    kernels mask the ragged split themselves and compute the same
    function."""
    splits = _splits_of("flash_attention_with_lse", variant, q, k, block_q,
                        block_k)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashWithLse.apply(q, k, v, offs, float(sm_scale), bool(causal),
                               splits)


def flash_attention(q, k, v, *, causal=False, sm_scale=None, block_q=512,
                    block_k=512, use_pallas=None, interpret=False,
                    variant="stream"):
    """Fused attention over [B, H, S, D] tensors (the JAX signature).

    ``use_pallas`` picks the tier through :func:`resolve_kernel_tier`:
    None is ``auto`` (the kernels on CUDA tensors, ``blockwise_attention``
    on CPU tensors), True is ``on`` (the kernels; CPU tensors raise),
    False is ``off`` (``blockwise_attention`` with ``block_k``, on any
    device, differentiated by autograd). The kernel tier is
    :class:`_FlashAttention` of ``variant``: ``"stream"``, forward
    ``csrc/flash_fwd.cu`` and backward ``csrc/flash_bwd_offs.cu``, which
    ignore ``block_q``/``block_k``; ``"grid"``, forward
    ``csrc/flash_fwd_grid.cu`` and backward ``csrc/flash_bwd_grid.cu``,
    whose key splits are :func:`split_width` ``(block_k)`` keys and whose
    dk/dv query splits are ``split_width(block_q)`` rows. Where the JAX
    entry gives way to ``blockwise_attention`` because the block sizes do
    not divide the sequence, the port keeps the kernels of the variant:
    they mask ragged edges themselves and compute the same function.
    ``interpret=True`` raises (no interpret mode for a CUDA kernel), as do
    an unknown variant and a tensor on a device other than the CPU or
    CUDA."""
    if interpret:
        raise MXNetError("flash_attention: interpret=True has no counterpart "
                         "in the port: a CUDA kernel runs only on the card")
    splits = _splits_of("flash_attention", variant, q, k, block_q, block_k)
    _on_cuda(q, "flash_attention")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    mode = "auto" if use_pallas is None else ("on" if use_pallas else "off")
    if resolve_kernel_tier(mode, q.device):
        return _FlashAttention.apply(q, k, v, float(sm_scale), bool(causal),
                                     splits)
    out, _ = blockwise_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                                 block_k=block_k)
    return out
