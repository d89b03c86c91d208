"""Flash attention of the port: plain PyTorch versions, the kernel tier
resolver, and the wrapper of the hand-written CUDA forward kernel.

Counterpart of ``mxnet_tpu/kernels/flash_attention.py``. Shapes follow
``[batch, heads, seq, head_dim]`` throughout, as there.

- ``attention_with_lse`` / ``merge_attention`` / ``blockwise_attention``
  are the plain versions, with the same ``q_offset``/``k_offset``
  semantics: a query row at global position ``q_offset + i`` sees a key at
  ``k_offset + j`` iff ``q_offset + i >= k_offset + j``; fully masked rows
  get out 0 and lse pinned to -1e30.
- ``flash_attention_with_lse`` is the forward of the offset-aware kernel
  (the TPU kernel ``_flash_fwd_offs_kernel``): on a CUDA tensor it
  launches ``csrc/flash_fwd_offs.cu`` or raises; on a CPU tensor it runs
  ``flash_fwd_offs_plain``. There is no fallback from the card to the
  plain version.
- ``resolve_kernel_tier`` keeps the JAX package's tier vocabulary
  (``MXNET_SERVING_DECODE_FLASH``): auto | 1/on | 0/off, where ``interpret``
  has no counterpart (a CUDA kernel has no interpret mode) and raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError

__all__ = ["attention_with_lse", "merge_attention", "blockwise_attention",
           "flash_fwd_offs_plain", "flash_attention_with_lse",
           "resolve_kernel_tier", "kernel_status"]

_NEG_INF = -1e30

#: Launches of the CUDA kernel by :func:`flash_attention_with_lse`
#: (plain-version calls are not counted). Callers may reset it to 0.
launches = 0

_HEAD_DIMS = (32, 64, 128)


def _fold_scale(q, sm_scale):
    """q * sm_scale rounded back to q's dtype, once per call — the kernel
    folds identically, and the later backward kernel recomputes scores
    from the same rounded q."""
    return (q.float() * sm_scale).to(q.dtype)


def _causal_mask(q_len, k_len, q_offset, k_offset, dtype, device):
    """Additive causal mask for a q block at global offset vs a k block.
    Offsets may be Python ints or 0-d tensors on ``device``."""
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    k_pos = k_offset + torch.arange(k_len, device=device)[None, :]
    return torch.where(q_pos >= k_pos, 0.0, _NEG_INF).to(dtype)


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
    lse = torch.where(live, lse, _NEG_INF)
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
    (online softmax); peak memory O(Sq * block_k)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    sk = k.shape[-2]
    block_k = min(block_k, sk)
    if sk % block_k != 0:   # one block if it does not divide
        block_k = sk
    out = torch.zeros(q.shape[:-1] + (v.shape[-1],), dtype=q.dtype,
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
    return out, lse


def flash_fwd_offs_plain(q, k, v, offs, sm_scale=None, causal=True):
    """Plain version of the offset-aware flash forward: the same folded
    scale and masking as the kernel, as one full softmax. ``offs`` is an
    int tensor ``[q0, k0]`` of global offsets on q's device."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return attention_with_lse(_fold_scale(q, sm_scale), k, v, causal=causal,
                              sm_scale=1.0, q_offset=offs[0],
                              k_offset=offs[1])


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


_kernel = None


def _kernel_fn():
    """The C entry of ``csrc/flash_fwd_offs.cu``, built on first use."""
    global _kernel
    if _kernel is None:
        from . import _build
        fn = _build.load("flash_fwd_offs").mx_flash_fwd_offs_f32
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        _kernel = fn
    return _kernel


def _check(name, t, device, dtype, ndim):
    if t.device != device:
        raise MXNetError("flash_attention_with_lse: %s on %s, q on %s"
                         % (name, t.device, device))
    if t.dtype != dtype:
        raise MXNetError("flash_attention_with_lse: %s is %s, the kernel "
                         "takes %s" % (name, t.dtype, dtype))
    if t.dim() != ndim:
        raise MXNetError("flash_attention_with_lse: %s has %d dims, want %d"
                         % (name, t.dim(), ndim))
    if not t.is_contiguous():
        raise MXNetError("flash_attention_with_lse: %s is not contiguous"
                         % name)


def _flash_fwd_offs_cuda(q, k, v, offs, sm_scale, causal):
    global launches
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, dev, torch.float32, 4)
    _check("offs", offs, dev, torch.int32, 1)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if tuple(k.shape) != (b, h, sk, d) or tuple(v.shape) != (b, h, sk, d):
        raise MXNetError("flash_attention_with_lse: k %s / v %s do not match "
                         "q %s" % (tuple(k.shape), tuple(v.shape),
                                   tuple(q.shape)))
    if d not in _HEAD_DIMS:
        raise MXNetError("flash_attention_with_lse: head dim %d not in %s"
                         % (d, _HEAD_DIMS))
    if offs.numel() != 2:
        raise MXNetError("flash_attention_with_lse: offs must be int32[2]")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    if b * h * sq == 0:
        return out, lse
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), offs.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), b * h, sq, sk, d,
                 float(sm_scale), int(bool(causal)), stream)
    if err != 0:
        raise MXNetError("flash_fwd_offs kernel launch failed: CUDA error %d"
                         % err)
    launches += 1
    return out, lse


def flash_attention_with_lse(q, k, v, offs, sm_scale=None, causal=True,
                             block_q=None, block_k=None, variant="stream"):
    """Fused (out, lse) attention at dynamic global offsets
    ``offs = int32[2] = [q0, k0]``, forward only.

    On CUDA tensors: the CUDA kernel, or an error. On CPU tensors:
    :func:`flash_fwd_offs_plain`. ``block_q``/``block_k`` are accepted for
    signature parity with the JAX package; the kernel picks its own tiles
    and masks ragged edges itself. ``variant="grid"`` is not yet ported."""
    if variant == "grid":
        raise MXNetError("flash_attention_with_lse: variant 'grid' is not "
                         "yet ported")
    if variant != "stream":
        raise MXNetError("flash_attention_with_lse: unknown variant %r"
                         % (variant,))
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_fwd_offs_plain(q, k, v, offs, sm_scale, causal)
    if q.device.type != "cuda":
        raise MXNetError("flash_attention_with_lse: no kernel for device %s"
                         % q.device)
    return _flash_fwd_offs_cuda(q, k, v, offs, sm_scale, causal)
