"""Flash attention of the port: plain PyTorch versions, the kernel tier
resolver, and the autograd Functions over the hand-written CUDA kernels.

Counterpart of ``mxnet_tpu/kernels/flash_attention.py``. Shapes follow
``[batch, heads, seq, head_dim]`` throughout, as there.

- ``attention_with_lse`` / ``merge_attention`` / ``blockwise_attention``
  are the plain versions, with the same ``q_offset``/``k_offset``
  semantics: a query row at global position ``q_offset + i`` sees a key at
  ``k_offset + j`` iff ``q_offset + i >= k_offset + j``; fully masked rows
  get out 0 and lse pinned to -1e30.
- Three CUDA kernel libraries, each with its plain version here:
  ``csrc/flash_fwd_offs.cu`` (TPU kernel ``_flash_fwd_offs_kernel``;
  plain ``flash_fwd_offs_plain``), ``csrc/flash_fwd.cu``
  (``_flash_fwd_kernel``; ``flash_fwd_plain``) and ``csrc/flash_bwd_offs.cu``
  (the pair ``_flash_bwd_dq_offs_kernel``/``_flash_bwd_dkv_offs_kernel``;
  ``flash_bwd_offs_plain``).
- ``_FlashWithLse`` (behind ``flash_attention_with_lse``) and
  ``_FlashAttention`` (behind ``flash_attention``) are the
  ``torch.autograd.Function`` counterparts of the JAX package's two
  ``custom_vjp``s: forward by the offset or the plain forward kernel,
  backward by the backward pair (with the real lse cotangent, or at
  ``offs = [0, 0]`` with none). On CUDA tensors they launch the kernels or
  raise; on CPU tensors they run the plain versions; any other device
  raises. There is no fallback from the card to the plain version.
- ``resolve_kernel_tier`` keeps the JAX package's tier vocabulary
  (``MXNET_SERVING_DECODE_FLASH``, ``MXNET_TPU_MESH_KERNEL_TIER``): auto |
  1/on | 0/off, where ``interpret`` has no counterpart (a CUDA kernel has
  no interpret mode) and raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError

__all__ = ["attention_with_lse", "merge_attention", "blockwise_attention",
           "flash_fwd_offs_plain", "flash_fwd_plain", "flash_bwd_offs_plain",
           "flash_attention_with_lse", "flash_attention",
           "resolve_kernel_tier", "kernel_status"]

_NEG_INF = -1e30

#: Launches of each CUDA kernel (plain-version calls are not counted);
#: callers may reset them to 0. ``launches``: the offset forward
#: (``flash_fwd_offs.cu``); ``launches_fwd``: the plain forward
#: (``flash_fwd.cu``); ``launches_bwd_dq`` / ``launches_bwd_dkv``: the
#: backward pair (``flash_bwd_offs.cu``).
launches = 0
launches_fwd = 0
launches_bwd_dq = 0
launches_bwd_dkv = 0

_HEAD_DIMS = (32, 64, 128)


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


def flash_fwd_plain(q, k, v, sm_scale=None, causal=False):
    """Plain version of the flash forward without offsets (the TPU kernel
    ``_flash_fwd_kernel``): ``(out, lse)`` with the kernel's folded scale.
    Without offsets no causal row is fully masked."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return attention_with_lse(_fold_scale(q, sm_scale), k, v, causal=causal,
                              sm_scale=1.0)


def _deff(do, out, dlse):
    """delta_eff = rowsum(do * out) - dlse in float32 (``_bwd_staging``):
    the lse cotangent folds into the per-row scalar of the backward. A
    ``None`` dlse counts as zeros."""
    delta = (do.float() * out.float()).sum(-1)
    return delta if dlse is None else delta - dlse.float()


def flash_bwd_offs_plain(q, k, v, offs, do, dlse, out, lse, sm_scale=None,
                         causal=True):
    """Plain version of the backward pair at global offsets ``offs =
    [q0, k0]``: ``(dq, dk, dv)`` written out from the kernels' formulas,
    not by autograd. Scores come from the folded q, as in the forward;
    ``dk`` accumulates against the folded q (no further ``sm_scale``)
    and ``dq`` takes ``sm_scale`` once. Rows with lse pinned to -1e30 (no
    visible key) use a +1e30 substitute, so ``exp`` gives exactly 0
    there."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    qs = _fold_scale(q, sm_scale)
    s = torch.einsum("...qd,...kd->...qk", qs, k).float()
    if causal:
        s = torch.where(_visible(q.shape[-2], k.shape[-2], offs[0], offs[1],
                                 q.device), s, _NEG_INF)
    lse = lse.float()
    lse_safe = torch.where(lse > _NEG_INF / 2, lse, -_NEG_INF)
    p = torch.exp(s - lse_safe[..., None])
    dp = torch.einsum("...qd,...kd->...qk", do, v).float()
    ds = p * (dp - _deff(do, out, dlse)[..., None])
    dq = torch.einsum("...qk,...kd->...qd", ds, k.float()) * sm_scale
    dk = torch.einsum("...qk,...qd->...kd", ds, qs.float())
    dv = torch.einsum("...qk,...qd->...kd", p, do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
}
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


def _check(where, name, t, device, dtype, ndim):
    if t.device != device:
        raise MXNetError("%s: %s on %s, q on %s" % (where, name, t.device,
                                                    device))
    if t.dtype in (torch.float16, torch.bfloat16):
        raise MXNetError("%s: %s is %s: half-precision kernels are not yet "
                         "ported (float32 only)" % (where, name, t.dtype))
    if t.dtype != dtype:
        raise MXNetError("%s: %s is %s, the kernel takes %s"
                         % (where, name, t.dtype, dtype))
    if t.dim() != ndim:
        raise MXNetError("%s: %s has %d dims, want %d" % (where, name,
                                                          t.dim(), ndim))
    if not t.is_contiguous():
        raise MXNetError("%s: %s is not contiguous" % (where, name))


def _check_qkv(where, q, k, v, offs=None):
    """Shapes (b, h, sq, d) / (b, h, sk, d), float32, contiguous, one
    device; d in the kernels' set. -> (b, h, sq, sk, d)."""
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(where, name, t, dev, torch.float32, 4)
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


def _flash_fwd_offs_cuda(q, k, v, offs, sm_scale, causal):
    global launches
    b, h, sq, sk, d = _check_qkv("flash_attention_with_lse", q, k, v, offs)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if b * h * sq == 0:
        return out, lse
    _launch("mx_flash_fwd_offs_f32", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), offs.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b * h, sq, sk, d, float(sm_scale), int(bool(causal)),
            device=q.device)
    launches += 1
    return out, lse


def _flash_fwd_cuda(q, k, v, sm_scale, causal):
    global launches_fwd
    b, h, sq, sk, d = _check_qkv("flash_attention", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if b * h * sq == 0:
        return out, lse
    _launch("mx_flash_fwd_f32", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b * h, sq, sk, d,
            float(sm_scale), int(bool(causal)), device=q.device)
    launches_fwd += 1
    return out, lse


def _flash_bwd_cuda(q, k, v, offs, do, deff, lse, sm_scale, causal):
    """dq, dk, dv by the backward pair. ``deff`` is ``_deff``'s output."""
    global launches_bwd_dq, launches_bwd_dkv
    where = "flash attention backward"
    b, h, sq, sk, d = _check_qkv(where, q, k, v, offs)
    _check(where, "do", do, q.device, torch.float32, 4)
    for name, t in (("lse", lse), ("deff", deff)):
        _check(where, name, t, q.device, torch.float32, 3)
        if tuple(t.shape) != (b, h, sq):
            raise MXNetError("%s: %s %s, want %s" % (where, name,
                                                     tuple(t.shape),
                                                     (b, h, sq)))
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if b * h * sq == 0 or sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), offs.data_ptr(),
              do.data_ptr(), lse.data_ptr(), deff.data_ptr())
    tail = (b * h, sq, sk, d, float(sm_scale), int(bool(causal)))
    _launch("mx_flash_bwd_dq_f32", *common, dq.data_ptr(), *tail,
            device=q.device)
    launches_bwd_dq += 1
    _launch("mx_flash_bwd_dkv_f32", *common, dk.data_ptr(), dv.data_ptr(),
            *tail, device=q.device)
    launches_bwd_dkv += 1
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


def _flash_bwd(q, k, v, offs, do, dlse, out, lse, sm_scale, causal):
    if _on_cuda(q, "flash attention backward"):
        do = do.contiguous()   # one copy at most, shared by deff and kernels
        deff = _deff(do, out, dlse).contiguous()
        return _flash_bwd_cuda(q, k, v, offs, do, deff, lse, sm_scale,
                               causal)
    return flash_bwd_offs_plain(q, k, v, offs, do, dlse, out, lse, sm_scale,
                                causal)


class _FlashWithLse(torch.autograd.Function):
    """(out, lse) at global offsets: forward ``flash_fwd_offs.cu``,
    backward ``flash_bwd_offs.cu`` with the lse cotangent (counterpart of
    the ``custom_vjp`` ``flash_attention_with_lse``)."""

    @staticmethod
    def forward(ctx, q, k, v, offs, sm_scale, causal):
        if _on_cuda(q, "flash_attention_with_lse"):
            out, lse = _flash_fwd_offs_cuda(q, k, v, offs, sm_scale, causal)
        else:
            out, lse = flash_fwd_offs_plain(q, k, v, offs, sm_scale, causal)
        ctx.save_for_backward(q, k, v, offs, out, lse)
        ctx.sm_scale, ctx.causal = sm_scale, causal
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, offs, out, lse = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        dq, dk, dv = _flash_bwd(q, k, v, offs, dout, dlse, out, lse,
                                ctx.sm_scale, ctx.causal)
        return dq, dk, dv, None, None, None


class _FlashAttention(torch.autograd.Function):
    """Attention without offsets: forward ``flash_fwd.cu``, backward
    ``flash_bwd_offs.cu`` at ``offs = [0, 0]`` with no lse cotangent
    (counterpart of the ``custom_vjp`` ``_flash_attention_tpu``)."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal):
        if _on_cuda(q, "flash_attention"):
            out, lse = _flash_fwd_cuda(q, k, v, sm_scale, causal)
        else:
            out, lse = flash_fwd_plain(q, k, v, sm_scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.sm_scale, ctx.causal = sm_scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, _offs0(q.device), dout, None, out,
                                lse, ctx.sm_scale, ctx.causal)
        return dq, dk, dv, None, None


def _check_variant(where, variant):
    if variant == "grid":
        raise MXNetError("%s: variant 'grid' is not yet ported" % where)
    if variant != "stream":
        raise MXNetError("%s: unknown variant %r" % (where, variant))


def flash_attention_with_lse(q, k, v, offs, sm_scale=None, causal=True,
                             block_q=None, block_k=None, variant="stream"):
    """Fused (out, lse) attention at dynamic global offsets
    ``offs = int32[2] = [q0, k0]``, differentiable in q, k and v with the
    lse cotangent included (the JAX package's ``custom_vjp``).

    On CUDA tensors: the CUDA kernels, or an error. On CPU tensors: the
    plain versions :func:`flash_fwd_offs_plain` and
    :func:`flash_bwd_offs_plain`. ``block_q``/``block_k`` are accepted for
    signature parity with the JAX package; the kernels pick their own
    tiles and mask ragged edges themselves. ``variant="grid"`` is not yet
    ported."""
    _check_variant("flash_attention_with_lse", variant)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashWithLse.apply(q, k, v, offs, float(sm_scale), bool(causal))


def flash_attention(q, k, v, *, causal=False, sm_scale=None, block_q=512,
                    block_k=512, use_pallas=None, interpret=False,
                    variant="stream"):
    """Fused attention over [B, H, S, D] tensors (the JAX signature).

    ``use_pallas`` picks the tier through :func:`resolve_kernel_tier`:
    None is ``auto`` (the kernels on CUDA tensors, ``blockwise_attention``
    on CPU tensors), True is ``on`` (the kernels; CPU tensors raise),
    False is ``off`` (``blockwise_attention`` with ``block_k``, on any
    device, differentiated by autograd). The kernel tier is
    :class:`_FlashAttention`: forward ``csrc/flash_fwd.cu``, backward
    ``csrc/flash_bwd_offs.cu``. Where the JAX entry gives way to
    ``blockwise_attention`` because the block sizes do not divide the
    sequence, the port keeps the kernels: they mask ragged edges
    themselves and compute the same function (``block_q``/``block_k`` do
    not set their tiles). ``interpret=True`` raises (no interpret mode
    for a CUDA kernel), as does ``variant="grid"`` (not yet ported) and a
    tensor on a device other than the CPU or CUDA."""
    if interpret:
        raise MXNetError("flash_attention: interpret=True has no counterpart "
                         "in the port: a CUDA kernel runs only on the card")
    _check_variant("flash_attention", variant)
    _on_cuda(q, "flash_attention")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    mode = "auto" if use_pallas is None else ("on" if use_pallas else "off")
    if resolve_kernel_tier(mode, q.device):
        return _FlashAttention.apply(q, k, v, float(sm_scale), bool(causal))
    out, _ = blockwise_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                                 block_k=block_k)
    return out
