"""Contrib ops of the port: CTC loss, FFT/IFFT and quadratic.

Counterpart of ``mxnet_tpu/ops/contrib_ops.py`` (reference
src/operator/contrib/ctc_loss.cc, fft, ifft and quadratic_op.cc):

- ``CTCLoss`` (aliases ``ctc_loss``, ``_contrib_CTCLoss``,
  ``_contrib_ctc_loss``) is the alpha recursion in log space over the
  log-softmax of the activations, batched over the sequences; its
  gradient is autograd's through the recursion, as the reference's is
  jax's through its scan. An alignment that cannot exist gives the
  reference's ~1e30 (its ``-1e30`` sentinel), never ``inf``, so the
  recursion runs on every device: torch's ``ctc_loss`` returns ``inf``
  there and its gradient is not the reference's.
- ``_contrib_fft`` interleaves re and im on the last axis;
  ``_contrib_ifft`` is unnormalised (x d, the cuFFT convention the
  reference keeps).
"""
from __future__ import annotations

import torch

from ..base import Params, param_field
from .registry import register_op

_NEG = -1e30


def _finite(x):
    return torch.where(torch.isinf(x), torch.zeros_like(x), x)


class _LogAddExp(torch.autograd.Function):
    """``log(exp(a) + exp(b))`` with jax's formula and jax's derivative,
    ``exp(a - out)`` and ``exp(b - out)``. Where both are the ``-1e30``
    sentinel, ``out`` rounds to ``a``, so each side gets weight 1 (torch's
    ``logaddexp`` gives 1/2): the infeasible sequences' gradient is then
    the reference's."""

    @staticmethod
    def forward(ctx, a, b):
        delta = a - b
        out = torch.where(torch.isnan(delta), a + b, torch.maximum(a, b)
                          + torch.log1p(torch.exp(-delta.abs())))
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        o = _finite(out)
        return g * torch.exp(_finite(a) - o), g * torch.exp(_finite(b) - o)


_logaddexp = _LogAddExp.apply


def ctc_nll(logp, labels, in_lens, lab_lens, blank):
    """The negative log-likelihood of each sequence: ``logp`` (T, B, A)
    log-softmaxed, ``labels`` (B, L) padded, ``in_lens`` / ``lab_lens`` (B,)
    int64. Transcribes the reference's ``_ctc_single`` (L23-62) for the
    whole batch at once."""
    T, B, _ = logp.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = logp.device
    ext = torch.full((B, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels
    pos = torch.arange(S, device=dev)
    is_lab = (pos % 2) == 1
    prev2 = torch.roll(ext, 2, dims=1)
    can_skip = is_lab[None, :] & (ext != prev2)
    valid_s = pos[None, :] < (2 * lab_lens[:, None] + 1)
    neg = torch.full((), _NEG, dtype=logp.dtype, device=dev)
    # lp[t, b, s] = logp[t, b, ext[b, s]]: a negative label counts from
    # the end and one out of range is clamped, as jax indexes
    A = logp.shape[2]
    idx = torch.where(ext < 0, ext + A, ext).clamp(0, A - 1)
    lp = logp.gather(2, idx[None].expand(T, B, S))
    alpha = torch.full((B, S), _NEG, dtype=logp.dtype, device=dev)
    alpha = torch.cat([lp[0, :, :1], torch.where(
        lab_lens[:, None] > 0, lp[0, :, 1:2], neg), alpha[:, 2:]], dim=1)
    pad1 = neg.expand(B, 1)
    pad2 = neg.expand(B, 2)
    for t in range(1, T):
        shift1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        shift2 = torch.where(can_skip, torch.cat([pad2, alpha[:, :-2]],
                                                 dim=1), neg)
        merged = _logaddexp(_logaddexp(alpha, shift1), shift2)
        new = torch.where(valid_s, merged + lp[t], neg)
        # frozen past the sequence's length
        alpha = torch.where((t < in_lens)[:, None], new, alpha)
    end1 = alpha.gather(1, (2 * lab_lens - 1).clamp(0, S - 1)[:, None])[:, 0]
    end2 = alpha.gather(1, (2 * lab_lens).clamp(0, S - 1)[:, None])[:, 0]
    ll = _logaddexp(torch.where(lab_lens > 0, end1, neg), end2)
    return -ll


class CTCLossParam(Params):
    use_data_lengths = param_field(bool, default=False)
    use_label_lengths = param_field(bool, default=False)
    blank_label = param_field(str, default="first")


def _ctc_inputs(p):
    names = ["data", "label"]
    if p is not None and p.use_data_lengths:
        names.append("data_lengths")
    if p is not None and p.use_label_lengths:
        names.append("label_lengths")
    return tuple(names)


@register_op("CTCLoss", aliases=("ctc_loss", "_contrib_CTCLoss",
                                 "_contrib_ctc_loss"),
             param_cls=CTCLossParam, input_names=_ctc_inputs)
def _ctc_loss(params, data, label, data_lengths=None, label_lengths=None):
    """data (T, B, A) activations before the softmax, label (B, L) padded;
    one loss a sequence in ``data``'s dtype. ``blank_label='first'``:
    blank 0, padding 0; ``'last'``: blank A-1, padding below 0."""
    T, B, A = data.shape
    if data.device.type == "meta":
        return torch.empty((B,), dtype=data.dtype, device="meta")
    logp = torch.log_softmax(data.float(), dim=-1)
    labels = label.to(torch.int64)
    if params.blank_label == "first":
        blank = 0
        default_len = (label != 0).sum(dim=1)
    else:
        blank = A - 1
        default_len = (label >= 0).sum(dim=1)
    in_lens = (data_lengths.to(torch.int64) if data_lengths is not None
               else torch.full((B,), T, dtype=torch.int64,
                               device=data.device))
    lab_lens = (label_lengths.to(torch.int64) if label_lengths is not None
                else default_len.to(torch.int64))
    return ctc_nll(logp, labels, in_lens, lab_lens, blank).to(data.dtype)


class FFTParam(Params):
    compute_size = param_field(int, default=128)


@register_op("_contrib_fft", param_cls=FFTParam)
def _fft(params, data):
    """(..., d) real -> (..., 2d) interleaved (re, im)."""
    out = torch.fft.fft(data.float(), dim=-1)
    return torch.view_as_real(out).reshape(
        data.shape[:-1] + (2 * data.shape[-1],)).float()


@register_op("_contrib_ifft", param_cls=FFTParam)
def _ifft(params, data):
    """(..., 2d) interleaved -> (..., d), the real part of the inverse FFT,
    not divided by d."""
    d = data.shape[-1] // 2
    c = torch.view_as_complex(
        data.float().reshape(data.shape[:-1] + (d, 2)).contiguous())
    return (torch.fft.ifft(c, dim=-1) * d).real.float()


class QuadraticParam(Params):
    a = param_field(float, default=0.0)
    b = param_field(float, default=0.0)
    c = param_field(float, default=0.0)


@register_op("_contrib_quadratic", param_cls=QuadraticParam)
def _quadratic(params, data):
    return params.a * data * data + params.b * data + params.c
