"""2-bit gradient compression of the port (reference:
``mxnet_tpu/gradient_compression.py``, L1-126).

An error-feedback residual accumulates each gradient; an element whose
running residual reaches +threshold sends code 11 (+threshold, the
residual reduced by it), one at or below -threshold code 10 (-threshold,
the residual increased by it), any other 0 (the residual keeps it). 16
float32 gradients pack into one 32-bit word with the reference's layout
(``_SHIFTS``: element i of a block in byte i >> 2, two bits from bit
6 - 2 (i & 3) of that byte down), so the words are the reference's
``uint32`` values. The reference computes both transforms in jitted JAX,
not in a Pallas kernel, so plain torch ops are their port; the same
operations in the same order give the reference's residuals bit for bit.
torch's ``uint32`` has few ops: the words are summed in ``int64`` and
reinterpreted as ``uint32`` (through ``int32``, which wraps).
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["GradientCompression", "quantize_2bit", "dequantize_2bit"]

_BLOCK = 16  # floats per 32-bit compressed word

# the bit position of element i of a block within its packed word
_SHIFTS = [8 * (i // 4) + (6 - 2 * (i % 4)) for i in range(_BLOCK)]


def _shifts(device):
    return torch.tensor(_SHIFTS, dtype=torch.int64, device=device)


def _threshold(threshold, device):
    return torch.tensor(float(threshold), dtype=torch.float32,
                        device=device)


@torch.no_grad()
def quantize_2bit(grad, residual, threshold):
    """(grad, residual, T) -> (packed uint32[ceil(n / 16)], new residual
    of ``residual``'s shape)."""
    grad = torch.as_tensor(grad)
    residual = torch.as_tensor(residual, device=grad.device)
    t = _threshold(threshold, grad.device)
    zero = torch.zeros((), dtype=torch.float32, device=grad.device)
    flat = grad.reshape(-1).to(torch.float32)
    r = residual.reshape(-1) + flat
    pos = r >= t
    neg = r <= -t
    new_r = r - torch.where(pos, t, zero) + torch.where(neg, t, zero)
    codes = torch.where(pos, 3, torch.where(neg, 2, 0)).to(torch.int64)
    n_pad = (-flat.numel()) % _BLOCK
    codes = torch.nn.functional.pad(codes, (0, n_pad)).reshape(-1, _BLOCK)
    packed = (codes << _shifts(grad.device)).sum(dim=1)
    return (packed.to(torch.int32).view(torch.uint32),
            new_r.reshape(residual.shape))


@torch.no_grad()
def dequantize_2bit(packed, threshold, size):
    """packed uint32 words -> float32[size] of {-T, 0, +T}."""
    packed = torch.as_tensor(packed)
    words = packed.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    codes = (words[:, None] >> _shifts(packed.device)[None, :]) & 3
    t = _threshold(threshold, packed.device)
    zero = torch.zeros((), dtype=torch.float32, device=packed.device)
    vals = torch.where(codes == 3, t, torch.where(codes == 2, -t, zero))
    return vals.reshape(-1)[:int(size)]


class GradientCompression:
    """The compression's parameters and its round trip (reference:
    gradient_compression.cc SetParams / Quantize / Dequantize)."""

    def __init__(self):
        self.type = None
        self.threshold = 0.5

    def set_params(self, compression_params):
        params = dict(compression_params or {})
        ctype = params.pop("type", None)
        threshold = float(params.pop("threshold", 0.5))
        if params:
            raise MXNetError("unknown gradient compression params %r"
                             % list(params))
        if ctype != "2bit":
            raise MXNetError("Unknown type for gradient compression %r"
                             % ctype)
        if threshold <= 0:
            raise MXNetError("threshold must be greater than 0")
        self.type = "2bit"
        self.threshold = threshold

    @property
    def active(self):
        return self.type == "2bit"

    def get_compression_factor(self):
        return 16

    def get_compressed_size(self, original_size):
        return (original_size + _BLOCK - 1) // _BLOCK

    def encode_params(self):
        """reference: EncodeParams (type id 2 is kTwoBit)."""
        return "2,%s" % self.threshold

    def decode_params(self, s):
        elems = s.split(",")
        if int(elems[0]) == 2:
            self.type = "2bit"
            if len(elems) > 1 and elems[1]:
                self.threshold = float(elems[1])
        else:
            self.type = None

    def compress_decompress(self, grad, residual):
        """One lossy round trip, what a gradient goes through on its way
        through compressed communication: (received, new residual)."""
        packed, new_r = quantize_2bit(grad, residual, self.threshold)
        out = dequantize_2bit(packed, self.threshold, grad.numel())
        return out.reshape(grad.shape), new_r
