"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu`` for NVIDIA Hopper.

The JAX package ``mxnet_tpu`` is the reference; this package grows beside
it slice by slice and imports nothing of it (nor JAX). Its first slice
serves transformer decode: ``serving.DecodeEngine`` over a paged KV cache,
driving ``models.transformer.TransformerDecodeModel``, whose prefill
attention runs the hand-written CUDA kernel ``kernels/csrc/flash_fwd_offs.cu``.

Entry points run on the card (``cuda:0``) unless the caller passes
``device="cpu"``, and raise ``MXNetError`` when CUDA is missing.
"""
from __future__ import annotations

__version__ = "1.2.0+cuda"

from . import profiler
from .base import MXNetError
from .context import cpu, gpu, default_device

__all__ = ["MXNetError", "cpu", "gpu", "default_device", "profiler",
           "__version__"]
