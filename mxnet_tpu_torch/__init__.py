"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu`` for NVIDIA Hopper.

The JAX package ``mxnet_tpu`` is the reference; this package grows beside
it slice by slice and imports nothing of it (nor JAX). Its first slice
serves transformer decode: ``serving.DecodeEngine`` over a paged KV cache,
driving ``models.transformer.TransformerDecodeModel``, whose prefill
attention runs the hand-written CUDA kernel ``kernels/csrc/flash_fwd_offs.cu``.
Its second slice trains the transformer LM on one card:
``parallel.ShardedTrainStep`` over ``models.transformer.transformer_loss``,
whose attention runs the CUDA forward ``kernels/csrc/flash_fwd.cu`` and the
backward pair ``kernels/csrc/flash_bwd_offs.cu`` behind
``torch.autograd.Function``s.

Entry points run on the card (``cuda:0``) unless the caller passes
``device="cpu"``, and raise ``MXNetError`` when CUDA is missing.
"""
from __future__ import annotations

__version__ = "1.2.0+cuda"

from . import parallel, profiler
from .base import MXNetError
from .context import cpu, gpu, default_device
from .parallel import ShardedTrainStep

__all__ = ["MXNetError", "cpu", "gpu", "default_device", "profiler",
           "parallel", "ShardedTrainStep", "__version__"]
