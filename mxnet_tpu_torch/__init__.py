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
``torch.autograd.Function``s. Its third slice trains symbolic graphs on
one card: ``mx.sym`` builds a graph (``models.resnet.get_symbol``),
``Executor``/``simple_bind`` run it, and ``parallel.DataParallelTrainStep``
trains it, the optimizer update through the CUDA kernel
``kernels/csrc/opt_update.cu``; ``mx.nd`` reads and writes the reference's
``.params`` files. Its fifth slice brings back MXNet's runtime kernels:
``rtc.CudaModule`` compiles CUDA C with NVRTC for the card, and
``rtc.register_cuda_op`` makes a kernel an op that ``mx.sym`` graphs,
``load_json`` and ``Executor`` run like any built-in (a Triton analog
beside it).

Entry points run on the card (``cuda:0``) unless the caller passes
``device="cpu"``, and raise ``MXNetError`` when CUDA is missing.
"""
from __future__ import annotations

__version__ = "1.2.0+cuda"

from . import models, name, ndarray, parallel, profiler, rtc, symbol
from .base import MXNetError
from .context import cpu, gpu, default_device
from .executor import Executor
from .parallel import DataParallelTrainStep, ShardedTrainStep

sym = symbol
nd = ndarray

__all__ = ["MXNetError", "cpu", "gpu", "default_device", "profiler",
           "parallel", "ShardedTrainStep", "DataParallelTrainStep",
           "Executor", "models", "name", "nd", "ndarray", "rtc", "sym",
           "symbol",
           "__version__"]
