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
beside it). Its ninth slice trains the way an MXNet user does:
``mx.mod.Module(sym, context=mx.gpu(0)).fit(...)`` over ``mx.io``
iterators, with ``mx.optimizer``, ``mx.metric``, ``mx.init``,
``mx.kvstore``, ``mx.callback`` and the ``mx.model`` checkpoints;
``fit(kvstore='tpu_sync')`` hands each batch to
``DataParallelTrainStep``, and ``python -m mxnet_tpu_torch.run_script``
runs the reference's example scripts unchanged against this package.
Its fourteenth slice supervises and prefetches that fit:
``fit(supervisor=resilience.TrainingSupervisor(...))`` skips a
non-finite step from the step's device verdict (kernel #7 writes nothing
when it is false) under dynamic loss scaling, and
``io.DevicePrefetchIter`` stages the next batch on the card while a step
runs.
Its fifteenth slice serves symbolic graphs: ``serving.InferenceEngine``
captures one CUDA graph per batch bucket and replays it under a dynamic
micro-batcher, ``serving.ModelServer`` routes named models and versions
over replicas (with decode replicas beside them), and
``Executor.warmup``/``program_cost``, ``monitor.Monitor`` and
``Module.predict`` through the engine complete the executor.
Its seventeenth slice is the imperative runtime: one ``mx.nd.<op>``
function per registered op (the reference's elementwise, tensor, nn,
random and optimizer families), ``mx.autograd`` on torch's autograd
graph, Python ``mx.operator.CustomOp``s, and stochastic graphs (Dropout
and the sampling ops draw from a ``torch.Generator``; a train step seeds
one from numpy's global RNG each step).
Its eighteenth slice trains sequence models: the ``RNN`` op (cuDNN on the
card, over the reference's packed parameters), ``mx.rnn`` (the symbolic
cells, ``BucketSentenceIter`` and the RNN checkpoints),
``mx.mod.BucketingModule``, ``CTCLoss``, the remaining metrics
(``Perplexity``, ...), ``mx.AttrScope`` and ``mx.name.Prefix``.
Its twentieth slice makes training resumable: every optimizer of the
reference, ``mx.checkpoint.CheckpointManager`` (asynchronous, atomic
saves from device clones; ``fit(checkpoint_manager=...)`` resumes bit for
bit, also under a supervisor; a preemption signal flushes a final
checkpoint; ``InferenceEngine.reload_from`` follows a run), the record
files (``mx.recordio``), ``FeedForward`` and the remaining iterators,
initializers and schedulers.
Its twenty-first slice trains over process groups and several contexts:
``parallel.collectives`` joins the launcher's process group
(``tools/launch.py -n 2 -- python ...``; gloo) at import,
``mx.kv.create('dist_sync')`` sums each pushed gradient over the workers,
``mx.mod.Module(context=[mx.gpu(0), mx.gpu(0)])`` splits each batch over
its contexts (the fused step over the whole batch under ``device`` or
``tpu_sync``), and ``compression_params={'type': '2bit'}`` compresses the
pushes (``gradient_compression``).

Entry points run on the card (``cuda:0``) unless the caller passes
``device="cpu"``, and raise ``MXNetError`` when CUDA is missing.
"""
from __future__ import annotations

__version__ = "1.2.0+cuda"

from . import models, name, ndarray, parallel, profiler, rtc, symbol
from . import (attribute, autograd, callback, checkpoint, engine,
               imperative, initializer, io, kvstore, lr_scheduler, metric,
               model, module, monitor, operator, optimizer, random, recordio,
               resilience, rnn, serving)
from . import gradient_compression
from . import kvstore as kv
from .attribute import AttrScope
from .base import MXNetError
from .context import cpu, gpu, tpu, default_device
from .executor import Executor
from .parallel import DataParallelTrainStep, ShardedTrainStep

# join the launcher's process group at import, as the reference does (a
# no-op without the launcher's environment)
parallel.collectives.ensure_distributed()

sym = symbol
nd = ndarray
mod = module
init = initializer

__all__ = ["MXNetError", "cpu", "gpu", "tpu", "default_device", "profiler",
           "autograd", "operator", "imperative",
           "parallel", "ShardedTrainStep", "DataParallelTrainStep",
           "Executor", "models", "name", "nd", "ndarray", "rtc", "sym",
           "symbol", "mod", "module", "io", "metric", "init", "initializer",
           "optimizer", "lr_scheduler", "kvstore", "model", "callback",
           "random", "resilience", "engine", "monitor", "serving", "rnn",
           "attribute", "AttrScope", "checkpoint", "recordio", "kv",
           "gradient_compression", "__version__"]
