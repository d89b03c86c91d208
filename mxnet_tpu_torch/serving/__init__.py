"""Serving tier of the port (counterpart of ``mxnet_tpu/serving/``).

- ``InferenceEngine`` (``engine.py``): a Symbol served through bucketed
  programs, on the card one captured CUDA graph per bucket
  (``program_cache.BucketedProgramCache``), with the SLA-aware dynamic
  micro-batcher (``batcher.DynamicBatcher``: EDF batch formation, early
  dispatch, typed ``DeadlineExceeded`` sheds).
- ``ModelServer`` (``server.py``): named models and versions over
  replicas of engines, least-loaded dispatch, circuit breakers, dispatch
  retries, hedging, in-place rollover, and stateful decode replicas.
- ``DecodeEngine`` (``decode.py``): continuous-batching decode over a
  ``PagedKVCache`` (``kvcache.py``).

    from mxnet_tpu_torch.serving import InferenceEngine, ModelServer

The front door, client, fleet pool, worker and autoscaler are not yet
ported (ROADMAP A5).
"""
from .program_cache import BucketedProgramCache, DEFAULT_BUCKETS, bucket_for
from .batcher import (DynamicBatcher, DeadlineExceeded, pad_to_bucket,
                      default_max_batch)
from .engine import InferenceEngine
from .server import ModelServer
from .decode import (DEFAULT_DECODE_BUCKETS, DecodeEngine, DecodeStream,
                     tiny_lm_params)
from .kvcache import NULL_BLOCK, CacheOverflow, PagedKVCache

__all__ = ["InferenceEngine", "ModelServer", "BucketedProgramCache",
           "DynamicBatcher", "DeadlineExceeded", "DEFAULT_BUCKETS",
           "bucket_for", "pad_to_bucket", "default_max_batch",
           "DecodeEngine", "DecodeStream", "tiny_lm_params",
           "DEFAULT_DECODE_BUCKETS", "PagedKVCache", "CacheOverflow",
           "NULL_BLOCK"]
