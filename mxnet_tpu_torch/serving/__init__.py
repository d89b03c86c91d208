"""Serving tier of the port (counterpart of ``mxnet_tpu/serving/``).

- ``InferenceEngine`` (``engine.py``): a Symbol served through bucketed
  programs, on the card one captured CUDA graph per bucket
  (``program_cache.BucketedProgramCache``), with the SLA-aware dynamic
  micro-batcher (``batcher.DynamicBatcher``: EDF batch formation, early
  dispatch, typed ``DeadlineExceeded`` sheds).
- ``ModelServer`` (``server.py``): named models and versions over
  replicas of engines, least-loaded dispatch, circuit breakers, dispatch
  retries, hedging, in-place rollover, stateful decode replicas, the
  fleet's attach points (``add_replicas`` / ``remove_replicas``) and the
  autoscaling signal ``health()``.
- ``DecodeEngine`` (``decode.py``): continuous-batching decode over a
  ``PagedKVCache`` (``kvcache.py``).
- The network tier, on the reference's wire: length-prefixed frames with
  HMAC sealing and protocol negotiation (``wire.py``), the safe
  non-executable codec (``codec.py``, fuzzed by ``wire_fuzz.py``),
  ``ServingFrontDoor`` (``frontdoor.py``: a TCP gateway over a
  ModelServer, with resolve-by-id and resumable decode streams),
  ``ServingClient`` / ``ClientStream`` (``client.py``), the fleet
  (``pool.py``: ``FleetPool`` and ``RemoteReplica``; ``worker.py``:
  ``ReplicaWorker`` and its ``python -m mxnet_tpu_torch.serving.worker``
  CLI) and ``Autoscaler`` / ``LocalProcessLauncher`` (``autoscaler.py``).

    from mxnet_tpu_torch.serving import InferenceEngine, ModelServer
"""
from .program_cache import BucketedProgramCache, DEFAULT_BUCKETS, bucket_for
from .batcher import (DynamicBatcher, DeadlineExceeded, pad_to_bucket,
                      default_max_batch)
from .engine import InferenceEngine
from .server import ModelServer
from .frontdoor import ServingFrontDoor
from .client import ServingClient, ClientStream
from .pool import FleetPool, RemoteReplica
from .worker import ReplicaWorker
from .autoscaler import Autoscaler, LocalProcessLauncher
from .decode import (DEFAULT_DECODE_BUCKETS, DecodeEngine, DecodeStream,
                     tiny_lm_params)
from .kvcache import NULL_BLOCK, CacheOverflow, PagedKVCache

__all__ = ["InferenceEngine", "ModelServer", "ServingFrontDoor",
           "ServingClient", "ClientStream", "FleetPool", "RemoteReplica",
           "ReplicaWorker", "Autoscaler", "LocalProcessLauncher",
           "BucketedProgramCache",
           "DynamicBatcher", "DeadlineExceeded", "DEFAULT_BUCKETS",
           "bucket_for", "pad_to_bucket", "default_max_batch",
           "DecodeEngine", "DecodeStream", "tiny_lm_params",
           "DEFAULT_DECODE_BUCKETS", "PagedKVCache", "CacheOverflow",
           "NULL_BLOCK"]
