"""Serving tier of the port: stateful decode over a paged KV cache."""
from .batcher import DeadlineExceeded
from .decode import (DEFAULT_DECODE_BUCKETS, DecodeEngine, DecodeStream,
                     tiny_lm_params)
from .kvcache import NULL_BLOCK, CacheOverflow, PagedKVCache

__all__ = ["DeadlineExceeded", "DecodeEngine", "DecodeStream",
           "tiny_lm_params", "DEFAULT_DECODE_BUCKETS", "PagedKVCache",
           "CacheOverflow", "NULL_BLOCK"]
