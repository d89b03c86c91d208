"""Engine control surface (reference: ``mxnet_tpu/engine.py``).

The bulk size caps how many queued inference requests the serving
micro-batcher (``serving/batcher.py``) coalesces into one program call,
the serving analog of how many engine ops the reference fused into one
dispatch. 0 (the default) means no preference: the batcher takes its
largest bucket.
"""
from __future__ import annotations

import contextlib

__all__ = ["set_bulk_size", "current_bulk_size", "bulk"]

_bulk_size = 0


def set_bulk_size(size):
    """Set the bulk cap; returns the previous value. Negative sizes are
    invalid."""
    global _bulk_size
    size = int(size)
    if size < 0:
        raise ValueError("bulk size must be >= 0, got %d" % size)
    prev, _bulk_size = _bulk_size, size
    return prev


def current_bulk_size():
    """The active bulk cap (0: no preference)."""
    return _bulk_size


@contextlib.contextmanager
def bulk(size):
    """``with mx.engine.bulk(N):`` scope."""
    prev = set_bulk_size(size)
    try:
        yield
    finally:
        set_bulk_size(prev)
