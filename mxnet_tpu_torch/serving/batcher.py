"""Serving shed signal.

Counterpart of ``mxnet_tpu/serving/batcher.py``; this slice of the port
carries only the typed shed, which the decode engine and the paged KV
cache raise. The dynamic micro-batcher itself comes with a later slice.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["DeadlineExceeded"]


class DeadlineExceeded(MXNetError):
    """Typed shed signal: the request's deadline budget was consumed by
    queue wait (or could never fit), so it was fast-failed instead of
    dispatched. Catch it to count sheds."""
