"""Tensor-manipulation ops of the port (the main-path subset of
``mxnet_tpu/ops/tensor.py``: ``Flatten``, L130)."""
from __future__ import annotations

from .registry import register_op


@register_op("Flatten", aliases=("flatten",))
def _flatten(params, x):
    return x.reshape(x.shape[0], -1)
