"""Elementwise ops of the port (the main-path subset of
``mxnet_tpu/ops/elemwise.py``): ``elemwise_add`` and ``_plus_scalar``,
which ``Symbol.__add__`` emits, and ``Cast`` (L199)."""
from __future__ import annotations

import numpy as _np
import torch

from ..base import Params, np_dtype, param_field
from .registry import register_op

#: numpy dtype -> torch dtype, for Cast and the NDArray constructors
TORCH_DTYPES = {_np.dtype(k): v for k, v in (
    (_np.float32, torch.float32), (_np.float64, torch.float64),
    (_np.float16, torch.float16), (_np.uint8, torch.uint8),
    (_np.int8, torch.int8), (_np.int32, torch.int32),
    (_np.int64, torch.int64), (_np.bool_, torch.bool))}


def torch_dtype(dtype):
    """A user dtype spec (str / numpy / torch) as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype == "bfloat16":
        return torch.bfloat16
    return TORCH_DTYPES[np_dtype(dtype)]


@register_op("elemwise_add", aliases=("_add", "broadcast_add", "_plus",
                                      "_Plus", "broadcast_plus"),
             input_names=("lhs", "rhs"))
def _elemwise_add(params, lhs, rhs):
    return lhs + rhs


class ScalarParam(Params):
    scalar = param_field(float, default=0.0)


@register_op("_plus_scalar", aliases=("_PlusScalar",), param_cls=ScalarParam)
def _plus_scalar(params, x):
    return x + params.scalar


class CastParam(Params):
    dtype = param_field(str, default="float32")


@register_op("Cast", aliases=("cast",), param_cls=CastParam)
def _cast(params, x):
    return x.to(torch_dtype(params.dtype))
