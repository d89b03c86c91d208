"""NDArray of the port: a thin handle on a ``torch.Tensor``.

Counterpart of the part of ``mxnet_tpu/ndarray/ndarray.py`` (``NDArray``
L27, the constructors L460-525) that ``Executor`` and ``save``/``load``
need: ``shape``, ``dtype``, ``context``, ``asnumpy``, whole-array
assignment ``a[:] = value``, ``copyto``, ``zeros`` and ``array``. The
imperative op namespace (``mx.nd.<op>``, arithmetic, autograd recording)
is not yet ported (ROADMAP A2).

``context`` is a ``torch.device``. The constructors put an array on the
card unless given ``ctx`` (``mx.cpu()`` for the CPU), and raise without
CUDA: there is no silent CPU default.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError
from ..context import resolve_device
from ..ops.elemwise import torch_dtype

__all__ = ["NDArray", "array", "zeros"]

_NP_DTYPES = {torch.float32: _np.float32, torch.float64: _np.float64,
              torch.float16: _np.float16, torch.uint8: _np.uint8,
              torch.int8: _np.int8, torch.int32: _np.int32,
              torch.int64: _np.int64, torch.bool: _np.bool_}


def _as_tensor(source, device, dtype):
    """Data -> tensor on ``device``. A tensor is taken as it is (an
    NDArray is a handle); host data is copied: numpy arrays keep their
    dtype except float64, which becomes float32, and python lists and
    scalars are float32 (the MXNet convention, as in the JAX package)."""
    if isinstance(source, torch.Tensor):
        t = source
    else:
        keep = isinstance(source, _np.ndarray) and dtype is None
        npd = _np.asarray(source)
        if dtype is None and (not keep or npd.dtype == _np.float64):
            npd = npd.astype(_np.float32)
        t = torch.tensor(npd)
    if dtype is not None:
        t = t.to(torch_dtype(dtype))
    return t.to(device)


class NDArray:
    """Multi-dimensional array with the MXNet-1.2 API over a torch.Tensor."""

    __slots__ = ("_data",)

    def __init__(self, data, ctx=None, dtype=None):
        if isinstance(data, NDArray):
            data = data._data
        if ctx is None and isinstance(data, torch.Tensor):
            device = data.device
        else:
            device = resolve_device(ctx)
        self._data = _as_tensor(data, device, dtype)

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return _np.dtype(_NP_DTYPES.get(self._data.dtype, _np.float32))

    @property
    def context(self):
        return self._data.device

    def asnumpy(self):
        return self._data.detach().cpu().numpy()

    def __setitem__(self, key, value):
        if not (key is Ellipsis or (isinstance(key, slice)
                                    and key == slice(None))):
            raise MXNetError("NDArray.__setitem__ with key %r is not yet "
                             "ported (whole-array a[:] = v only; ROADMAP A2)"
                             % (key,))
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, torch.Tensor):
            value = torch.as_tensor(_np.asarray(value))
        with torch.no_grad():   # copy_ broadcasts and casts
            self._data.copy_(value)

    def copyto(self, other):
        """Copy into another NDArray in place, or onto a device (a new
        array)."""
        if isinstance(other, NDArray):
            if other is self:
                return other
            if other.shape != self.shape:
                raise MXNetError("copyto shape mismatch %s vs %s"
                                 % (self.shape, other.shape))
            with torch.no_grad():
                other._data.copy_(self._data)
            return other
        return NDArray(self._data.to(resolve_device(other)).clone())


def array(source_array, ctx=None, dtype=None):
    """A new array holding a copy of ``source_array``."""
    if isinstance(source_array, NDArray):
        source_array = source_array._data
    if isinstance(source_array, torch.Tensor):
        source_array = source_array.detach().clone()
    return NDArray(source_array, ctx=ctx, dtype=dtype)


def zeros(shape, ctx=None, dtype=None):
    if isinstance(shape, int):
        shape = (shape,)
    return NDArray(torch.zeros(tuple(shape), dtype=torch_dtype(dtype),
                               device=resolve_device(ctx)))
