"""NDArray of the port: a thin handle on a ``torch.Tensor``.

Counterpart of the part of ``mxnet_tpu/ndarray/ndarray.py`` (``NDArray``
L27, the constructors L460-525) that ``Executor``, ``save``/``load`` and
the training modules (``io``, ``optimizer``, ``metric``, ``kvstore``,
``module``) need: ``shape``, ``dtype``, ``size``, ``context``,
``asnumpy``, indexing ``a[key]`` and assignment ``a[key] = value`` (a
slice, an int or a numpy index), ``copyto``, ``copy``, ``astype``, the
elementwise arithmetic with arrays and scalars,
``zeros``, ``ones``, ``empty``, ``array`` and ``concatenate``. The
imperative op namespace (``mx.nd.<op>``) and autograd recording are not
yet ported (ROADMAP A6).

Where the reference's arrays are immutable jax buffers that an update
swaps, an array here is a handle on a mutable tensor: assignment writes
in place, and ``a[key]`` with a slice or an int is a view, as MXNet's
own ``NDArray`` slices are.

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

__all__ = ["NDArray", "array", "zeros", "ones", "empty", "concatenate"]

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
        """A copy on the host (never a view of a CPU array's memory)."""
        t = self._data.detach()
        return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.ndim

    @staticmethod
    def _key(key):
        if isinstance(key, NDArray):
            key = key._data
        if isinstance(key, _np.ndarray):
            key = torch.from_numpy(key)
        if isinstance(key, torch.Tensor) and key.dtype != torch.bool:
            key = key.long()
        return key

    def __getitem__(self, key):
        return NDArray(self._data[self._key(key)])

    def __setitem__(self, key, value):
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, (torch.Tensor, int, float)):
            value = torch.as_tensor(_np.asarray(value))
        with torch.no_grad():   # copy_ broadcasts and casts
            if key is Ellipsis or (isinstance(key, slice)
                                   and key == slice(None)):
                if isinstance(value, (int, float)):
                    self._data.fill_(value)
                else:
                    self._data.copy_(value)
            else:
                if isinstance(value, torch.Tensor):
                    value = value.to(self._data.device, self._data.dtype)
                self._data[self._key(key)] = value

    def _binary(self, other, fn, reverse=False):
        if isinstance(other, NDArray):
            other = other._data
        elif isinstance(other, _np.ndarray):
            other = torch.as_tensor(other, device=self._data.device)
        elif not isinstance(other, (int, float, torch.Tensor)):
            return NotImplemented
        a, b = (other, self._data) if reverse else (self._data, other)
        return NDArray(fn(a, b))

    def __add__(self, o):
        return self._binary(o, torch.add)

    def __radd__(self, o):
        return self._binary(o, torch.add, True)

    def __sub__(self, o):
        return self._binary(o, torch.sub)

    def __rsub__(self, o):
        return self._binary(o, lambda a, b: a - b, True)

    def __mul__(self, o):
        return self._binary(o, torch.mul)

    def __rmul__(self, o):
        return self._binary(o, torch.mul, True)

    def __truediv__(self, o):
        return self._binary(o, torch.div)

    def __rtruediv__(self, o):
        return self._binary(o, lambda a, b: a / b, True)

    def __neg__(self):
        return NDArray(-self._data)

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

    def copy(self):
        return NDArray(self._data.clone())

    def astype(self, dtype, copy=True):
        dt = torch_dtype(dtype)
        if not copy and self._data.dtype == dt:
            return self
        return NDArray(self._data.to(dt, copy=True))


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


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx=ctx, dtype=dtype)


def ones(shape, ctx=None, dtype=None):
    if isinstance(shape, int):
        shape = (shape,)
    return NDArray(torch.ones(tuple(shape), dtype=torch_dtype(dtype),
                              device=resolve_device(ctx)))


def concatenate(arrays, axis=0, always_copy=True):
    return NDArray(torch.cat([a._data if isinstance(a, NDArray) else a
                              for a in arrays], dim=axis))
