"""NDArray of the port: a handle on a ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``: ``shape``, ``dtype``,
``size``, ``context``, ``asnumpy``/``asscalar``/``wait_to_read``,
``as_in_context``, ``copyto``/``copy``/``astype``, indexing (by a slice,
an int, a numpy array or an ``NDArray``) and assignment, the shape
methods (``reshape`` with MXNet's special codes, ``T``, ``transpose``,
``swapaxes``, ``expand_dims``, ``squeeze``, ``broadcast_to``/``_like``,
``tile``, ``repeat``, ``flip``, ``split``, ``slice_axis``), the full
arithmetic with arrays and scalars (``%`` with a divisor of 0 giving 0,
``**``, comparisons returning float32 arrays, ``abs``, the in-place
operators), the reductions and math methods, and autograd
(``attach_grad``, ``grad``, ``detach``, ``backward``); plus the
constructors ``array``, ``zeros``, ``ones``, ``empty``, ``full``,
``arange``, ``concatenate``, ``moveaxis`` and ``waitall``.

Where the reference's arrays are immutable jax buffers that an update
swaps, an array here is a handle on a mutable tensor: assignment and the
in-place operators write in place (a ``.grad`` handle, an executor's
bound array or a slice sees the write), and ``a[key]`` with a slice or an
int is a view, as MXNet's own slices are. Under ``autograd.record()`` an
in-place operator on an array in the graph rebinds the handle to the new
value instead (the reference's semantics; a write in place would trip
torch's version counter), and assignment into such an array raises as in
the reference (L287-290).

Every method that computes runs through ``imperative.run_op``: recorded
on torch's autograd graph only inside ``record()``.

``context`` is a ``torch.device``. The constructors put an array on the
card unless given ``ctx`` (``mx.cpu()`` for the CPU), and raise without
CUDA: there is no silent CPU default.
"""
from __future__ import annotations

import numbers

import numpy as _np
import torch

from .. import imperative as _imp
from ..base import MXNetError
from ..context import resolve_device
from ..ops.elemwise import _ref_mod, torch_dtype
from ..ops.tensor import arange_values, infer_reshape_shape, one_hot

__all__ = ["NDArray", "array", "zeros", "ones", "empty", "full", "arange",
           "concatenate", "moveaxis", "waitall"]

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


def _run(fn, *arrays):
    """``fn`` on the arrays' tensors as one op of the imperative runtime."""
    return NDArray(_imp.run_op(fn, [a._data for a in arrays]))


class NDArray:
    """Multi-dimensional array with the MXNet-1.2 API over a torch.Tensor."""

    __slots__ = ("_data", "_grad", "_grad_req", "__weakref__")

    # numpy defers to us: mx_nd * np_array -> NDArray.__rmul__
    __array_priority__ = 1000.0

    def __init__(self, data, ctx=None, dtype=None):
        if isinstance(data, NDArray):
            data = data._data
        if ctx is None and isinstance(data, torch.Tensor):
            device = data.device
        else:
            device = resolve_device(ctx)
        self._data = _as_tensor(data, device, dtype)
        self._grad = None
        self._grad_req = "null"

    # -- properties --------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return _np.dtype(_NP_DTYPES.get(self._data.dtype, _np.float32))

    @property
    def context(self):
        return self._data.device

    ctx = context

    @property
    def stype(self):
        return "default"

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def grad(self):
        return self._grad

    @property
    def T(self):
        return self if self.ndim < 2 else self.transpose()

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __array__(self, dtype=None, copy=None):
        if copy is False:
            raise ValueError("NDArray -> numpy always copies")
        a = self.asnumpy()
        return a if dtype is None else a.astype(dtype, copy=False)

    def __bool__(self):
        if self.size == 1:
            return bool(self.asnumpy().reshape(()))
        raise ValueError("The truth value of an NDArray with multiple "
                         "elements is ambiguous.")

    def __repr__(self):
        return "\n%s\n<NDArray %s @%s>" % (
            str(self.asnumpy()), "x".join(str(s) for s in self.shape),
            self.context)

    def __hash__(self):
        return id(self)

    # -- host transfer and sync -------------------------------------------
    def asnumpy(self):
        """A copy on the host (never a view of a CPU array's memory)."""
        t = self._data.detach()
        return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(()).item()

    item = asscalar

    def wait_to_read(self):
        if self._data.device.type == "cuda":
            torch.cuda.current_stream(self._data.device).synchronize()

    wait_to_write = wait_to_read

    # -- devices and dtypes -------------------------------------------------
    def as_in_context(self, ctx):
        device = resolve_device(ctx)
        if device == self._data.device:
            return self
        return _run(lambda x: x.to(device), self)

    as_in_ctx = as_in_context

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
        return NDArray(self._data.detach().to(resolve_device(other)).clone())

    def copy(self):
        return NDArray(self._data.detach().clone())

    def astype(self, dtype, copy=True):
        dt = torch_dtype(dtype)
        if not copy and self._data.dtype == dt:
            return self
        return _run(lambda x: x.to(dt, copy=True), self)

    def as_nd_ndarray(self):
        return self

    # -- autograd ------------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """A zero gradient buffer and this array as a variable of the
        graph (reference: ``attach_grad`` -> ``MarkVariables``)."""
        grad = NDArray(torch.zeros_like(self._data.detach()))
        _imp.mark_variables([self], [grad], grad_req)

    def detach(self):
        return NDArray(self._data.detach())

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        _imp.backward([self], [out_grad], retain_graph=retain_graph,
                      train_mode=train_mode)

    # -- shape manipulation ---------------------------------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        if kwargs.get("shape"):
            shape = tuple(kwargs["shape"])
        shape = infer_reshape_shape(shape, self.shape,
                                    bool(kwargs.get("reverse", False)))
        return _run(lambda x: x.reshape(shape), self)

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        axes = axes or tuple(reversed(range(self.ndim)))
        return _run(lambda x: x.permute(*axes), self)

    def swapaxes(self, dim1, dim2):
        return _run(lambda x: x.transpose(dim1, dim2), self)

    def flatten(self):
        return self.reshape((self.shape[0] if self.ndim else 1, -1))

    def expand_dims(self, axis):
        return _run(lambda x: x.unsqueeze(axis), self)

    def squeeze(self, axis=None):
        from ..ops.tensor import _squeeze, SqueezeParam
        params = SqueezeParam(axis=None if axis is None else (
            (axis,) if isinstance(axis, int) else tuple(axis)))
        return _run(lambda x: _squeeze(params, x), self)

    def broadcast_to(self, shape):
        shape = tuple(shape)
        cur = self.shape
        if len(cur) < len(shape):
            cur = (1,) * (len(shape) - len(cur)) + cur
        return _run(lambda x: x.reshape(cur).broadcast_to(shape), self)

    def broadcast_like(self, other):
        return self.broadcast_to(other.shape)

    def tile(self, reps):
        reps = (reps,) if isinstance(reps, int) else tuple(reps)
        return _run(lambda x: x.tile(reps), self)

    def repeat(self, repeats, axis=None):
        if axis is None:
            return _run(lambda x: x.reshape(-1).repeat_interleave(repeats),
                        self)
        return _run(lambda x: x.repeat_interleave(repeats, dim=axis), self)

    def flip(self, axis):
        axis = (axis,) if isinstance(axis, int) else tuple(axis)
        return _run(lambda x: x.flip(axis), self)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        from . import split as _split
        return _split(self, num_outputs=num_outputs, axis=axis,
                      squeeze_axis=squeeze_axis)

    def slice_axis(self, axis, begin, end):
        from . import slice_axis as _sa
        return _sa(self, axis=axis, begin=begin, end=end)

    # -- indexing -------------------------------------------------------------
    @staticmethod
    def _key(key):
        if isinstance(key, NDArray):
            key = key._data
        if isinstance(key, _np.ndarray):
            key = torch.from_numpy(key)
        if isinstance(key, torch.Tensor) and key.dtype != torch.bool:
            key = key.long()
        if isinstance(key, tuple):
            key = tuple(NDArray._key(k) for k in key)
        return key

    def __getitem__(self, key):
        key = self._key(key)
        if isinstance(key, torch.Tensor):
            key = key.to(self._data.device)
        return _run(lambda x: x[key], self)

    def __setitem__(self, key, value):
        if _imp.is_recording() and self._data.grad_fn is not None:
            raise MXNetError("in-place assignment to an array produced "
                             "inside autograd.record() is not supported")
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, (torch.Tensor, numbers.Number)):
            value = torch.as_tensor(_np.asarray(value))
        with torch.no_grad():   # copy_ broadcasts and casts
            if key is Ellipsis or (isinstance(key, slice)
                                   and key == slice(None)):
                if isinstance(value, numbers.Number):
                    self._data.fill_(value)
                else:
                    self._data.copy_(value)
            else:
                if isinstance(value, torch.Tensor):
                    value = value.to(self._data.device, self._data.dtype)
                key = self._key(key)
                if isinstance(key, torch.Tensor):
                    key = key.to(self._data.device)
                self._data[key] = value

    # -- arithmetic ---------------------------------------------------------
    def _binary(self, other, fn, reverse=False):
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            return _run(fn, a, b)
        if isinstance(other, _np.ndarray):
            return self._binary(NDArray(other, ctx=self.context), fn,
                                reverse)
        if isinstance(other, torch.Tensor):
            return self._binary(NDArray(other), fn, reverse)
        if isinstance(other, numbers.Number) and \
                not isinstance(other, bool):
            if reverse:
                return _run(lambda x: fn(other, x), self)
            return _run(lambda x: fn(x, other), self)
        return NotImplemented

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

    __div__, __rdiv__ = __truediv__, __rtruediv__

    def __mod__(self, o):
        return self._binary(o, _mod)

    def __rmod__(self, o):
        return self._binary(o, _mod, True)

    def __pow__(self, o):
        return self._binary(o, torch.pow)

    def __rpow__(self, o):
        return self._binary(o, lambda a, b: a ** b, True)

    def __neg__(self):
        return _run(torch.neg, self)

    def __abs__(self):
        return _run(torch.abs, self)

    def _compare(self, other, fn):
        return self._binary(other, lambda a, b: fn(a, b).to(torch.float32))

    def __eq__(self, o):
        if isinstance(o, (NDArray, _np.ndarray, numbers.Number)):
            return self._compare(o, lambda a, b: a == b)
        return NotImplemented

    def __ne__(self, o):
        if isinstance(o, (NDArray, _np.ndarray, numbers.Number)):
            return self._compare(o, lambda a, b: a != b)
        return NotImplemented

    def __gt__(self, o):
        return self._compare(o, lambda a, b: a > b)

    def __ge__(self, o):
        return self._compare(o, lambda a, b: a >= b)

    def __lt__(self, o):
        return self._compare(o, lambda a, b: a < b)

    def __le__(self, o):
        return self._compare(o, lambda a, b: a <= b)

    def _inplace(self, res):
        """``res`` written into this array: in place, or, when it is on
        the autograd graph (or cannot be written), by rebinding the
        handle, as the reference swaps its buffer."""
        if res is NotImplemented:
            return res
        new = res._data
        if new.requires_grad or new.shape != self._data.shape or \
                new.dtype != self._data.dtype:
            self._data = new
        else:
            with torch.no_grad():
                self._data.copy_(new)
        return self

    def __iadd__(self, o):
        return self._inplace(self.__add__(o))

    def __isub__(self, o):
        return self._inplace(self.__sub__(o))

    def __imul__(self, o):
        return self._inplace(self.__mul__(o))

    def __itruediv__(self, o):
        return self._inplace(self.__truediv__(o))

    __idiv__ = __itruediv__

    def __imod__(self, o):
        return self._inplace(self.__mod__(o))

    # -- reductions and math ----------------------------------------------
    def _reduce(self, fn, axis, keepdims):
        if axis is None:
            axis = tuple(range(self.ndim))
        return _run(lambda x: fn(x, dim=axis, keepdim=keepdims), self)

    def sum(self, axis=None, keepdims=False):
        return self._reduce(torch.sum, axis, keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._reduce(torch.mean, axis, keepdims)

    def max(self, axis=None, keepdims=False):
        return self._reduce(torch.amax, axis, keepdims)

    def min(self, axis=None, keepdims=False):
        return self._reduce(torch.amin, axis, keepdims)

    def prod(self, axis=None, keepdims=False):
        from . import prod as _prod
        return _prod(self, axis=axis, keepdims=keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        if ord == 2:
            return _run(lambda x: torch.sqrt(torch.sum(
                torch.square(x), dim=axis if axis is not None
                else tuple(range(x.dim())), keepdim=keepdims)), self)
        return self.abs().sum(axis=axis, keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False):
        from . import argmax as _argmax
        return _argmax(self, axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        from . import argmin as _argmin
        return _argmin(self, axis=axis, keepdims=keepdims)

    def abs(self):
        return self.__abs__()

    def clip(self, a_min=None, a_max=None):
        return _run(lambda x: torch.clamp(x, a_min, a_max), self)

    def sqrt(self):
        return _run(torch.sqrt, self)

    def square(self):
        return _run(torch.square, self)

    def exp(self):
        return _run(torch.exp, self)

    def log(self):
        return _run(torch.log, self)

    def dot(self, other):
        from . import dot as _dot
        return _dot(self, other)

    def sigmoid(self):
        return _run(torch.sigmoid, self)

    def tanh(self):
        return _run(torch.tanh, self)

    def relu(self):
        return _run(torch.relu, self)

    def softmax(self, axis=-1):
        return _run(lambda x: torch.softmax(x, dim=axis), self)

    def one_hot(self, depth, on_value=1.0, off_value=0.0):
        return _run(lambda x: one_hot(x, depth) * (on_value - off_value)
                    + off_value, self)

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        from . import topk as _topk
        return _topk(self, axis=axis, k=k, ret_typ=ret_typ,
                     is_ascend=is_ascend)


def _mod(a, b):
    """The reference's ``%`` on a tensor and a tensor or scalar."""
    like = a if isinstance(a, torch.Tensor) else b
    if not isinstance(a, torch.Tensor):
        a = torch.tensor(a, device=like.device)
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(b, device=like.device)
    return _ref_mod(a, b)


# ---------------------------------------------------------------------------
# constructors (reference: ndarray.py L460-527)
# ---------------------------------------------------------------------------


def array(source_array, ctx=None, dtype=None):
    """A new array holding a copy of ``source_array``."""
    if isinstance(source_array, NDArray):
        source_array = source_array._data
    if isinstance(source_array, torch.Tensor):
        source_array = source_array.detach().clone()
    return NDArray(source_array, ctx=ctx, dtype=dtype)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype=None, **kwargs):
    return NDArray(torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                               device=resolve_device(ctx)))


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx=ctx, dtype=dtype)


def ones(shape, ctx=None, dtype=None, **kwargs):
    return NDArray(torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                              device=resolve_device(ctx)))


def full(shape, val, ctx=None, dtype=None):
    return NDArray(torch.full(_shape(shape), val, dtype=torch_dtype(dtype),
                              device=resolve_device(ctx)))


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    return NDArray(arange_values(start, stop, step, repeat,
                                 torch_dtype(dtype), resolve_device(ctx)))


def concatenate(arrays, axis=0, always_copy=True):
    arrays = [a if isinstance(a, NDArray) else NDArray(a) for a in arrays]
    return NDArray(_imp.run_op(lambda *xs: torch.cat(xs, dim=axis),
                               [a._data for a in arrays]))


def moveaxis(tensor, source, destination):
    return _run(lambda x: x.movedim(source, destination), tensor)


def waitall():
    """Block until all queued work on the card is done (reference:
    ``MXNDArrayWaitAll``)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
