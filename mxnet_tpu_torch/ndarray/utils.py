"""NDArray list save/load in the reference's legacy binary format.

Counterpart of ``mxnet_tpu/ndarray/utils.py`` (``save`` L179, ``load``
L211, ``_save_one`` L57, ``_load_one`` L112) for dense arrays: the bytes
are the reference's (little-endian dmlc stream), so ``.params`` files
cross between the two packages, and MXNet itself, in both directions:

  uint64 kMXAPINDArrayListMagic(0x112) | uint64 reserved
  uint64 n_arrays | n * NDArray-V2
  uint64 n_names  | n * (uint64 len + bytes)

and each NDArray-V2 as

  uint32 0xF993fac9 | int32 stype (0: dense) | TShape(uint32 ndim +
  int64*ndim) | int32 dev_type, int32 dev_id | int32 type_flag | raw data

Sparse storage types are not yet ported (ROADMAP A12) and raise.
``load`` returns arrays on the CPU (a file holds host bytes, and the
reference's load also returns cpu arrays); ``copyto`` or
``DataParallelTrainStep.init_from`` moves them to the card.
"""
from __future__ import annotations

import struct

import numpy as _np
import torch

from ..base import MXNetError, atomic_write
from .ndarray import NDArray

__all__ = ["save", "load"]

_LIST_MAGIC = 0x112
_V1_MAGIC = 0xF993FAC8
_V2_MAGIC = 0xF993FAC9

# mshadow type flags <-> numpy dtypes
_FLAG2DT = {0: _np.float32, 1: _np.float64, 2: _np.float16, 3: _np.uint8,
            4: _np.int32, 5: _np.int8, 6: _np.int64}
_DT2FLAG = {_np.dtype(v): k for k, v in _FLAG2DT.items()}


def _w_shape(out, shape):
    out.append(struct.pack("<I", len(shape)))
    out.append(struct.pack("<%dq" % len(shape), *shape))


def _r_shape(buf, pos):
    (ndim,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    dims = struct.unpack_from("<%dq" % ndim, buf, pos)
    return tuple(int(d) for d in dims), pos + 8 * ndim


def _host(arr):
    if isinstance(arr, NDArray):
        return arr.asnumpy()
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return _np.asarray(arr)


def _save_one(out, arr):
    """Serialize one dense array as NDArray-V2."""
    if getattr(arr, "stype", "default") != "default":
        raise MXNetError("saving storage type %r is not yet ported "
                         "(ROADMAP A12)" % arr.stype)
    data = _host(arr)
    if data.ndim == 0:
        # ndim 0 means "None placeholder" in the reference format
        raise MXNetError("cannot save a 0-d NDArray in the legacy format; "
                         "reshape to (1,) first")
    out.append(struct.pack("<I", _V2_MAGIC))
    out.append(struct.pack("<i", 0))
    _w_shape(out, data.shape)
    out.append(struct.pack("<ii", 1, 0))  # Context: kCPU, id 0
    flag = _DT2FLAG.get(data.dtype)
    if flag is None:
        data = data.astype(_np.float32)
        flag = 0
    out.append(struct.pack("<i", flag))
    out.append(_np.ascontiguousarray(data).tobytes())


def _load_one(buf, pos):
    """Deserialize one dense array; returns (NDArray on the CPU, new pos)."""
    (magic,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    if magic == _V2_MAGIC:
        (stype,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        if stype != 0:
            raise MXNetError("loading storage type %d is not yet ported "
                             "(ROADMAP A12)" % stype)
        shape, pos = _r_shape(buf, pos)
    elif magic == _V1_MAGIC:
        shape, pos = _r_shape(buf, pos)
    else:
        # pre-V1 legacy: the magic itself is ndim, dims are uint32
        dims = struct.unpack_from("<%dI" % magic, buf, pos)
        shape = tuple(int(d) for d in dims)
        pos += 4 * magic
    if len(shape) == 0:
        return NDArray(_np.zeros((0,), _np.float32), ctx="cpu"), pos
    pos += 8  # Context (dev_type, dev_id): always load to the CPU
    (type_flag,) = struct.unpack_from("<i", buf, pos)
    pos += 4
    if type_flag not in _FLAG2DT:
        raise MXNetError("unknown dtype flag %d in file" % type_flag)
    dtype = _np.dtype(_FLAG2DT[type_flag])
    count = int(_np.prod(shape))
    data = _np.frombuffer(buf, dtype=dtype, count=count,
                          offset=pos).reshape(shape)
    pos += count * dtype.itemsize
    return NDArray(data.copy(), ctx="cpu"), pos


def save(fname, data):
    """Save a list or str->array dict (NDArray, torch.Tensor or numpy) in
    the reference binary format."""
    if isinstance(data, (NDArray, torch.Tensor, _np.ndarray)):
        data = [data]
    if isinstance(data, dict):
        names, arrays = list(data.keys()), list(data.values())
    elif isinstance(data, (list, tuple)):
        names, arrays = [], list(data)
    else:
        raise TypeError("save expects dict/list/NDArray, got %r" % type(data))
    for a in arrays:
        if not isinstance(a, (NDArray, torch.Tensor, _np.ndarray)):
            raise TypeError("cannot save %r" % type(a))
    out = [struct.pack("<QQ", _LIST_MAGIC, 0), struct.pack("<Q", len(arrays))]
    for a in arrays:
        _save_one(out, a)
    out.append(struct.pack("<Q", len(names)))
    for n in names:
        nb = n.encode("utf-8")
        out.append(struct.pack("<Q", len(nb)))
        out.append(nb)
    atomic_write(fname, b"".join(out))


def load(fname):
    """Load the reference binary format: a list (unnamed) or a dict
    (named) of NDArrays on the CPU."""
    with open(fname, "rb") as f:
        buf = f.read()
    if len(buf) < 24:
        raise MXNetError("%s: not an NDArray file" % fname)
    header, _res, n = struct.unpack_from("<QQQ", buf, 0)
    if header != _LIST_MAGIC:
        raise MXNetError("%s: bad NDArray list magic 0x%x" % (fname, header))
    pos = 24
    arrays = []
    for _ in range(n):
        arr, pos = _load_one(buf, pos)
        arrays.append(arr)
    (n_names,) = struct.unpack_from("<Q", buf, pos)
    pos += 8
    names = []
    for _ in range(n_names):
        (ln,) = struct.unpack_from("<Q", buf, pos)
        pos += 8
        names.append(buf[pos:pos + ln].decode("utf-8"))
        pos += ln
    if n_names == 0:
        return arrays
    if n_names != n:
        raise MXNetError("%s: %d names for %d arrays" % (fname, n_names, n))
    return dict(zip(names, arrays))
