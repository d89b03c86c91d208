"""Data iterators of the port: ``DataDesc``, ``DataBatch``, ``DataIter``
and ``NDArrayIter`` (reference: ``mxnet_tpu/io.py`` L28-292).

The iterators live on the host, as MXNet's did: ``NDArrayIter`` keeps its
data as numpy and builds each batch as arrays on the CPU. The executor
group, or the fused train step, copies a batch into the arrays it bound on
its device; all compute runs there. ``DevicePrefetchIter``
(``io_device.py``) stages the next batch on the device while a step runs;
``Module.fit`` wraps the train iterator in one on the fused path.

The shuffle draws from numpy's global RNG exactly as the reference's
does (one ``np.random.shuffle`` of the index at construction and on every
reset), and nothing else here draws from it, so a seeded run of either
package sees the same batches. ``NDArrayIter`` offers the reference's
resumable-iterator capability (``iter_checkpoint`` / ``iter_restore``:
the cursor, the permutation and numpy's shuffle-RNG chain;
``is_resumable``). ``ResizeIter``, ``PrefetchingIter`` and the file
iterators (``CSVIter``, ``LibSVMIter``, ``MNISTIter``,
``ImageRecordIter``) are not yet ported (ROADMAP A2).
"""
from __future__ import annotations

from collections import namedtuple

import numpy as _np

from .base import MXNetError
from .context import cpu
from .ndarray.ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter",
           "DevicePrefetchIter", "is_resumable"]

_NOT_PORTED = ("ResizeIter", "PrefetchingIter", "CSVIter", "LibSVMIter",
               "MNISTIter", "ImageRecordIter", "ImageDetRecordIter")


def __getattr__(name):
    if name in _NOT_PORTED:
        raise MXNetError("mx.io.%s is not yet ported (ROADMAP A2)" % name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """reference: io.py DataDesc (name, shape, dtype, layout)."""

    def __new__(cls, name, shape, dtype=_np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, tuple(shape))
        ret.dtype = dtype
        ret.layout = layout
        return ret


class DataBatch:
    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            data = [data]
        if label is not None and not isinstance(label, (list, tuple)):
            label = [label]
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """reference: io.py DataIter."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _encode_np_rng_state(state):
    """numpy.random.get_state() tuple -> JSON-safe list (the MT19937 key
    as plain ints): the shuffle-RNG chain an iterator position carries."""
    name, keys, pos, has_gauss, cached = state
    return [str(name), [int(k) for k in _np.asarray(keys).ravel()],
            int(pos), int(has_gauss), float(cached)]


def _decode_np_rng_state(enc):
    name, keys, pos, has_gauss, cached = enc
    return (str(name), _np.asarray(keys, dtype=_np.uint32), int(pos),
            int(has_gauss), float(cached))


def is_resumable(it):
    """True when ``it`` offers the resumable-iterator capability
    (``iter_checkpoint()`` / ``iter_restore(state)``): ``NDArrayIter``,
    and ``DevicePrefetchIter`` over a resumable iterator."""
    return callable(getattr(it, "iter_checkpoint", None)) and \
        callable(getattr(it, "iter_restore", None))


def _init_data(data, allow_empty, default_name):
    """Input data as a sorted list of (name, numpy array)."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (_np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d
                    for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of "
                        "them or dict")
    return [(k, v.asnumpy() if isinstance(v, NDArray) else _np.asarray(v))
            for k, v in sorted(data.items())]


class NDArrayIter(DataIter):
    """In-memory iterator with pad, discard and roll_over of the last
    batch (reference: io.py NDArrayIter L139). Batches are CPU arrays."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        self.idx = _np.arange(self.num_data)
        if shuffle:
            _np.random.shuffle(self.idx)
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        # sample cursor: one batch before the data; roll_over carries the
        # wrap offset across resets
        self.cursor = -batch_size

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]),
                         v.dtype) for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]),
                         v.dtype) for k, v in self.label]

    def hard_reset(self):
        """Ignore rolled-over data and restart at the beginning."""
        self.cursor = -self.batch_size
        if self.shuffle:
            _np.random.shuffle(self.idx)

    def reset(self):
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            # leftover samples of the wrapped batch open the next epoch
            self.cursor = (-self.batch_size
                           + (self.cursor % self.num_data) % self.batch_size)
        else:
            self.cursor = -self.batch_size
            if self.shuffle:
                _np.random.shuffle(self.idx)

    def iter_next(self):
        self.cursor += self.batch_size
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _batch_indices(self):
        """The current batch's rows; past the data's end the selection
        wraps to the epoch's first rows, so it always has batch_size
        rows."""
        start = max(self.cursor, 0)
        end = min(start + self.batch_size, self.num_data)
        sel = self.idx[start:end]
        short = self.batch_size - len(sel)
        if short:
            sel = _np.concatenate([sel, self.idx[:short]])
        return sel

    def _take(self, arrays, sel=None):
        if sel is None:
            sel = self._batch_indices()
        return [array(v[sel], ctx=cpu()) for _, v in arrays]

    def next(self):
        if not self.iter_next():
            raise StopIteration
        sel = self._batch_indices()
        return DataBatch(data=self._take(self.data, sel),
                         label=self._take(self.label, sel)
                         if self.label else [],
                         pad=self.getpad(), index=sel.copy())

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label) if self.label else []

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0

    def getindex(self):
        return self._batch_indices()

    # -- the resumable-iterator capability ------------------------------
    def iter_checkpoint(self):
        """JSON-serializable exact position: batch cursor, the live index
        permutation, and (shuffled iterators) numpy's global RNG state the
        NEXT reset()'s shuffle will draw from."""
        state = {"kind": "NDArrayIter",
                 "cursor": int(self.cursor),
                 "idx": [int(i) for i in self.idx],
                 "num_data": int(self.num_data),
                 "batch_size": int(self.batch_size),
                 "shuffle": bool(self.shuffle)}
        if self.shuffle:
            state["np_rng"] = _encode_np_rng_state(_np.random.get_state())
        return state

    def iter_restore(self, state):
        """Apply a position captured by :meth:`iter_checkpoint`, the
        shuffle-RNG chain included, so every later epoch's shuffle matches
        the uninterrupted run."""
        if int(state.get("num_data", self.num_data)) != self.num_data or \
                int(state.get("batch_size", self.batch_size)) != \
                self.batch_size:
            raise MXNetError(
                "iterator position was captured over %s rows / batch %s "
                "but this iterator has %d/%d: dataset changed under the "
                "checkpoint" % (state.get("num_data"),
                                state.get("batch_size"), self.num_data,
                                self.batch_size))
        self.cursor = int(state["cursor"])
        self.idx = _np.asarray(state["idx"], dtype=self.idx.dtype)
        if state.get("np_rng") is not None:
            _np.random.set_state(_decode_np_rng_state(state["np_rng"]))


# the device stager lives in io_device.py but belongs to mx.io
from .io_device import DevicePrefetchIter  # noqa: E402
