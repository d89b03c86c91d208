"""Data iterators of the port: ``DataDesc``, ``DataBatch``, ``DataIter``,
``NDArrayIter``, ``ResizeIter``, ``PrefetchingIter``, ``CSVIter`` and
``MNISTIter`` (reference: ``mxnet_tpu/io.py`` L28-592).

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
``is_resumable``). ``PrefetchingIter`` reads ahead on a thread; every
wait on its queue and every join has a timeout. ``CSVIter`` and
``MNISTIter`` (idx files, gzipped or not) read local files into an
``NDArrayIter``. Not yet ported, and raising: ``LibSVMIter`` (it yields
sparse batches) and the image record pipelines ``ImageRecordIter`` and
``ImageDetRecordIter``, which need a JPEG decoder (ROADMAP A9).
"""
from __future__ import annotations

import gzip
import queue
import struct
import threading
from collections import namedtuple

import numpy as _np

from .base import MXNetError
from .context import cpu
from .ndarray.ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "MNISTIter", "DevicePrefetchIter",
           "is_resumable"]

_NOT_PORTED = ("LibSVMIter", "ImageRecordIter", "ImageDetRecordIter")


def __getattr__(name):
    if name in _NOT_PORTED:
        raise MXNetError("mx.io.%s is not yet ported (ROADMAP A9)" % name)
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


class ResizeIter(DataIter):
    """Loop or truncate an iterator to ``size`` batches a epoch
    (reference: io.py:295)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        if hasattr(data_iter, "default_bucket_key"):
            self.default_bucket_key = data_iter.default_bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Reads the next batches of one or more iterators on a thread
    (reference: io.py:344). A worker's error or the end of the data
    reaches ``next`` once and then stays: every later ``next`` raises it
    again."""

    _WAIT_S = 0.1

    def __init__(self, iters, rename_data=None, rename_label=None):
        if not isinstance(iters, list):
            iters = [iters]
        super().__init__(iters[0].batch_size)
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self._queue = queue.Queue(maxsize=4)
        self._stop = threading.Event()
        self._thread = None
        self._terminal = None
        self._start()

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(r, dict) else x
                     for x in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(r, dict) else x
                     for x in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)], [])

    def _put(self, item):
        # a bounded put that a reset can always interrupt
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=self._WAIT_S)
                return
            except queue.Full:
                pass

    def _worker(self):
        try:
            while not self._stop.is_set():
                try:
                    batches = [i.next() for i in self.iters]
                except StopIteration:
                    self._put(None)
                    return
                self._put(batches)
        except Exception as e:  # transported to next()
            self._put(e)

    def _start(self):
        self._thread = threading.Thread(target=self._worker,
                                        name="mx-prefetching-iter",
                                        daemon=True)
        self._thread.start()

    def _shutdown(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            if self._thread.is_alive():
                raise MXNetError("PrefetchingIter: the worker did not stop "
                                 "within 5 s")
            self._thread = None
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break

    def reset(self):
        self._shutdown()
        for i in self.iters:
            i.reset()
        self._terminal = None
        self._stop.clear()
        self._start()

    def next(self):
        if self._terminal is not None:
            raise self._terminal
        while True:
            try:
                item = self._queue.get(timeout=self._WAIT_S)
                break
            except queue.Empty:
                if self._thread is None or not self._thread.is_alive():
                    # the worker puts its last item before it exits
                    try:
                        item = self._queue.get_nowait()
                        break
                    except queue.Empty:
                        self._terminal = MXNetError(
                            "PrefetchingIter: the worker ended without a "
                            "batch or an end")
                        raise self._terminal
        if item is None:
            self._terminal = StopIteration()
            raise self._terminal
        if isinstance(item, Exception):
            self._terminal = item
            raise item
        batch = item[0]
        if len(item) > 1:
            batch = DataBatch(data=sum([b.data for b in item], []),
                              label=sum([b.label for b in item], []),
                              pad=item[0].pad, index=item[0].index)
        return batch

    def iter_next(self):
        raise NotImplementedError

    def __del__(self):
        try:
            self._stop.set()
        except Exception:
            pass


class CSVIter(DataIter):
    """Batches of a CSV file's rows (reference: io.py:447)."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=1, round_batch=True,
                 dtype="float32", **kwargs):
        super().__init__(batch_size)
        data = _np.loadtxt(data_csv, delimiter=",", dtype=dtype, ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = _np.loadtxt(label_csv, delimiter=",", dtype=dtype,
                                ndmin=2)
            label = label.reshape((-1,) + tuple(label_shape))
            if label.shape[-1] == 1:
                label = label.reshape(label.shape[:-1])
        else:
            label = _np.zeros((data.shape[0],), dtype=dtype)
        self._inner = NDArrayIter(
            data, label, batch_size,
            last_batch_handle="pad" if round_batch else "discard",
            data_name="data", label_name="label")

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


class MNISTIter(DataIter):
    """Batches of MNIST's idx files, gzipped or not (reference:
    io.py:553); the shuffle draws from numpy's global RNG."""

    def __init__(self, image, label, batch_size=128, shuffle=True,
                 flat=False, silent=False, seed=None, input_shape=None,
                 num_parts=1, part_index=0, **kwargs):
        super().__init__(batch_size)
        images = self._read_idx(image)
        labels = self._read_idx(label)
        images = images.astype(_np.float32) / 255.0
        if flat:
            images = images.reshape(images.shape[0], -1)
        else:
            images = images.reshape(images.shape[0], 1,
                                    images.shape[1], images.shape[2])
        shard = images.shape[0] // num_parts
        lo = part_index * shard
        hi = images.shape[0] if part_index == num_parts - 1 else lo + shard
        self._inner = NDArrayIter(images[lo:hi],
                                  labels[lo:hi].astype(_np.float32),
                                  batch_size, shuffle=shuffle)

    @staticmethod
    def _read_idx(path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            magic = struct.unpack(">I", f.read(4))[0]
            ndim = magic & 0xFF
            dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
            data = _np.frombuffer(f.read(), dtype=_np.uint8)
            return data.reshape(dims)

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return [DataDesc("softmax_label", (self.batch_size,))]

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


# the device stager lives in io_device.py but belongs to mx.io
from .io_device import DevicePrefetchIter  # noqa: E402
