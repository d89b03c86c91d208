"""Device-resident batch prefetch: the input half of the overlapped
training pipeline.

Counterpart of ``mxnet_tpu/io_device.py`` (L34-344): a background thread
pulls host batches from the wrapped iterator and *stages* them on the
device while the current fused step still runs, so ``next()`` hands the
training loop a batch that is already on the card. The buffer is bounded
(``depth`` staged batches, default 2), the worker starts lazily on the
first ``next()``, the end-of-stream or error sentinel is sticky, a batch
pulled but not yet delivered is re-staged first by a worker the watchdog
restarts, and the hit/stall counters go to
``profiler.record_pipeline_event``. ``Module.fit`` wraps the train
iterator in one on the fused path; ``MXNET_DEVICE_PREFETCH=0`` opts out
and ``MXNET_DEVICE_PREFETCH_DEPTH`` resizes the buffer.

On the card (``default_stage_fn`` with a CUDA device) each host array
is copied into a pinned host buffer and from there to the device with
``non_blocking=True`` on a side ``torch.cuda.Stream`` (an array already
on the device passes through, as the step would take it), and one
``torch.cuda.Event`` is recorded after a batch's copies. A pinned buffer
is written again only after its copy's event has completed (a ring of
``depth + 2`` buffer sets). At hand-over, in ``next()`` on the consumer's
thread, the consumer's current stream waits on the event and every staged
tensor is passed to ``record_stream`` with that stream, so the caching
allocator cannot reuse its memory while the step still reads it. A batch
is staged on the card or ``next()`` raises: nothing drops back to the
host batch. On the CPU a staged array is a fresh copy of the host one.
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as _np
import torch

from .base import MXNetError
from .context import resolve_device
from .io import DataBatch, DataIter

__all__ = ["DevicePrefetchIter", "default_stage_fn"]


def _tensor(arr):
    """A batch array (NDArray, tensor or numpy) as a tensor."""
    data = getattr(arr, "_data", arr)
    if not isinstance(data, torch.Tensor):
        data = torch.from_numpy(_np.ascontiguousarray(_np.asarray(data)))
    return data


class _PinnedRing:
    """``slots`` sets of pinned host buffers, reused in turn; a set is
    written again only after the event recorded after its copies has
    completed."""

    def __init__(self, slots):
        self._slots = [{"bufs": {}, "event": None} for _ in range(slots)]
        self._next = 0

    def take(self):
        slot = self._slots[self._next]
        self._next = (self._next + 1) % len(self._slots)
        if slot["event"] is not None:
            slot["event"].synchronize()
            slot["event"] = None
        return slot

    @staticmethod
    def buffer(slot, i, src):
        key = (i, tuple(src.shape), src.dtype)
        buf = slot["bufs"].get(key)
        if buf is None:
            buf = slot["bufs"][key] = torch.empty(src.shape, dtype=src.dtype,
                                                  pin_memory=True)
        return buf


def default_stage_fn(device=None, depth=2):
    """A stage function placing each batch's data and label arrays on
    ``device`` (default: the card, ``cuda:0``; raises without CUDA).

    The staged batch is marked ``_device_staged``; on the card it carries
    ``_ready_event``, the event its consumer waits on
    (:meth:`DevicePrefetchIter.next` does). ``depth`` sizes the pinned
    ring (``depth + 2`` sets)."""
    from .ndarray.ndarray import NDArray
    dev = resolve_device(device)
    if dev.type == "cuda":
        side = torch.cuda.Stream(dev)
        ring = _PinnedRing(max(1, int(depth)) + 2)
    else:
        side = ring = None

    def stage(batch):
        srcs = [_tensor(a) for a in (batch.data or [])] + \
            [_tensor(a) for a in (batch.label or [])]
        if side is None:
            outs = [t.to(dev, copy=True) for t in srcs]
            event = None
        else:
            # host arrays through the pinned ring; an array already on the
            # card passes through as the step would take it
            slot = ring.take()
            outs = list(srcs)
            with torch.cuda.device(dev), torch.cuda.stream(side):
                for i, t in enumerate(srcs):
                    if t.device.type == "cpu":
                        buf = ring.buffer(slot, i, t)
                        buf.copy_(t)
                        t = buf
                    if t.device != dev:
                        outs[i] = torch.empty(
                            t.shape, dtype=t.dtype, device=dev).copy_(
                                t, non_blocking=True)
                event = torch.cuda.Event()
                event.record(side)
            slot["event"] = event
        n_data = len(batch.data or [])
        staged = DataBatch(
            data=[NDArray(t) for t in outs[:n_data]],
            label=[NDArray(t) for t in outs[n_data:]],
            pad=getattr(batch, "pad", None),
            index=getattr(batch, "index", None),
            bucket_key=getattr(batch, "bucket_key", None),
            provide_data=getattr(batch, "provide_data", None),
            provide_label=getattr(batch, "provide_label", None))
        staged._device_staged = True
        staged._ready_event = event
        return staged

    return stage


def _hand_over(batch):
    """The consumer's side of a staged batch: its current stream waits on
    the batch's copies, and the caching allocator learns that stream
    reads the batch's tensors."""
    event = getattr(batch, "_ready_event", None)
    if event is None:
        return
    arrays = list(batch.data or []) + list(batch.label or [])
    dev = arrays[0]._data.device if arrays else None
    stream = torch.cuda.current_stream(dev)
    stream.wait_event(event)
    for a in arrays:
        a._data.record_stream(stream)


class DevicePrefetchIter(DataIter):
    """Background-thread iterator wrapper staging the NEXT batch on the
    device while the current step runs.

    Batches come out device-resident (via ``stage_fn``), the buffer depth
    is configurable, the worker starts lazily on the first ``next()``, and
    the end-of-stream / error sentinel is sticky: once the worker ends,
    every later ``next()`` re-raises instead of waiting on an empty queue.
    Exposes ``counters`` (hits/stalls/stall_ms/staged) and mirrors them
    into ``profiler.record_pipeline_event``."""

    _STOP = object()
    _MAX_RESTARTS = 3  # watchdog restarts a worker per epoch

    def __init__(self, base_iter, stage_fn=None, depth=2):
        super().__init__(getattr(base_iter, "batch_size", 0))
        self.base = base_iter
        self.depth = max(1, int(depth))
        self.stage_fn = stage_fn if stage_fn is not None else \
            default_stage_fn(depth=self.depth)
        self._queue = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._thread = None
        self._terminal = None
        # the worker's real exception, kept outside the queue: if the
        # terminal sentinel is lost, the loop's error still names it
        self._worker_error = None
        # the batch pulled from the base iterator but not yet delivered:
        # a restarted worker stages it first
        self._pending = None
        self._restarts = 0
        self._hb = None
        self.counters = {"hits": 0, "stalls": 0, "stall_ms": 0.0, "staged": 0}

    @property
    def provide_data(self):
        return self.base.provide_data

    @property
    def provide_label(self):
        return self.base.provide_label

    @property
    def default_bucket_key(self):
        return getattr(self.base, "default_bucket_key", None)

    # ------------------------------------------------------------------
    def _worker(self):
        from . import profiler as _prof
        from .resilience import faults as _faults
        from .resilience.retry import RetryPolicy
        from .resilience.watchdog import watchdog as _watchdog
        # a death that never delivered its terminal sentinel is restarted
        # through the factory; the heartbeat closes only on exits that
        # delivered their outcome
        hb = self._hb
        if hb is None or hb.closed:
            hb = self._hb = _watchdog().register(
                "mx-device-prefetch", thread=self._thread,
                on_death="restart", restart=self._restart_worker)
        stage_retry = RetryPolicy(site="prefetch.stage")

        def _stage_once(b):
            _faults.fault_point("prefetch.stage",
                                staged=self.counters["staged"])
            return self.stage_fn(b)

        try:
            while not self._stop.is_set():
                hb.beat()
                if self._pending is None:
                    try:
                        self._pending = self.base.next()
                    except StopIteration:
                        self._put(self._STOP)
                        hb.close()
                        return
                t0 = time.perf_counter()
                staged = stage_retry.call(_stage_once, self._pending)
                _prof.record_pipeline_event(
                    prefetch_stage_ms=(time.perf_counter() - t0) * 1e3)
                self.counters["staged"] += 1
                hb.idle()  # a put() blocked on a full queue is
                #            backpressure, not a stall
                self._put(staged)
                self._pending = None
            hb.close()  # clean stop
        except BaseException as e:  # transported to next(), then sticky
            self._worker_error = e
            self._put(e)
            hb.close()

    def _put(self, item):
        # a bounded put that a concurrent reset() can always interrupt
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return
            except queue.Full:
                pass

    def _start(self):
        self._thread = threading.Thread(target=self._worker,
                                        name="mx-device-prefetch", daemon=True)
        self._thread.start()

    def _restart_worker(self):
        """Watchdog restart factory: rebuild the stager after a silent
        death; the pending batch is staged first, so no batch is dropped
        or reordered. Raises when stopped, terminal or out of budget."""
        if self._stop.is_set() or self._terminal is not None:
            raise MXNetError("prefetch stager stopped/terminal: "
                             "not restartable")
        if self._restarts >= self._MAX_RESTARTS:
            raise MXNetError(
                "prefetch stager exceeded its restart budget (%d)"
                % self._MAX_RESTARTS)
        self._restarts += 1
        self._worker_error = None
        self._start()
        return self._thread

    def _maybe_restart(self):
        """next()'s dead-worker path: one immediate watchdog scan. True
        when a restart was applied."""
        hb = self._hb
        if hb is None or getattr(hb, "closed", True) \
                or self._restarts >= self._MAX_RESTARTS:
            return False
        before = self._restarts
        from .resilience.watchdog import watchdog as _watchdog
        _watchdog().scan()
        return self._restarts > before or (
            self._thread is not None and self._thread.is_alive())

    def _shutdown(self):
        if self._hb is not None:
            # retire supervision BEFORE stopping the thread: a shutdown
            # must never read as a death
            self._hb.close()
            self._hb = None
        if self._thread is None:
            return
        self._stop.set()
        # drain until the worker exits: a put() blocked on a full queue
        # could otherwise land a stale batch after a one-shot drain
        while self._thread.is_alive():
            try:
                self._queue.get(timeout=0.05)
            except queue.Empty:
                pass
        self._thread.join(timeout=5)
        self._thread = None
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._stop.clear()

    # ------------------------------------------------------------------
    def reset(self):
        self._shutdown()
        self.base.reset()
        self._terminal = None
        self._worker_error = None
        self._pending = None
        self._restarts = 0

    # -- the resumable-iterator capability, forwarded to the base -------
    def iter_checkpoint(self):
        """The base iterator's exact position, valid at an epoch boundary
        (the stager has delivered its terminal sentinel, so the base's
        cursor IS the consumed position); mid-flight it would be off by
        the read-ahead, and raises."""
        if not callable(getattr(self.base, "iter_checkpoint", None)):
            raise MXNetError("base iterator %s is not resumable"
                             % type(self.base).__name__)
        if self._thread is not None and self._thread.is_alive() \
                and self._terminal is None:
            raise MXNetError(
                "DevicePrefetchIter position is only capturable at an "
                "epoch boundary (the stager reads ahead of consumption)")
        return self.base.iter_checkpoint()

    def iter_restore(self, state):
        self._shutdown()
        self._terminal = None
        self._worker_error = None
        self._pending = None
        self._restarts = 0
        self.base.iter_restore(state)

    def next(self):
        from . import profiler as _prof
        if self._terminal is not None:
            raise self._terminal
        if self._thread is None:
            self._start()
        stall_ms = None
        try:
            item = self._queue.get_nowait()
        except queue.Empty:
            t0 = time.perf_counter()
            while True:
                try:
                    item = self._queue.get(timeout=0.1)
                    break
                except queue.Empty:
                    if self._thread is None or not self._thread.is_alive():
                        # the worker enqueues its sentinel before exiting:
                        # drain once more before declaring it lost
                        try:
                            item = self._queue.get_nowait()
                            break
                        except queue.Empty:
                            if self._maybe_restart():
                                continue
                            cause = self._worker_error
                            msg = "device prefetch worker died " \
                                  "without a sentinel"
                            if cause is not None:
                                msg += " (root cause: %s: %s)" \
                                    % (type(cause).__name__, cause)
                            self._terminal = MXNetError(msg)
                            self._terminal.__cause__ = cause
                            raise self._terminal
            stall_ms = (time.perf_counter() - t0) * 1e3
        if item is self._STOP:
            self._terminal = StopIteration()
            raise self._terminal
        if isinstance(item, BaseException):
            self._terminal = item
            raise item
        _hand_over(item)
        if stall_ms is None:
            self.counters["hits"] += 1
            _prof.record_pipeline_event(prefetch_hit=1)
        else:
            self.counters["stalls"] += 1
            self.counters["stall_ms"] += stall_ms
            _prof.record_pipeline_event(prefetch_stall=1,
                                        prefetch_stall_ms=stall_ms)
        return item

    def iter_next(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError

    def __del__(self):
        try:
            self._stop.set()
        except Exception:
            pass
