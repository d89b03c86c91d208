"""ProgramBuilder — one program family's dispatch seam and counters.

Counterpart of ``mxnet_tpu/compile/builder.py`` (``aot`` / ``lookup``,
L251-401). The JAX builder lowers and compiles one XLA executable per
distinct shape/dtype signature. The port keeps that seam in two forms:

- By default the body runs eagerly. What the builder keeps is the
  bookkeeping callers rely on: each distinct signature is one "program",
  ``program_count()`` counts them (the decode engine's
  ``len(buckets) + 1`` invariant), and the per-site compile counters
  record whether a signature was first seen ahead of time (``aot_info``,
  warmup) or on demand (first dispatch).
- With ``capture=True``, a signature whose tensors lie on the card is
  captured as one ``torch.cuda.CUDAGraph`` (:class:`CapturedProgram`):
  the body runs once eagerly on a side stream, which absorbs every
  one-time cost (library builds and loads, NVRTC modules, cuDNN and
  cuBLAS handles and workspaces), then once under capture. The capture is
  the signature's "compile" in ``compile_counters``; a dispatch of a
  known signature replays the graph. All captured programs of one
  builder draw on one memory pool (``torch.cuda.graph_pool_handle()``).
  On CPU tensors the body runs eagerly, as without capture.

A capture that fails raises: nothing runs the body eagerly on the card
after a failed capture.
"""
from __future__ import annotations

import threading
from collections import namedtuple

import numpy as _np
import torch

from .. import profiler as _prof
from ..base import MXNetError

__all__ = ["ProgramBuilder", "TensorSpec", "CapturedProgram"]

#: Abstract argument for ahead-of-time registration (the analog of
#: ``jax.ShapeDtypeStruct``): anything with ``shape`` and ``dtype``.
TensorSpec = namedtuple("TensorSpec", ["shape", "dtype"])

# one lock per card: a capture holds it from its warm run to its end, and
# a replay holds it while it enqueues, so no replay of this package is
# launched on a card while a graph is being captured there (the captures
# also run in torch's "thread_local" mode, so other threads' eager work
# cannot invalidate them)
_device_locks = {}
_device_locks_guard = threading.Lock()


def device_lock(device):
    """The lock that serialises captures against replays on ``device``."""
    key = torch.device(device).index or 0
    with _device_locks_guard:
        lock = _device_locks.get(key)
        if lock is None:
            lock = _device_locks[key] = threading.Lock()
    return lock


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                            TensorSpec):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, TensorSpec):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _clone(leaf):
    return leaf.detach().clone() if isinstance(leaf, torch.Tensor) else leaf


def _as_tensor(leaf):
    if isinstance(leaf, _np.ndarray):
        return torch.from_numpy(_np.ascontiguousarray(leaf))
    return leaf


class _Pending:
    """Parked in the program map while its owner builds it: racers for the
    same signature wait on ``ready``."""

    __slots__ = ("ready", "program", "error")

    def __init__(self):
        self.ready = threading.Event()
        self.program = None
        self.error = None


class CapturedProgram:
    """One signature of a body captured as a CUDA graph.

    The arguments in ``static_argnums`` are captured where they lie (the
    graph reads those tensors by address: the serving weights); every
    other argument gets static input tensors of its own at capture. A call
    copies each argument leaf that is not already its static tensor into
    it, replays the graph on the caller's current stream and returns
    clones of the static outputs, made on that stream before the next
    replay can be enqueued, so a result stays valid across later calls.
    A host leaf goes through a pinned buffer of its own, copied to the
    card without waiting for the card: the host waits only until that
    buffer's previous copy has left it, so the host stages a request
    while the card runs the one before. One call at a time runs a program
    (its copies, replay and clones under one lock).
    """

    def __init__(self, fn, args, static_argnums, device, pool, stream):
        self.device = device
        self._lock = threading.Lock()
        statics = [a if i in static_argnums else _map(a, _clone)
                   for i, a in enumerate(args)]
        self._static_args = statics
        self._static_leaves = [list(_leaves(a)) for a in statics]
        self._pinned = {}       # (arg, leaf) index -> [pinned buffer, event]
        with device_lock(device):
            cur = torch.cuda.current_stream(device)
            stream.wait_stream(cur)
            with torch.no_grad(), torch.cuda.stream(stream):
                fn(*statics)
            stream.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.no_grad(), torch.cuda.graph(
                    graph, pool=pool, stream=stream,
                    capture_error_mode="thread_local"):
                outs = fn(*statics)
        self._graph = graph
        self._outs = tuple(outs) if isinstance(outs, (list, tuple)) \
            else (outs,)
        self._single = not isinstance(outs, (list, tuple))

    def _copy_in(self, args):
        if len(args) != len(self._static_args):
            raise MXNetError("captured program takes %d arguments, got %d"
                             % (len(self._static_args), len(args)))
        for i, (arg, static) in enumerate(zip(args, self._static_args)):
            if arg is static:
                continue
            got, want = list(_leaves(arg)), self._static_leaves[i]
            if len(got) != len(want):
                raise MXNetError("captured program: argument structure "
                                 "changed")
            for j, (leaf, st) in enumerate(zip(got, want)):
                if leaf is st:
                    continue
                if not isinstance(st, torch.Tensor):
                    if leaf != st:
                        raise MXNetError(
                            "captured program: the non-tensor argument %r "
                            "was captured as %r" % (leaf, st))
                    continue
                leaf = _as_tensor(leaf)
                if tuple(leaf.shape) != tuple(st.shape):
                    raise MXNetError("captured program: argument of shape "
                                     "%s for a static input of shape %s"
                                     % (tuple(leaf.shape), tuple(st.shape)))
                if leaf.device == st.device and \
                        leaf.data_ptr() == st.data_ptr():
                    continue
                if leaf.device.type == "cpu":
                    self._stage_host(i, j, leaf, st)
                else:
                    st.copy_(leaf)

    def _stage_host(self, i, j, leaf, st):
        slot = self._pinned.get((i, j))
        if slot is None:
            slot = self._pinned[(i, j)] = [
                torch.empty(st.shape, dtype=st.dtype, pin_memory=True), None]
        if slot[1] is not None:
            slot[1].synchronize()      # its last copy has left the buffer
        slot[0].copy_(leaf)
        st.copy_(slot[0], non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record(torch.cuda.current_stream(self.device))

    def __call__(self, *args):
        with self._lock:
            self._copy_in(args)
            with device_lock(self.device):
                self._graph.replay()
            outs = tuple(o.clone() for o in self._outs)
        return outs[0] if self._single else outs

    def replay(self):
        """Replay on the current stream as the static inputs stand; the
        static outputs are returned without a copy (timing)."""
        with self._lock:
            with device_lock(self.device):
                self._graph.replay()
        return self._outs


class ProgramBuilder:
    """Signature cache over a program body.

    Parameters
    ----------
    fn : callable
        The program body, called with the dispatch arguments as given.
    site : str
        Label the compile counters aggregate under.
    donate_argnums : tuple of int
        Arguments the body updates in place and returns (the decode
        engine's KV pages): the eager analog of XLA buffer donation, kept
        as ``self.donate_argnums`` for callers.
    capture : bool
        Capture each signature on the card as a CUDA graph (module
        docstring). The body must then be an inference program: it runs
        under ``torch.no_grad()``, and reads no value back to the host.
    static_argnums : tuple of int
        With ``capture``, the arguments the graphs read by address
        (:class:`CapturedProgram`).
    """

    def __init__(self, fn, site="program", donate_argnums=(), capture=False,
                 static_argnums=()):
        self._fn = fn
        self.site = str(site)
        self.donate_argnums = tuple(donate_argnums or ())
        self.capture = bool(capture)
        self.static_argnums = frozenset(static_argnums or ())
        self._lock = threading.Lock()
        self._programs = {}      # signature -> program | _Pending
        self._pools = {}         # device index -> graph pool handle
        self._streams = {}       # device index -> capture stream
        self.captures = 0

    def _sig(self, args):
        sig = []
        for leaf in _leaves(args):
            shape = getattr(leaf, "shape", None)
            dtype = getattr(leaf, "dtype", None)
            if shape is None or dtype is None:
                sig.append(type(leaf))
                continue
            key = (tuple(int(d) for d in shape), str(dtype))
            if self.capture:
                key += (str(getattr(leaf, "device", "spec")),)
            sig.append(key)
        return tuple(sig)

    def _capture_device(self, args):
        """The card the arguments' tensors lie on, when this builder
        captures and they do; else None (the body runs eagerly)."""
        if not self.capture:
            return None
        for leaf in _leaves(args):
            if isinstance(leaf, TensorSpec):
                raise MXNetError("%s: a capturing builder needs concrete "
                                 "tensors, got %r" % (self.site, leaf))
            if isinstance(leaf, torch.Tensor):
                return leaf.device if leaf.device.type == "cuda" else None
        return None

    def _build(self, args):
        device = self._capture_device(args)
        if device is None:
            return self._fn
        idx = device.index or 0
        with self._lock:
            if idx not in self._pools:
                self._pools[idx] = torch.cuda.graph_pool_handle()
                self._streams[idx] = torch.cuda.Stream(device)
            pool, stream = self._pools[idx], self._streams[idx]
        prog = CapturedProgram(self._fn, args, self.static_argnums, device,
                               pool, stream)
        with self._lock:
            self.captures += 1
        return prog

    def aot_info(self, *args, mode="aot"):
        """The program for the signature of ``args`` (tensors, or
        :class:`TensorSpec` without capture), built on first sight;
        returns ``(program, built)`` with ``built`` True only for the call
        that built it. ``mode`` labels the counter: "aot" for warmup,
        "ondemand" for a first dispatch."""
        key = self._sig(args)
        with self._lock:
            entry = self._programs.get(key)
            owner = entry is None
            if owner:
                entry = self._programs[key] = _Pending()
        if not owner:
            if isinstance(entry, _Pending):
                entry.ready.wait()
                if entry.error is not None:
                    raise entry.error
                entry = entry.program
            _prof.record_compile_hit(self.site)
            return entry, False
        try:
            prog = self._build(args)
        except BaseException as e:
            entry.error = e
            with self._lock:      # the next request builds it again
                self._programs.pop(key, None)
            entry.ready.set()
            raise
        entry.program = prog
        with self._lock:
            self._programs[key] = prog
        entry.ready.set()
        _prof.record_compile(self.site, aot=(mode == "aot"))
        return prog, True

    def lookup(self, *args):
        """The built program for these arguments' signature, or None."""
        with self._lock:
            prog = self._programs.get(self._sig(args))
        return None if isinstance(prog, _Pending) else prog

    def __call__(self, *args):
        """Run the signature's program (replay a captured one); a
        signature seen for the first time here is built and counted as an
        on-demand program."""
        prog = self.lookup(*args)
        if prog is None:
            prog = self.aot_info(*args, mode="ondemand")[0]
        return prog(*args)

    def program_count(self):
        """Number of distinct signatures this builder has built."""
        with self._lock:
            return sum(1 for v in self._programs.values()
                       if not isinstance(v, _Pending))

    def pool_bytes(self):
        """Bytes the caching allocator holds in this builder's graph pools
        (0 without captures)."""
        with self._lock:
            pools = {tuple(p) for p in self._pools.values()}
        if not pools:
            return 0
        total = 0
        for seg in torch.cuda.memory_snapshot():
            if tuple(seg.get("segment_pool_id", ())) in pools:
                total += seg["total_size"]
        return total
