"""InferenceEngine — the serving facade over a Symbol.

Counterpart of ``mxnet_tpu/serving/engine.py``. One object owns (a) the
bucketed program cache (``program_cache.py``), whose programs on the card
are CUDA graphs captured once per bucket, (b) the dynamic micro-batcher
(``batcher.py``), which coalesces concurrent requests into full buckets,
and (c) the padded dispatch and split with compile/hit/miss counters.

    engine = InferenceEngine(sym, arg_params, aux_params, ctx=mx.gpu(0))
    engine.warmup({"data": (32, 3, 224, 224)})   # capture every bucket
    out = engine.predict({"data": batch})        # any batch size 1..32
    fut = engine.predict_async({"data": row})    # coalesced micro-batching
    engine.stats()                               # compiles/hits/misses/...

``ctx`` None is the card (``cuda:0``), raising without CUDA; ``mx.cpu()``
runs the bodies eagerly on the CPU.

The engine owns device copies of the weights, which the captured programs
read by address. ``update_params`` copies new values into them in place,
in stream order between replays and under the lock the replays take, so
each answer is computed from the old weights or from the new ones, never
a mix, and nothing is captured again; a shape or dtype change keys new
programs, as the reference recompiles. A replay's outputs are cloned on
the replay's stream before the next replay is enqueued, so a result held
across later requests keeps its values.

Not yet ported, and raising: ``reload_from`` (checkpoints, ROADMAP A8),
``from_block`` (gluon) and quantized graphs (ROADMAP A9).
"""
from __future__ import annotations

import threading
import time

import numpy as _np
import torch

from .. import profiler as _prof
from ..base import MXNetError, get_env
from ..context import resolve_device
from ..executor import GraphPlan, run_graph
from ..ndarray.ndarray import NDArray
from ..resilience import faults as _faults
from .batcher import DynamicBatcher
from .program_cache import DEFAULT_BUCKETS, BucketedProgramCache

__all__ = ["InferenceEngine"]

_QSUF = "_quantize"


def _not_ported(what, item):
    raise MXNetError("%s is not yet ported (ROADMAP %s)" % (what, item))


def _torch_dtype(np_dtype):
    return torch.from_numpy(_np.zeros(0, np_dtype)).dtype


def _host(arr):
    """A request array as a host numpy array."""
    if isinstance(arr, NDArray):
        return arr.asnumpy()
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return _np.asarray(arr)


class InferenceEngine:
    """Serve an inference graph through bucketed, pre-built programs.

    Parameters
    ----------
    symbol : Symbol
        The inference graph. Every argument present in ``arg_params`` is a
        weight; the remaining arguments (data, labels) are request inputs.
    arg_params, aux_params : dict of str -> NDArray, tensor or np.ndarray
        Weights, copied onto the engine's device.
    ctx : device
        Where the programs run (None: the card).
    buckets : tuple of int
        Batch-size buckets (default ``(1, 4, 8, 16, 32)``). On the card
        a request is copied into its program's static input buffers (the
        port's form of the reference's ``donate``).
    max_batch, max_delay_ms
        Micro-batcher knobs (batcher.py). ``max_batch=None`` defers to
        ``mx.engine.set_bulk_size`` / the largest bucket.
    async_worker : bool
        True: a background worker drains ``predict_async``'s queue. False:
        queued requests run on the calling thread at :meth:`flush`.
    name : str, optional
        Model name: served requests record ``serving.<name>.{queue,
        device,total}`` latency histograms (``serving`` when anonymous).
    default_deadline_ms, slack_factor, shed_margin
        SLA knobs (batcher.py); the deadline defaults to
        ``MXNET_SERVING_DEADLINE_MS`` (unset: no deadline).
    """

    def __init__(self, symbol, arg_params, aux_params=None, ctx=None,
                 buckets=DEFAULT_BUCKETS, max_batch=None,
                 max_delay_ms=2.0, async_worker=True, name=None,
                 default_deadline_ms=None, slack_factor=None,
                 shed_margin=1.0):
        self._device = resolve_device(ctx)
        self._ctx = self._device
        self._symbol = symbol
        self.name = name
        self.replica = None   # replica index when owned by a ModelServer
        self._lat_key = "serving.%s" % name if name else "serving"
        if default_deadline_ms is None:
            default_deadline_ms = get_env("MXNET_SERVING_DEADLINE_MS",
                                          None, float)
        self._default_deadline_ms = default_deadline_ms

        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        if any(n.endswith(_QSUF) for n in arg_names):
            _not_ported("InferenceEngine over a quantized graph", "A9")
        arg_params = dict(arg_params or {})
        aux_params = dict(aux_params or {})
        self._param_names = [n for n in arg_names if n in arg_params]
        self._input_names = [n for n in arg_names if n not in arg_params]
        if not self._input_names:
            raise MXNetError("InferenceEngine: symbol has no free inputs "
                             "(every argument was supplied as a parameter)")
        missing_aux = [n for n in aux_names if n not in aux_params]
        if missing_aux:
            raise MXNetError("InferenceEngine: missing aux states %s"
                             % missing_aux)
        self._params = {n: self._to_device(arg_params[n])
                        for n in self._param_names}
        self._aux = {n: self._to_device(aux_params[n]) for n in aux_names}

        plan = GraphPlan(symbol)

        def _serve(batch_vals, param_vals, aux_vals):
            args = dict(param_vals)
            args.update(batch_vals)
            outs, _ = run_graph(plan, args, aux_vals, False)
            return outs

        self._cache = BucketedProgramCache(_serve, buckets=buckets,
                                           device=self._device,
                                           site=self._lat_key)
        self._wkey = self._cache.weights_key(self._params, self._aux)
        # replays and in-place weight copies: one at a time, in the order
        # their work is enqueued on the stream
        self._dispatch_lock = threading.Lock()
        self._batcher = DynamicBatcher(self._run_padded, self._cache.buckets,
                                       max_batch=max_batch,
                                       max_delay_ms=max_delay_ms,
                                       autostart=async_worker,
                                       step_time=self._cache.step_time,
                                       step_time_tail=(
                                           self._cache.step_time_tail),
                                       slack_factor=slack_factor,
                                       shed_margin=shed_margin,
                                       lat_key=self._lat_key,
                                       observe_step=self._observe_batch)
        self._step_probe = 0
        self._compiles_seen = 0
        self._templates = {}        # input name -> (shape tuple, np dtype)
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    @classmethod
    def from_block(cls, block, ctx=None, **kwargs):
        _not_ported("InferenceEngine.from_block (gluon)", "A9")

    def reload_from(self, directory, poll_interval=None):
        _not_ported("InferenceEngine.reload_from (checkpoints)", "A8")

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def _as_tensor(self, v):
        if isinstance(v, NDArray):
            v = v._data
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(_np.ascontiguousarray(_np.asarray(v)))
        return v.detach()

    def _to_device(self, v):
        """An engine-owned device copy of a weight."""
        return self._as_tensor(v).to(self._device, copy=True)

    @property
    def device(self):
        return self._device

    def update_params(self, arg_params, aux_params=None):
        """Swap the serving weights in place: no capture, no new program.
        The new values are staged on the device first, then copied into
        the captured weight tensors under the dispatch lock, so every
        replay reads the old set or the new one. A shape or dtype change
        replaces the tensor, and the next request of each bucket builds
        its program anew."""
        staged = {n: self._as_tensor(v).to(self._device)
                  for n, v in (arg_params or {}).items()
                  if n in self._params}
        staged_aux = {n: self._as_tensor(v).to(self._device)
                      for n, v in (aux_params or {}).items()
                      if n in self._aux}
        if not (staged or staged_aux):
            return
        with self._dispatch_lock:
            params, aux = dict(self._params), dict(self._aux)
            reshaped = False
            for dst, src in ((params, staged), (aux, staged_aux)):
                for n, v in src.items():
                    cur = dst[n]
                    if cur.shape == v.shape and cur.dtype == v.dtype:
                        cur.copy_(v)
                    else:
                        dst[n] = v.clone()
                        reshaped = True
            if reshaped:
                self._params, self._aux = params, aux
                self._wkey = self._cache.weights_key(params, aux)

    # ------------------------------------------------------------------
    # shape templates
    # ------------------------------------------------------------------
    def _learn_templates(self, supplied):
        """Pin every input's non-batch shape and dtype, inferring the
        never-supplied ones (labels) by shape inference."""
        shapes = {n: tuple(t.shape) for n, t in self._params.items()}
        for name, (shape, _) in self._templates.items():
            shapes[name] = shape
        for name, arr in supplied.items():
            shapes[name] = tuple(arr.shape)
        try:
            arg_shapes, _, _ = self._symbol.infer_shape(**shapes)
        except MXNetError as e:
            raise MXNetError(
                "InferenceEngine: cannot infer shapes for inputs %s from "
                "%s: pass them to warmup(shapes) explicitly (%s)"
                % ([n for n in self._input_names if n not in shapes],
                   sorted(shapes), e))
        for name, shape in zip(self._symbol.list_arguments(), arg_shapes):
            if name not in self._input_names:
                continue
            dtype = _np.float32
            if name in supplied:
                dtype = _np.dtype(str(supplied[name].dtype).replace(
                    "torch.", ""))
            elif name in self._templates:
                dtype = self._templates[name][1]
            self._templates[name] = (tuple(shape), _np.dtype(dtype))

    # ------------------------------------------------------------------
    # warmup
    # ------------------------------------------------------------------
    def warmup(self, shapes=None, buckets=None):
        """Build (on the card: capture) the program of each bucket ahead
        of time. ``shapes``: input name -> full shape, whose batch axis is
        a placeholder. May be omitted once a warmup or a request taught
        the engine its inputs. Returns the number of programs built."""
        with self._lock:
            if shapes:
                supplied = {k: _np.zeros(tuple(v), _np.float32)
                            for k, v in shapes.items()}
                self._learn_templates(supplied)
            if not self._templates:
                raise MXNetError("warmup needs shapes on first use, e.g. "
                                 "engine.warmup({'data': (32, 3, 224, "
                                 "224)})")
            template = {name: (shape, _torch_dtype(dtype))
                        for name, (shape, dtype) in self._templates.items()}
        return self._cache.warmup(template, self._params, self._aux,
                                  buckets=buckets)

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------
    def _normalize_request(self, data, keep_device=False):
        """A dict of arrays, a single array (the first free input) or a
        list in input order -> arrays keyed by input name and their common
        row count. ``keep_device`` passes tensors on the engine's device
        through (the sync path); otherwise arrays become host numpy (the
        batcher stacks them)."""
        if isinstance(data, (NDArray, torch.Tensor, _np.ndarray)) or \
                hasattr(data, "shape"):
            data = {self._input_names[0]: data}
        elif isinstance(data, (list, tuple)):
            data = dict(zip(self._input_names, data))
        unknown = set(data) - set(self._input_names)
        if unknown:
            raise MXNetError("unknown inference inputs %s (free inputs: %s)"
                             % (sorted(unknown), self._input_names))
        out = {}
        for name, arr in data.items():
            if isinstance(arr, NDArray):
                arr = arr._data
            if keep_device and isinstance(arr, torch.Tensor) and \
                    arr.device == self._device:
                out[name] = arr.detach()
            else:
                out[name] = _host(arr)
        ns = {a.shape[0] for a in out.values()}
        if len(ns) != 1:
            raise MXNetError("inference inputs disagree on batch size: %s"
                             % {k: tuple(v.shape) for k, v in out.items()})
        n = ns.pop()
        if n <= 0:
            raise MXNetError("empty inference batch")
        with self._lock:
            if set(self._templates) != set(self._input_names):
                self._learn_templates(out)
        # never-supplied inputs (labels) are zeros of their inferred row
        # shape; supplied ones take the pinned dtype, so a stray float64
        # batch cannot key another program
        for name in self._input_names:
            shape, dtype = self._templates[name]
            if name in out:
                arr = out[name]
                if isinstance(arr, torch.Tensor):
                    tdt = _torch_dtype(dtype)
                    if arr.dtype != tdt:
                        out[name] = arr.to(tdt)
                elif arr.dtype != dtype:
                    out[name] = arr.astype(dtype)
            else:
                out[name] = _np.zeros((n,) + shape[1:], dtype)
        return out, n

    @staticmethod
    def _pad_rows(arr, n, bucket):
        """Row-0-replicating pad of one array (batcher.pad_to_bucket has
        the padding argument), on the device for tensors."""
        if n == bucket:
            return arr
        if isinstance(arr, torch.Tensor):
            pad = arr[:1].expand((bucket - n,) + tuple(arr.shape[1:]))
            return torch.cat([arr, pad], dim=0)
        pad = _np.broadcast_to(arr[:1], (bucket - n,) + arr.shape[1:])
        return _np.concatenate([arr, pad], axis=0)

    def _run(self, padded):
        with self._dispatch_lock:
            return self._cache.run(padded, self._params, self._aux,
                                   weights_key=self._wkey)

    def _run_padded(self, padded, n):
        """Batcher callback: run one bucket-padded host batch, return the
        padded outputs for the batcher to slice per request.

        On the CPU each output is a numpy array (requests get views). On
        the card the outputs stay device tensors, fresh clones of the
        replay's outputs, and nothing waits here, so consecutive batches
        keep the card busy. A replay's host time is only its enqueue, so
        the step-time estimate the shedder reads is timed to the result's
        readiness: the first three and every 64th warm execution of a
        bucket wait on a CUDA event recorded after the outputs' clone and
        fold the wall from dispatch to then."""
        bucket = int(next(iter(padded.values())).shape[0]) if padded else n
        _faults.fault_point("serving.dispatch", engine=self.name or "",
                            replica="" if self.replica is None
                            else self.replica, mode="async")
        compiles_before = self._cache.compiles
        tic = time.monotonic()
        outs = self._run(padded)
        if self._device.type == "cpu":
            return [o.numpy() for o in outs]
        if self._cache.compiles == compiles_before:
            self._step_probe += 1
            if (self._cache.step_samples(bucket) < 3
                    or self._step_probe % 64 == 0):
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self._device))
                done.synchronize()
                self._cache.observe_step_time(bucket,
                                              time.monotonic() - tic)
        return list(outs)

    def _observe_batch(self, bucket, seconds):
        """Batcher hook: one batch's dispatch-to-delivery wall into the
        step estimate, on the CPU only (on the card delivery is an
        enqueue; ``_run_padded`` samples readiness). Batches that built a
        program are left out: the estimate is the warm step."""
        if self._device.type != "cpu":
            return
        compiles = self._cache.compiles
        if compiles != self._compiles_seen:
            self._compiles_seen = compiles
            return
        self._cache.observe_step_time(bucket, seconds)

    def predict(self, data):
        """Synchronous inference for a batch of any size: pad to the
        nearest bucket, run its program, return unpadded NDArray outputs.
        Tensors already on the engine's device stay there (padding runs
        on the device). The dispatch wall records under
        ``<lat_key>.sync``."""
        tic = time.monotonic()
        arrays, n = self._normalize_request(data, keep_device=True)
        bucket = self._cache.bucket_for(n)
        _faults.fault_point("serving.dispatch", engine=self.name or "",
                            replica="" if self.replica is None
                            else self.replica, mode="sync")
        padded = {name: self._pad_rows(arr, n, bucket)
                  for name, arr in arrays.items()}
        outs = self._run(padded)
        _prof.record_latency(self._lat_key + ".sync",
                             (time.monotonic() - tic) * 1e9)
        return [NDArray(o[:n]) for o in outs]

    def predict_async(self, data, deadline_ms=None, priority=0):
        """Queue a request into the micro-batcher; returns a future-like
        handle (``result_wait(timeout)`` / ``done()`` /
        ``add_done_callback(fn)``) whose result is the request's unpadded
        outputs: device tensors on the card, numpy arrays on the CPU.
        ``deadline_ms`` (default: the engine's) is the end-to-end budget:
        EDF batch formation, early dispatch, and a typed
        :class:`~.batcher.DeadlineExceeded` when it cannot be met.
        ``priority`` (higher first) orders above the deadline."""
        host, _ = self._normalize_request(data)
        if deadline_ms is None:
            deadline_ms = self._default_deadline_ms
        return self._batcher.submit(host, deadline_ms=deadline_ms,
                                    priority=priority)

    def flush(self):
        """Drain any queued async requests on the calling thread."""
        self._batcher.flush()

    def stop(self):
        self._batcher.stop()

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    @property
    def compiles(self):
        return self._cache.compiles

    @property
    def hits(self):
        return self._cache.hits

    @property
    def misses(self):
        return self._cache.misses

    @property
    def captures(self):
        """CUDA graphs this engine captured (0 on the CPU)."""
        return self._cache.builder.captures

    def program(self, bucket):
        """The built program of ``bucket`` (a ``CapturedProgram`` on the
        card, the eager body on the CPU), or None; for inspection and
        timing."""
        with self._lock:
            template = dict(self._templates)
        if not template:
            return None
        batch = {n: torch.zeros((int(bucket),) + tuple(shape[1:]),
                                dtype=_torch_dtype(dt), device=self._device)
                 for n, (shape, dt) in template.items()}
        return self._cache.builder.lookup(batch, self._params, self._aux)

    def step_time(self, bucket):
        """Measured warm step time (seconds) of ``bucket``, or None."""
        return self._cache.step_time(bucket)

    def stats(self):
        """Compile/hit/miss counters plus the batcher's coalescing and SLA
        counters."""
        out = self._cache.stats()
        out.update(self._batcher.stats())
        out["buckets"] = list(self._cache.buckets)
        out["captures"] = self.captures
        if self.name is not None:
            out["name"] = self.name
        return out
