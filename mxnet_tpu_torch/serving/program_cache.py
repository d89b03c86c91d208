"""Bucketed program cache — the store of per-bucket serving programs.

Counterpart of ``mxnet_tpu/serving/program_cache.py``. Requests round up
to a small set of batch buckets and each bucket's program is built once,
ahead of time by ``warmup`` or on the first request of its size. On the
card a bucket's program is a captured CUDA graph (``compile.builder``
with ``capture=True``): the weights are read where they lie, and the
request batch is copied into the graph's static input buffers, so a
request allocates no input memory on the card (the reference's buffer
donation). On the CPU the program is the body run eagerly.

The cache also keeps each bucket's measured step time (an EWMA mean and
a decaying-max tail), which the batcher's early dispatch and shedding
read.
"""
from __future__ import annotations

import threading

import numpy as _np
import torch

from .. import profiler as _prof
from ..base import MXNetError
from ..compile.builder import ProgramBuilder
from ..context import resolve_device

__all__ = ["BucketedProgramCache", "DEFAULT_BUCKETS", "bucket_for"]

DEFAULT_BUCKETS = (1, 4, 8, 16, 32)


def bucket_for(n, buckets):
    """Smallest configured bucket >= n, or n itself when it exceeds the
    largest bucket (an oversized request builds its exact shape, cached
    like a bucket)."""
    if n <= 0:
        raise MXNetError("batch size must be positive, got %d" % n)
    for b in buckets:
        if n <= b:
            return b
    return n


def _spec(v):
    """(shape, dtype name) of a host array or a tensor alike."""
    return (tuple(v.shape), str(v.dtype).replace("torch.", ""))


class BucketedProgramCache:
    """Build-once store of per-bucket programs for one model.

    Parameters
    ----------
    fn : callable(batch_vals, param_vals, aux_vals) -> tuple
        The inference body: ``batch_vals`` maps input names to batch-major
        tensors, ``param_vals``/``aux_vals`` are the weight dicts, read in
        place by every program.
    buckets : tuple of int
        Allowed batch sizes.
    device : torch.device
        Where the programs run (None: the card).
    site : str
        Compile-counter label (the engine passes ``serving.<model>``).
    """

    def __init__(self, fn, buckets=DEFAULT_BUCKETS, device=None,
                 site="serving"):
        if not buckets:
            raise MXNetError("program cache needs at least one bucket")
        self._buckets = tuple(sorted(int(b) for b in buckets))
        if self._buckets[0] <= 0:
            raise MXNetError("buckets must be positive, got %s"
                             % (self._buckets,))
        self._device = resolve_device(device)
        self._builder = ProgramBuilder(fn, site=site, capture=True,
                                       static_argnums=(1, 2))
        self._lock = threading.Lock()
        self._by_key = {}            # (batch spec, weights spec) -> program
        self.compiles = 0            # programs built (ahead of time or not)
        self.hits = 0                # executions served by a built program
        self.misses = 0              # executions that built one first
        # bucket -> [ewma_s, n_samples, tail_s]
        self._step_time = {}

    # ------------------------------------------------------------------
    @property
    def buckets(self):
        return self._buckets

    @property
    def donate(self):
        """True where requests are copied into static input buffers (the
        captured programs), the port's form of buffer donation."""
        return self._device.type == "cuda"

    @property
    def builder(self):
        return self._builder

    def bucket_for(self, n):
        return bucket_for(n, self._buckets)

    # ------------------------------------------------------------------
    # measured step time (the batcher's shed and early-dispatch signal)
    # ------------------------------------------------------------------
    def observe_step_time(self, bucket, seconds):
        """Fold one measured execution time for ``bucket``: EWMA mean
        (alpha 0.3) and a decaying max tail (x0.85 a sample)."""
        seconds = float(seconds)
        if seconds <= 0:
            return
        with self._lock:
            rec = self._step_time.get(bucket)
            if rec is None:
                self._step_time[bucket] = [seconds, 1, seconds]
            else:
                rec[0] += 0.3 * (seconds - rec[0])
                rec[1] += 1
                rec[2] = max(seconds, rec[2] * 0.85)

    def step_time(self, bucket):
        """EWMA mean step time of ``bucket`` in seconds, or None."""
        with self._lock:
            rec = self._step_time.get(bucket)
            return rec[0] if rec is not None else None

    def step_time_tail(self, bucket):
        """Decaying-max step time of ``bucket`` in seconds, or None."""
        with self._lock:
            rec = self._step_time.get(bucket)
            return rec[2] if rec is not None else None

    def step_samples(self, bucket):
        """How many timed executions were folded for ``bucket``."""
        with self._lock:
            rec = self._step_time.get(bucket)
            return rec[1] if rec is not None else 0

    # ------------------------------------------------------------------
    def weights_key(self, param_vals, aux_vals):
        """The key part naming the weights' shapes and dtypes (callers
        that keep it skip recomputing it every request)."""
        return (tuple((k, _spec(v)) for k, v in sorted(param_vals.items())),
                tuple((k, _spec(v)) for k, v in sorted(aux_vals.items())))

    def _get(self, batch_vals, param_vals, aux_vals, count=True,
             weights_key=None):
        key = (tuple((k, _spec(v)) for k, v in sorted(batch_vals.items())),
               weights_key if weights_key is not None
               else self.weights_key(param_vals, aux_vals))
        with self._lock:
            prog = self._by_key.get(key)
        built = False
        if prog is not None:
            _prof.record_compile_hit(self._builder.site)
        else:
            staged = {k: self._on_device(v) for k, v in batch_vals.items()}
            prog, built = self._builder.aot_info(
                staged, param_vals, aux_vals,
                mode="ondemand" if count else "aot")
            with self._lock:
                self._by_key[key] = prog
        with self._lock:
            if built:
                self.compiles += 1
                if count:
                    self.misses += 1
            elif count:
                self.hits += 1
        return prog

    def _on_device(self, v):
        t = torch.from_numpy(_np.ascontiguousarray(v)) \
            if isinstance(v, _np.ndarray) else v
        return t.to(self._device)

    # ------------------------------------------------------------------
    def warmup(self, batch_template, params, aux, buckets=None):
        """Build the program of each bucket ahead of time.

        ``batch_template`` maps input name -> (shape, dtype) with any
        batch size in axis 0; each bucket swaps its own in. A captured
        program is warmed on zeros. Returns the number of programs
        built."""
        n_before = self.compiles
        wkey = self.weights_key(params, aux)
        for b in (buckets or self._buckets):
            batch = {k: torch.zeros((int(b),) + tuple(shape[1:]),
                                    dtype=dtype, device=self._device)
                     for k, (shape, dtype) in batch_template.items()}
            self._get(batch, params, aux, count=False, weights_key=wkey)
        return self.compiles - n_before

    def run(self, batch_vals, param_vals, aux_vals, weights_key=None):
        """Run the bucket program for these shapes (building it on a
        miss). ``batch_vals`` is already padded to a bucket; its arrays
        may be host arrays (copied into the program's static inputs on
        the card) or tensors. Returns fresh output tensors."""
        prog = self._get(batch_vals, param_vals, aux_vals,
                         weights_key=weights_key)
        if prog is self._builder._fn:   # the eager body (CPU or no capture)
            batch_vals = {k: self._on_device(v)
                          for k, v in batch_vals.items()}
            with torch.no_grad():
                return tuple(prog(batch_vals, param_vals, aux_vals))
        return tuple(prog(batch_vals, param_vals, aux_vals))

    def comm_plan(self):
        raise MXNetError("BucketedProgramCache.comm_plan is not yet ported "
                         "(ROADMAP A7)")

    def stats(self):
        with self._lock:
            step_ms = {str(b): round(rec[0] * 1e3, 3)
                       for b, rec in sorted(self._step_time.items())}
            tail_ms = {str(b): round(rec[2] * 1e3, 3)
                       for b, rec in sorted(self._step_time.items())}
        return {"compiles": self.compiles, "hits": self.hits,
                "misses": self.misses,
                "programs": self._builder.program_count(),
                "donate": self.donate, "step_time_ms": step_ms,
                "step_tail_ms": tail_ms}
