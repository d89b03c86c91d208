"""Dynamic micro-batcher — SLA-aware request coalescing for the serving
engine.

Counterpart of ``mxnet_tpu/serving/batcher.py``; its scheduling is pure
Python and copied here. Individual inference requests (each a small batch
of rows) are queued, coalesced up to a max batch / max latency window,
padded to the nearest program-cache bucket, run as ONE program call (a
CUDA-graph replay on the card), and split back per request.

SLA semantics: a request may carry a ``deadline_ms`` budget and a
``priority``. Batch formation is earliest-deadline-first (priority breaks
the tie above EDF), the worker dispatches a partial batch EARLY when the
most urgent queued request's slack approaches the bucket's measured step
time, and requests that can no longer finish inside their budget are
SHED: they fast-fail with the typed :class:`DeadlineExceeded` instead of
occupying a bucket slot. The decode engine and the paged KV cache raise
the same typed shed.

Padding: padded rows never perturb real rows' outputs, because the
serving path runs the graph strictly in inference mode, where every op of
the port is row-independent along the batch axis (BatchNorm normalizes
with its frozen running statistics, softmax, pooling and convolution
reduce only non-batch axes). Padding replicates row 0, which keeps padded
rows inside the real data's range. A convolution library may pick another
algorithm at another batch size, so a padded bucket agrees with an
exact-n forward to rounding (the reference's rtol 1e-5), and with the
eager forward of the same bucket bit for bit.
"""
from __future__ import annotations

import threading
import time

import numpy as _np

from ..base import MXNetError, get_env

__all__ = ["DynamicBatcher", "DeadlineExceeded", "pad_to_bucket",
           "default_max_batch"]


class DeadlineExceeded(MXNetError):
    """Typed shed signal: the request's deadline budget was consumed by
    queue wait (or could never fit its bucket's measured step time), so it
    was fast-failed instead of dispatched. Catch it to count sheds; the
    load shedder is what keeps served-request p99 inside the SLA under
    overload instead of letting every caller collapse together."""


def default_max_batch(buckets):
    """The coalescing cap. `mx.engine.set_bulk_size(N)` is the user knob:
    the reference's bulk size bounded how many engine ops fused into one
    dispatch, and its serving analog is how many queued requests fuse into
    one executable call. 0 (the default) means "no user preference" and
    falls back to the largest configured bucket."""
    from .. import engine as _engine
    bulk = _engine.current_bulk_size()
    return bulk if bulk > 0 else max(buckets)


def pad_to_bucket(arrays, n, bucket):
    """Pad stacked batch-major host arrays from n rows up to `bucket` rows
    by replicating row 0 (see module docstring for why replication).
    Returns the padded dict; no copy when n == bucket."""
    if n == bucket:
        return arrays
    if n > bucket:
        raise MXNetError("cannot pad %d rows into bucket %d" % (n, bucket))
    out = {}
    for name, arr in arrays.items():
        pad = _np.broadcast_to(arr[:1], (bucket - n,) + arr.shape[1:])
        out[name] = _np.concatenate([arr, pad], axis=0)
    return out


_FAR_FUTURE = float("inf")


class _Request:
    __slots__ = ("arrays", "n", "event", "result", "error", "deadline",
                 "priority", "t_submit", "t_dispatch", "t_done",
                 "_callbacks", "_cb_lock")

    def __init__(self, arrays, n, deadline=None, priority=0):
        self.arrays = arrays
        self.n = n
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.deadline = deadline      # absolute time.monotonic() or None
        self.priority = int(priority)
        self.t_submit = time.monotonic()
        self.t_dispatch = None
        self.t_done = None
        self._callbacks = []
        self._cb_lock = threading.Lock()

    # future-like surface (concurrent.futures would drag in an executor
    # pool we don't want; the serving worker IS the scheduler)
    def done(self):
        return self.event.is_set()

    def result_wait(self, timeout=None):
        if not self.event.wait(timeout):
            raise MXNetError("inference request timed out")
        if self.error is not None:
            raise self.error
        return self.result

    def add_done_callback(self, fn):
        """Run ``fn(request)`` when the request resolves (result, error, or
        shed) — immediately if it already has. The ModelServer's
        least-loaded replica accounting rides this."""
        with self._cb_lock:
            if not self.event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def _edf_key(self):
        """Priority-aware earliest-deadline-first order: higher priority
        first, then nearest deadline, then FIFO (deadline-less requests
        sort after every deadline at equal priority)."""
        return (-self.priority,
                self.deadline if self.deadline is not None else _FAR_FUTURE,
                self.t_submit)

    def _finish(self, result=None, error=None, lat_key=None):
        """Resolve exactly once: store the outcome, stamp t_done, record
        latency breakdown (served requests only), wake waiters, fire
        done-callbacks."""
        self.t_done = time.monotonic()
        self.result = result
        self.error = error
        if lat_key is not None and error is None:
            from .. import profiler as _prof
            t_dispatch = self.t_dispatch if self.t_dispatch is not None \
                else self.t_done
            _prof.record_latency(lat_key + ".queue",
                                 (t_dispatch - self.t_submit) * 1e9)
            _prof.record_latency(lat_key + ".device",
                                 (self.t_done - t_dispatch) * 1e9)
            _prof.record_latency(lat_key + ".total",
                                 (self.t_done - self.t_submit) * 1e9)
        with self._cb_lock:
            self.event.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            try:
                fn(self)
            except Exception:
                pass  # an observer callback must never poison the delivery


class DynamicBatcher:
    """Queue + (EDF) coalesce + shed + pad + run + split.

    Parameters
    ----------
    run_batch : callable(dict name->np.ndarray stacked to bucket, n_real)
        Runs one executable call on a bucket-padded batch; returns a list
        of batch-major output arrays (padded rows included — this class
        slices them away per request).
    buckets : tuple of int
        Program-cache buckets; coalesced batches pad up to the smallest
        bucket that fits.
    max_batch : int or None
        Coalescing cap. None -> `default_max_batch(buckets)` (the
        `mx.engine.set_bulk_size` knob, else the largest bucket).
    max_delay_ms : float
        How long the worker waits for more requests before dispatching a
        partial batch. The latency/throughput dial: 0 dispatches
        immediately (lowest latency), a few ms lets concurrent clients
        fuse into full buckets. A queued deadline always overrides the
        window (early dispatch, below).
    step_time : callable(bucket) -> float seconds or None, optional
        The bucket's measured compile-warm MEAN step time (the engine
        feeds the program cache's EWMA here). Drives early dispatch: a
        partial batch goes out when the most urgent request's slack
        shrinks to ``slack_factor`` x step time.
    step_time_tail : callable(bucket) -> float seconds or None, optional
        The bucket's decaying-MAX step time — what the shed-feasibility
        test budgets for. A request at the deadline edge must survive a
        spike (GC pause, scheduler hiccup), not the mean; shedding
        against the mean leaks served requests past the SLA every time
        the edge coincides with a spike. Defaults to ``step_time``.
    slack_factor : float, optional
        Safety multiplier on the measured step time for early dispatch
        (default: MXNET_SERVING_SLACK_FACTOR, 1.5 — absorbs EWMA noise).
    shed_margin : float, optional
        Multiplier on the measured step time for the SHED feasibility
        test (default 1.0: shed only what cannot finish even if
        dispatched now, assuming mean service time). Raise it toward
        ``slack_factor`` when service-time spikes must not leak served
        requests past their deadline — the EWMA tracks the mean, and a
        request dispatched with slack between ``shed_margin x est`` and
        an actual spike resolves late; margin 2.0 absorbs 2x spikes (what
        an SLA benchmark would run). Must stay below ``slack_factor`` or
        shedding preempts every early dispatch.
    lat_key : str, optional
        Profiler latency-histogram key prefix (e.g. ``serving.resnet``);
        served requests record ``.queue``/``.device``/``.total`` under it.
    """

    def __init__(self, run_batch, buckets, max_batch=None, max_delay_ms=2.0,
                 autostart=True, step_time=None, step_time_tail=None,
                 slack_factor=None, shed_margin=1.0, lat_key=None,
                 observe_step=None):
        self._run_batch = run_batch
        self._buckets = tuple(sorted(buckets))
        if max_batch is not None and int(max_batch) <= 0:
            raise MXNetError("max_batch must be positive, got %d" % max_batch)
        # None defers to the LIVE mx.engine bulk knob (read per use in the
        # max_batch property, so `with mx.engine.bulk(N):` scopes work on
        # an already-built engine, matching the documented contract)
        self._max_batch_fixed = int(max_batch) if max_batch is not None \
            else None
        self.max_delay = float(max_delay_ms) / 1000.0
        self._step_time = step_time
        self._step_time_tail = step_time_tail or step_time
        # observe_step(bucket, seconds): called with each batch's FULL
        # dispatch->delivery wall time (concat, pad, stage, run, split,
        # resolve). The engine feeds the program cache's EWMA/tail from
        # here for the batcher path — the estimate must cover everything
        # a request at the deadline edge actually waits for, not just
        # the program call.
        self._observe_step = observe_step
        self._slack_factor = float(
            slack_factor if slack_factor is not None
            else get_env("MXNET_SERVING_SLACK_FACTOR", 1.5, float))
        self._shed_margin = float(shed_margin)
        self._lat_key = lat_key
        self._queue = []
        self._cv = threading.Condition()
        self._stopped = False
        self._worker = None
        self._hb = None          # watchdog heartbeat of the live worker
        self._autostart = autostart
        self.batches_run = 0
        self.requests = 0
        self.rows = 0
        self.padded_rows = 0
        self.served = 0            # requests resolved with a result
        self.shed = 0              # requests fast-failed (DeadlineExceeded)
        self.early_dispatches = 0  # partial batches pushed out by slack
        self.idle_wakeups = 0      # idle-wait returns (event-driven: only
        #                            submit/stop wake it — never a timer)

    @property
    def max_batch(self):
        """Live coalescing cap: the explicit constructor value, else the
        current `mx.engine.set_bulk_size` knob, else the largest bucket —
        always clamped to the top bucket (a cap above it would coalesce
        to arbitrary totals, each a fresh exact-shape program)."""
        cap = self._max_batch_fixed
        if cap is None:
            cap = default_max_batch(self._buckets)
        return min(cap, max(self._buckets))

    # ------------------------------------------------------------------
    def _est_step(self, rows, tail=False):
        """Measured compile-warm step time (seconds) of the bucket `rows`
        pads into — the EWMA mean, or the decaying-max tail when
        ``tail`` (the shed test's budget); 0.0 while unmeasured (SLA
        checks then degrade to pure queue-wait shedding, never block on
        a missing estimate)."""
        fn = self._step_time_tail if tail else self._step_time
        if fn is None:
            return 0.0
        from .program_cache import bucket_for
        try:
            est = fn(bucket_for(rows, self._buckets))
        except Exception:
            return 0.0
        return float(est) if est else 0.0

    def submit(self, arrays, deadline_ms=None, priority=0):
        """Enqueue one request (dict name -> batch-major np array, all with
        the same row count) and return a future-like handle.

        ``deadline_ms`` is the request's end-to-end latency budget
        (queue wait + device step). A budget the bucket's measured step
        time alone already exceeds is shed IMMEDIATELY — the request
        could never be served in time even on an idle engine."""
        ns = {a.shape[0] for a in arrays.values()}
        if len(ns) != 1:
            raise MXNetError("request inputs disagree on batch size: %s"
                             % {k: v.shape for k, v in arrays.items()})
        n = ns.pop()
        deadline = None
        if deadline_ms is not None:
            if deadline_ms <= 0:
                raise MXNetError("deadline_ms must be positive, got %s"
                                 % (deadline_ms,))
            deadline = time.monotonic() + float(deadline_ms) / 1000.0
        req = _Request(arrays, n, deadline=deadline, priority=priority)
        if deadline is not None:
            # submit-time shed judges against the MEAN step: a budget the
            # typical step alone exceeds can never be met even idle (the
            # spiky tail estimate only refines the selection-time edge)
            est = self._est_step(n)
            if est and self._shed_margin * est > float(deadline_ms) / 1000.0:
                with self._cv:
                    if self._stopped:  # same contract as the queue path
                        raise MXNetError("batcher is stopped")
                    self.requests += 1  # counted: accounting must sum
                    self.shed += 1
                req._finish(error=DeadlineExceeded(
                    "request shed at submit: deadline budget %.1fms is "
                    "below the bucket's measured step time %.1fms"
                    % (float(deadline_ms), est * 1e3)))
                return req
        with self._cv:
            if self._stopped:
                raise MXNetError("batcher is stopped")
            self._queue.append(req)
            self.requests += 1
            self._cv.notify()
        if self._autostart:
            self._ensure_worker()
        return req

    def start(self):
        """Start the background worker without submitting (tests use this
        to observe a purely idle worker)."""
        self._ensure_worker()

    def _ensure_worker(self):
        if self._worker is None or not self._worker.is_alive():
            from ..resilience.watchdog import watchdog as _watchdog
            with self._cv:
                if self._worker is None or not self._worker.is_alive():
                    self._worker = threading.Thread(
                        target=self._loop, name="mx-serving-batcher",
                        daemon=True)
                    # each (re)started worker registers its own heartbeat;
                    # a crashed predecessor is surfaced by the monitor as
                    # a death, and this path is what restarts it
                    self._hb = _watchdog().register(
                        "batcher:%s" % (self._lat_key or "serving"),
                        thread=self._worker)
                    self._worker.start()

    def stop(self):
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        if self._worker is not None and self._worker.is_alive():
            self._worker.join(timeout=5.0)

    # ------------------------------------------------------------------
    def _shed_locked(self, req, now, est):
        """Fail one selected-but-infeasible request with the typed shed
        error. Called under self._cv (delivery fires done-callbacks under
        the cv; callbacks must never re-enter the batcher)."""
        self.shed += 1
        budget_ms = (req.deadline - req.t_submit) * 1000.0
        waited_ms = (now - req.t_submit) * 1000.0
        req._finish(error=DeadlineExceeded(
            "request shed: deadline budget %.1fms, queue wait %.1fms, "
            "bucket step est %.1fms"
            % (budget_ms, waited_ms, est * 1e3)))

    def _take_group(self, wait):
        """Pop a coalescable set of queued requests totalling <= max_batch
        rows, earliest-deadline-first: the queue is kept in EDF order
        (priority above deadline above FIFO) and the selection takes the
        EDF prefix first, then a first-fit scan over the rest to fill the
        residual capacity. Requests are independent (each resolves its own
        future), so out-of-order dispatch is safe — and without the fill
        scan a mixed 1..32 trace strands ~20% of every bucket as padding.

        With ``wait``, blocks event-driven while idle (submit/stop are the
        ONLY wakeups — no timer churn), then holds the coalescing window
        open up to max_delay, dispatching EARLY when the most urgent
        deadline's slack shrinks to slack_factor x the bucket's measured
        step time."""
        with self._cv:
            if wait:
                # idle: fully event-driven — an untimed wait that only
                # submit() or stop() can wake (the 100 ms timer this
                # replaces was a busy-wake floor: ten wakeups/second
                # forever on an idle engine)
                while not self._queue and not self._stopped:
                    self._cv.wait()
                    self.idle_wakeups += 1
                deadline = time.monotonic() + self.max_delay
                while not self._stopped:
                    now = time.monotonic()
                    if not self._queue:
                        if now >= deadline:
                            break
                        self._cv.wait(timeout=deadline - now)
                        continue
                    if sum(r.n for r in self._queue) >= self.max_batch:
                        break
                    timeout = deadline - now
                    urgent = min(
                        (r.deadline for r in self._queue
                         if r.deadline is not None), default=None)
                    if urgent is not None:
                        est = self._est_step(
                            min(sum(r.n for r in self._queue),
                                self.max_batch))
                        slack = urgent - now - self._slack_factor * est
                        if slack <= 0:
                            # the most urgent request cannot afford the
                            # rest of the window: dispatch the partial
                            # batch NOW
                            self.early_dispatches += 1
                            break
                        timeout = min(timeout, slack)
                    if timeout <= 0 or self.max_delay == 0:
                        break
                    self._cv.wait(timeout=timeout)
            # EDF selection: sort is stable, so equal-key requests keep
            # FIFO order (deadline-less traffic behaves exactly as the
            # pre-SLA batcher did). Timsort on the mostly-sorted queue is
            # near-linear. Shedding is LAZY — a request is judged as it
            # reaches the selection front, not by sweeping the whole
            # backlog every formation: a 2000-deep overload queue would
            # otherwise pay O(queue) est() calls per batch under the cv,
            # and that sweep (not the model) becomes the serving tier's
            # critical path.
            now = time.monotonic()

            def _infeasible(req):
                """(shed?, est): spike budget is shed_margin x the
                decaying-max step, CLAMPED to 60% of the request's own
                budget — the tail is a conservative spike estimate, and
                letting a pathological stall observation exceed whole
                budgets would flip the shedder from bounding p99 to
                refusing all work. Queue wait stays the primary shed
                signal; the tail refines the
                edge."""
                est = min(
                    self._est_step(req.n, tail=True) * self._shed_margin,
                    0.6 * (req.deadline - req.t_submit))
                return now + est > req.deadline, est

            self._queue.sort(key=_Request._edf_key)
            group, total = [], 0
            shed_engaged = False
            i = 0
            while i < len(self._queue) and total < self.max_batch:
                req = self._queue[i]
                if req.deadline is not None:
                    shed, est = _infeasible(req)
                    if shed:
                        # queue wait consumed the budget (or the step
                        # cannot fit what remains): fast-fail instead of
                        # serving late
                        self._queue.pop(i)
                        self._shed_locked(req, now, est)
                        shed_engaged = True
                        continue
                if total + req.n <= self.max_batch:
                    self._queue.pop(i)
                    group.append(req)
                    total += req.n
                else:
                    i += 1
            if shed_engaged:
                # Shed-order fairness: the selection
                # scan judges requests front-to-back in EDF order — i.e.
                # HIGHEST priority first — and stops once the batch
                # fills. Left alone, that sheds a high-priority request
                # at the front while an equal-slack LOWER-priority
                # request deeper in the queue escapes judgment this
                # formation (and may then survive outright when the
                # decaying-max estimate relaxes before it is next
                # judged). When shedding engages, finish the job: sweep
                # the REMAINING queue from the back — lowest priority /
                # farthest deadline first — and shed everything
                # infeasible by the same test at the same `now`, so
                # victims at equal slack are always taken
                # lowest-priority-first and a shed notification never
                # waits on a later formation. The sweep runs ONLY in
                # formations that already shed (overload), so the lazy
                # O(batch) argument above still holds for healthy
                # traffic; each swept victim leaves the queue, so the
                # cost amortizes to one judgment per shed request.
                for j in range(len(self._queue) - 1, -1, -1):
                    req = self._queue[j]
                    if req.deadline is None:
                        continue
                    shed, est = _infeasible(req)
                    if shed:
                        self._queue.pop(j)
                        self._shed_locked(req, now, est)
            if not group and self._queue:
                # head request alone exceeds max_batch (e.g. a small
                # set_bulk_size with large warmed buckets): dispatch it
                # SOLO rather than reject — the cap bounds coalescing,
                # not request size, and sync predict has no cap either
                req = self._queue.pop(0)
                group, total = [req], req.n
            return group, total

    def _run_group(self, group, total):
        from .program_cache import bucket_for
        t_dispatch = time.monotonic()
        for req in group:
            req.t_dispatch = t_dispatch
        try:
            stacked = {}
            for name in group[0].arrays:
                stacked[name] = (group[0].arrays[name] if len(group) == 1
                                 else _np.concatenate(
                                     [r.arrays[name] for r in group], axis=0))
            bucket = bucket_for(total, self._buckets)
            padded = pad_to_bucket(stacked, total, bucket)
            outs = self._run_batch(padded, total)
            self.batches_run += 1
            self.rows += total
            self.padded_rows += bucket - total
            row = 0
            for req in group:
                result = [o[row:row + req.n] for o in outs]
                row += req.n
                self.served += 1
                req._finish(result=result, lat_key=self._lat_key)
            if self._observe_step is not None:
                self._observe_step(bucket,
                                   time.monotonic() - t_dispatch)
        except BaseException as e:  # deliver the failure to every waiter
            for req in group:
                if not req.done():
                    req._finish(error=MXNetError(
                        "serving batch failed: %s" % e))

    def _loop(self):
        hb = self._hb
        while True:
            group, total = self._take_group(wait=True)
            if group:
                if hb is not None:
                    hb.beat()   # busy only across the dispatch — the
                    #             idle cv wait is supposed to be silent
                self._run_group(group, total)
                if hb is not None:
                    hb.idle()
                continue
            with self._cv:
                if self._stopped and not self._queue:
                    # close ONLY on the clean stop path: an unexpected
                    # crash must leave the heartbeat open so the
                    # watchdog monitor records the death (a closed
                    # heartbeat is indistinguishable from stop())
                    if hb is not None:
                        hb.close()
                    return

    def flush(self):
        """Synchronously drain the queue in coalesced groups on the CALLING
        thread (deterministic — used by tests and by engine shutdown; no
        latency window is applied, but expired deadlines still shed)."""
        while True:
            group, total = self._take_group(wait=False)
            if not group:
                return
            self._run_group(group, total)

    def stats(self):
        return {"batches_run": self.batches_run, "requests": self.requests,
                "rows": self.rows, "padded_rows": self.padded_rows,
                "max_batch": self.max_batch, "served": self.served,
                "shed": self.shed,
                "early_dispatches": self.early_dispatches,
                "idle_wakeups": self.idle_wakeups}
