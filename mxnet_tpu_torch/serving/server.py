"""ModelServer — the multi-model, multi-version serving registry.

Counterpart of ``mxnet_tpu/serving/server.py``:

* **registry** — any number of named models, each with any number of
  versions, routed by ``(model, version)`` with a default-version alias
  per model (``predict("resnet", x)`` serves the default; an explicit
  ``version=`` pins one).
* **replicas** — a version may run N replicas, each a full
  `InferenceEngine` (its own captured bucket programs and batcher);
  replicas past the card count are colocated on card 0. Dispatch picks
  the LEAST-LOADED replica by live in-flight count, routes around a
  replica whose circuit breaker is open, and resubmits a failed dispatch
  to another replica.
* **zero-downtime rollover** — :meth:`rollover` copies new weights into
  every replica's captured weight tensors in place (no capture, no new
  program; each answer is computed from the old set or the new one) and
  re-points the version label and the default alias.
* **hedging** — with ``MXNET_SERVING_HEDGE_MS`` (or ``hedge_ms=``) a
  request whose dispatch outlives the hedge delay is duplicated onto a
  second replica; the first answer wins.
* **stateful decode** — :meth:`register_decode` / :meth:`submit_decode`
  pin a sequence to one `DecodeEngine` replica by ``crc32`` of its pin.
* **observability** — per-model latency histograms
  (``profiler.latency_counters(prefix="serving.<model>.")``) plus
  per-replica engine stats.

    server = ModelServer()
    server.register("resnet", sym, args, aux, replicas=2,
                    warmup_shapes={"data": (32, 3, 224, 224)})
    out = server.predict("resnet", {"data": batch})
    fut = server.predict_async("resnet", {"data": rows}, deadline_ms=15)
    server.rollover("resnet", new_args, version=2)   # zero captures
    server.stats()

Not yet ported, and raising: ``reload_from`` (checkpoints, ROADMAP A8).
The fleet layer (remote replicas, ``health()`` for an autoscaler) comes
with the front door (ROADMAP A5).

Lock discipline: the registry lock guards the model/version tables and the
in-flight counters ONLY — engine construction, warmup, predict dispatch
and weight staging all run outside it. Request done-callbacks (the
in-flight decrement) may fire under a batcher's condition variable, so no
ModelServer method may touch a batcher while holding the registry lock.
"""
from __future__ import annotations

import logging
import threading
import time

import torch

from ..base import MXNetError, get_env
from ..context import resolve_device
from .batcher import DeadlineExceeded
from .engine import InferenceEngine

__all__ = ["ModelServer"]


class _Breaker:
    """Per-replica circuit breaker.

    ``threshold`` consecutive dispatch failures OPEN the breaker: the
    replica stops receiving traffic (dispatch routes around it through
    the existing least-loaded path), so one sick replica costs capacity,
    never correctness. After ``cooldown_s`` the breaker goes HALF-OPEN:
    exactly one probe request is admitted — success closes the breaker,
    failure re-opens it for another cooldown. Sheds (DeadlineExceeded)
    are load, not sickness: they touch neither the failure streak nor a
    success reset.

    All state mutations run under the ModelServer registry lock."""

    __slots__ = ("threshold", "cooldown_s", "failures", "state",
                 "opened_at", "opens", "probing")

    def __init__(self, threshold, cooldown_s):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.failures = 0
        self.state = "closed"
        self.opened_at = None
        self.opens = 0
        self.probing = False

    def available(self, now):
        if self.state == "closed":
            return True
        if self.state == "open":
            return now - self.opened_at >= self.cooldown_s
        return not self.probing  # half-open: one probe at a time

    def note_dispatch(self, now):
        """Called when dispatch picks this replica (post-`available`)."""
        if self.state == "open" and now - self.opened_at >= self.cooldown_s:
            self.state = "half_open"
            self.probing = True
        elif self.state == "half_open":
            self.probing = True

    def on_success(self):
        self.failures = 0
        self.probing = False
        if self.state != "closed":
            self.state = "closed"
            self.opened_at = None

    def on_neutral(self):
        """A dispatch that produced NO health verdict (a shed, or a
        hedge slot handed back unused) releases the half-open probe
        slot without closing or re-opening — the next dispatch becomes
        the probe. Without this, a half-open replica whose probe
        request sheds keeps ``probing=True`` forever and never receives
        normal traffic again (permanent capacity loss while the server
        looks healthy)."""
        self.probing = False

    def on_failure(self, now):
        self.failures += 1
        self.probing = False
        if self.state == "half_open" or (self.state == "closed"
                                         and self.failures
                                         >= self.threshold):
            self.state = "open"
            self.opened_at = now
            self.opens += 1
            return True  # newly opened (caller records the counter)
        if self.state == "open":
            self.opened_at = now  # forced dispatch failed: restart cooldown
        return False

    def snapshot(self):
        return {"state": self.state, "consecutive_failures": self.failures,
                "opens": self.opens}


class _Replica:
    __slots__ = ("engine", "inflight", "breaker")

    def __init__(self, engine, breaker):
        self.engine = engine
        self.inflight = 0
        self.breaker = breaker


class _ModelEntry:
    __slots__ = ("versions", "default_version", "counters")

    def __init__(self):
        self.versions = {}        # label -> list of _Replica
        self.default_version = None
        # request accounting (the chaos contract: submitted must equal
        # served + shed + failed, with failed == 0 while any healthy
        # replica remains). Hedges are INTERNAL duplicates: they count
        # under "hedges"/"hedge_wins" only — the loser's result is
        # discarded, so submitted == served + shed + failed holds with
        # every submitted request counted exactly once.
        self.counters = {"submitted": 0, "served": 0, "shed": 0,
                         "failed": 0, "dispatch_retries": 0,
                         "breaker_opens": 0, "hedges": 0, "hedge_wins": 0}


class _ServerRequest:
    """Server-level future: proxies a replica-local batcher request and
    RESUBMITS on dispatch failure.

    A failed dispatch means the request was NEVER served (the batcher
    resolves a failed group with an error, not a result), so resubmitting
    to a different replica cannot double-serve — exactly-once by
    construction. Sheds (`DeadlineExceeded`) pass through: the deadline
    is global to the request, not per-replica. Retried attempts carry the
    REMAINING deadline budget, and a budget exhausted mid-retry resolves
    as a shed rather than burning a hopeless dispatch.

    Same future surface as the batcher's `_Request` (``done()`` /
    ``result_wait(timeout)`` / ``add_done_callback(fn)``), so callers and
    the accounting treat both alike.

    Hedging: when the server carries a `_Hedger`, a request
    whose primary dispatch outlives the per-(model, bucket) hedge delay
    is DUPLICATED onto a second available replica. Resolution is
    first-wins (``_resolve`` is exactly-once), the loser's outcome is
    discarded internally, and both dispatches still release their
    replica slots and feed their breakers — hedges never double-count
    in the served/shed/failed invariant."""

    __slots__ = ("_server", "_name", "_version", "_data", "_priority",
                 "_deadline", "_retries_left", "_tried", "_event",
                 "_cb_lock", "_callbacks", "result", "error", "attempts",
                 "_t_submit", "_inner", "_hedged", "_primary_rep",
                 "_claimed")

    def __init__(self, server, name, version, data, deadline_ms, priority,
                 retries):
        self._server = server
        self._name = name
        self._version = version
        self._data = data
        self._priority = priority
        self._deadline = None if deadline_ms is None \
            else time.monotonic() + float(deadline_ms) / 1000.0
        self._retries_left = retries
        self._tried = set()
        self._event = threading.Event()
        self._cb_lock = threading.Lock()
        self._callbacks = []
        self.result = None
        self.error = None
        self.attempts = 0
        self._t_submit = time.monotonic()
        self._inner = None    # the WINNING replica-local request (timing)
        self._hedged = False  # at most one hedge per request
        self._primary_rep = None
        self._claimed = False  # exactly-once resolution guard

    # latency surface, proxied from the resolving attempt (t_submit is
    # the server-level submit — queue wait spans resubmits too)
    @property
    def t_submit(self):
        return self._t_submit

    @property
    def t_dispatch(self):
        return self._inner.t_dispatch if self._inner is not None else None

    @property
    def t_done(self):
        return self._inner.t_done if self._inner is not None else None

    # -- future surface ------------------------------------------------
    def done(self):
        return self._event.is_set()

    def result_wait(self, timeout=None):
        if not self._event.wait(timeout):
            raise MXNetError("inference request timed out")
        if self.error is not None:
            raise self.error
        return self.result

    def add_done_callback(self, fn):
        with self._cb_lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def _resolve(self, result=None, error=None, inner=None):
        """Exactly-once resolution: the FIRST caller wins (and is the
        only one that counts into served/shed/failed); a hedge loser's
        call is a no-op. Returns True when this call resolved.

        The outcome is counted BETWEEN claiming the resolution and
        waking waiters: a caller returning from ``result_wait`` must
        observe its own request already counted (gates
        read the counters right after the last future resolves)."""
        with self._cb_lock:
            if self._claimed:
                return False
            self._claimed = True
            self.result = result
            self.error = error
            if inner is not None:
                self._inner = inner
        outcome = "served" if error is None else (
            "shed" if isinstance(error, DeadlineExceeded) else "failed")
        self._server._count(self._name, outcome)
        with self._cb_lock:
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            try:
                fn(self)
            except Exception:
                pass  # an observer must never poison the delivery path
        return True

    # -- dispatch ------------------------------------------------------
    def _remaining_ms(self):
        if self._deadline is None:
            return None
        return (self._deadline - time.monotonic()) * 1000.0

    def _attempt(self):
        """Acquire a replica and submit; raises on synchronous submit
        failure (the caller decides whether that surfaces or resolves)."""
        deadline_ms = self._remaining_ms()
        if deadline_ms is not None and deadline_ms <= 0.0:
            # the budget expired between submission and this attempt (a
            # sub-millisecond remainder, or scheduling delay): that is
            # overload, and
            # it resolves as the TYPED shed — handing a negative budget
            # to the batcher would raise and mislabel it a failure
            self._resolve(error=DeadlineExceeded(
                "request shed: deadline budget consumed before dispatch"))
            return
        rep = self._server._acquire(self._name, self._version,
                                    exclude=self._tried)
        self.attempts += 1
        self._primary_rep = rep
        try:
            fut = rep.engine.predict_async(self._data,
                                           deadline_ms=deadline_ms,
                                           priority=self._priority)
        except BaseException:
            self._server._complete(rep, "failure", self._name)
            raise
        fut.add_done_callback(
            lambda inner, rep=rep: self._on_done(rep, inner))
        hedger = self._server._hedger
        if hedger is not None and not self._hedged:
            hedger.arm(self)

    def _hedge(self):
        """Fire one hedge dispatch (the hedger's timer thread): duplicate
        the still-unresolved request onto a second available replica.
        The hedge NEVER touches the primary attempt — first resolution
        wins, and a hedge that sheds or fails is simply discarded (the
        primary's own retry machinery stays in charge)."""
        with self._cb_lock:
            # claim the one hedge slot atomically: a retry re-arms the
            # hedger, so two timer entries for this request can fire in
            # the same batch — only one may dispatch. The _tried
            # snapshot rides the same lock _on_done mutates under (a
            # concurrent add() during the copy would raise
            # mid-iteration and silently cost the hedge).
            if self._claimed or self._hedged:
                return
            self._hedged = True
            exclude = set(self._tried)
        remaining = self._remaining_ms()
        if remaining is not None and remaining <= 0.0:
            return
        if self._primary_rep is not None:
            exclude.add(self._primary_rep)
        try:
            rep = self._server._acquire(self._name, self._version,
                                        exclude=exclude)
        except BaseException:
            return  # a hedge is optional: the primary attempt owns the outcome
        if rep in exclude:
            # no SECOND replica is actually available (forced-probe
            # fallback handed the primary back): a hedge onto the same
            # queue buys nothing — release the slot, breaker-neutral
            self._server._complete(rep, "shed")
            return
        self._server._count(self._name, "hedges")
        try:
            fut = rep.engine.predict_async(self._data,
                                           deadline_ms=remaining,
                                           priority=self._priority)
        except BaseException:
            self._server._complete(rep, "failure", self._name)
            return
        fut.add_done_callback(
            lambda inner, rep=rep: self._on_done(rep, inner, hedge=True))

    def _on_done(self, rep, inner, hedge=False):
        err = inner.error
        if err is None:
            self._server._complete(rep, "success", self._name)
            if self._resolve(result=inner.result, inner=inner) and hedge:
                self._server._count(self._name, "hedge_wins")
            return
        if isinstance(err, DeadlineExceeded):
            # load, not sickness: neutral for the breaker
            self._server._complete(rep, "shed", self._name)
            if not hedge:
                # a hedge's shed is discarded — the primary (or its
                # retries) still owns this request's outcome
                self._resolve(error=err)
            return
        self._server._complete(rep, "failure", self._name)
        with self._cb_lock:
            self._tried.add(rep)   # paired with _hedge's snapshot
        if hedge or self.done():
            return  # hedge losers never resubmit; primary owns retries
        if self._retries_left <= 0:
            self._resolve(error=err)
            return
        remaining = self._remaining_ms()
        if remaining is not None and remaining <= 0.0:
            self._resolve(error=DeadlineExceeded(
                "request shed: deadline budget consumed by a failed "
                "dispatch (%s)" % err))
            return
        self._retries_left -= 1
        self._server._count(self._name, "dispatch_retries")
        try:
            self._attempt()
        except BaseException as e:  # retries exhaust replicas / stopped
            self._resolve(error=e)


def _request_rows(data):
    """Best-effort row count of one request (the hedge-delay bucket
    key); None when the payload shape is unrecognizable."""
    try:
        if isinstance(data, dict):
            data = next(iter(data.values()))
        elif isinstance(data, (list, tuple)):
            data = data[0]
        return int(data.shape[0])
    except Exception:
        return None


class _Hedger:
    """Tail-latency hedging (the classic tied-request /
    hedged-request defense against straggler replicas — one slow or
    half-dead host must cost a duplicate dispatch, not the p99).

    A single lazy timer thread holds a min-heap of (fire_at, request).
    When a request's primary dispatch is still unresolved at its hedge
    delay, `_ServerRequest._hedge` duplicates it onto a second available
    replica; first resolution wins and the loser is discarded
    internally (never double-counted — see `_ServerRequest`).

    The hedge delay is per (model, bucket): ``hedge_ms`` fixes it
    globally (``MXNET_SERVING_HEDGE_MS`` > 0); with auto-derivation
    (``MXNET_SERVING_HEDGE_MS=0``) it is ``factor`` x the LARGER of the
    model's device-latency histogram p95 (`profiler.latency_counters`,
    the signal that already exists) and the request bucket's measured
    step-time tail, floored at ``min_ms`` — so hedges fire on genuine
    stragglers, not on the expected service time. Exists ONLY when
    hedging is configured: the default serving path never builds this
    object, starts this thread, or touches this heap."""

    def __init__(self, server, fixed_ms, factor, min_ms):
        self._server = server
        self._fixed_ms = fixed_ms      # None => derive from p95
        self._factor = float(factor)
        self._min_ms = float(min_ms)
        self._cv = threading.Condition()
        self._heap = []                # (fire_at, seq, request)
        self._seq = 0
        self._stop_evt = threading.Event()
        self._thread = None
        self._delay_cache = {}         # (model, rows) -> (expiry, s)
        self._hist_prev = {}           # model -> device-histogram snapshot

    # -- delay derivation ---------------------------------------------
    def delay_s(self, model, rows):
        if self._fixed_ms is not None:
            return self._fixed_ms / 1e3
        # cache key on (model, rows): rows -> bucket is deterministic,
        # so a cache hit skips BOTH the histogram walk and the
        # registry-lock bucket/tail lookup — the whole point of the
        # cache on a per-request arm path
        key = (model, rows)
        now = time.monotonic()
        cached = self._delay_cache.get(key)
        if cached is not None and cached[0] > now:
            return cached[1]
        bucket, tail_s = self._server._local_bucket_tail(model, rows)
        from .. import profiler as _prof
        # WINDOWED device p95 (delta since this hedger's last
        # derivation): a cumulative percentile would let one past
        # straggler episode ratchet the delay up for the rest of the
        # process lifetime, after which no hedge ever fires again. A
        # window too thin to trust (< 16 samples) keeps the previous
        # delay; the first derivation uses the full history it has.
        dev_key = "serving.%s.device" % model
        counts = _prof.latency_histogram(dev_key)
        p95_ms = None
        if counts is not None:
            prev = self._hist_prev.get(model)
            if prev is None:
                self._hist_prev[model] = counts
                p95_ms = _prof.percentile_from_counts(counts, 0.95)
            else:
                delta = [c - p for c, p in zip(counts, prev)]
                if sum(delta) >= 16:
                    self._hist_prev[model] = counts
                    p95_ms = _prof.percentile_from_counts(delta, 0.95)
                elif cached is not None:
                    # thin window: extend the previous delay's life
                    self._delay_cache[key] = (now + 1.0, cached[1])
                    return cached[1]
                else:
                    p95_ms = _prof.percentile_from_counts(counts, 0.95)
        base_ms = max(p95_ms or 0.0,
                      (tail_s or 0.0) * 1e3)
        delay_ms = max(self._min_ms, self._factor * base_ms)
        # 1s cache: percentile extraction walks histogram buckets and
        # must not run once per request under load. Bounded: arbitrary
        # client-chosen row counts must not grow the dict forever
        if len(self._delay_cache) >= 512:
            self._delay_cache.clear()
        self._delay_cache[key] = (now + 1.0, delay_ms / 1e3)
        return delay_ms / 1e3

    # -- arming --------------------------------------------------------
    def arm(self, req):
        fire_at = time.monotonic() + self.delay_s(
            req._name, _request_rows(req._data))
        with self._cv:
            if self._stop_evt.is_set():
                return
            import heapq
            self._seq += 1
            heapq.heappush(self._heap, (fire_at, self._seq, req))
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, name="mx-serving-hedge",
                    daemon=True)
                self._thread.start()
            self._cv.notify()

    def stop(self):
        self._stop_evt.set()
        with self._cv:
            self._cv.notify_all()
        thread = self._thread
        if thread is not None and thread.is_alive():
            thread.join(timeout=5.0)

    # -- timer loop ----------------------------------------------------
    def _loop(self):
        import heapq
        from ..resilience.watchdog import watchdog as _watchdog
        hb = _watchdog().register("serving:hedger",
                                  thread=threading.current_thread())
        try:
            while not self._stop_evt.is_set():
                due = []
                with self._cv:
                    now = time.monotonic()
                    while self._heap and self._heap[0][0] <= now:
                        due.append(heapq.heappop(self._heap)[2])
                    if not due:
                        hb.idle()
                        timeout = 0.5 if not self._heap else \
                            min(0.5, self._heap[0][0] - now)
                        self._cv.wait(timeout=max(timeout, 1e-3))
                        continue
                hb.beat()
                # fire OUTSIDE the heap lock (a hedge dispatch stages
                # request arrays onto a device) and
                # OFF this thread: a remote-replica hedge is a blocking
                # socket send, and one backpressured worker must stall
                # ITS hedge, not every hedge behind it in the heap.
                # Hedges are straggler-rate events; a short-lived thread
                # each is cheap
                for req in due:
                    if req.done():
                        continue
                    threading.Thread(
                        target=self._fire_one, args=(req,),
                        name="mx-serving-hedge-fire",
                        daemon=True).start()
        finally:
            hb.close()

    @staticmethod
    def _fire_one(req):
        try:
            req._hedge()
        except Exception as e:
            logging.warning("serving hedge dispatch failed (primary "
                            "still owns the request): %s", e)


def _replica_ctxs(base, replicas):
    """One device per replica, striped over the cards of the base
    device's type; replicas past the card count are colocated on card 0
    (each with its own weights, programs and batcher). CPU replicas all
    share the CPU."""
    if replicas == 1 or base.type != "cuda":
        return [base] * replicas
    n = torch.cuda.device_count()
    return [torch.device("cuda", i if i < n else 0)
            for i in range(replicas)]


class ModelServer:
    """Host many named model/version entries, each a set of per-device
    `InferenceEngine` replicas; route by ``(model, version)`` with a
    default-version alias; swap weights live with zero captures."""

    def __init__(self, breaker_threshold=None, breaker_cooldown_ms=None,
                 dispatch_retries=None, hedge_ms=None, hedge_factor=None,
                 hedge_min_ms=None):
        self._lock = threading.Lock()
        self._models = {}
        self._decode = {}     # decode model name -> [DecodeEngine]
        self._stopped = False
        # tail-latency hedging: OFF unless configured. The env is read
        # once here, the hedger (and its timer thread) only exists when
        # hedging is on, and the unhedged dispatch path pays one
        # `is None` check. hedge_ms=False forces it off regardless of the
        # env; None defers to the env; 0 = auto.
        if hedge_ms is False:
            hedge_ms = None
        elif hedge_ms is None:
            hedge_ms = get_env("MXNET_SERVING_HEDGE_MS", None, float)
        if hedge_ms is None:
            self._hedger = None
        else:
            if hedge_factor is None:
                hedge_factor = get_env("MXNET_SERVING_HEDGE_FACTOR",
                                       2.0, float)
            if hedge_min_ms is None:
                hedge_min_ms = get_env("MXNET_SERVING_HEDGE_MIN_MS",
                                       10.0, float)
            self._hedger = _Hedger(
                self, fixed_ms=(float(hedge_ms) if hedge_ms > 0 else None),
                factor=hedge_factor, min_ms=hedge_min_ms)
        # graceful-degradation knobs: N consecutive dispatch failures
        # open a replica's breaker, a cooldown later one half-open probe
        # re-admits it; failed dispatches resubmit to a different replica
        # up to `dispatch_retries` times
        if breaker_threshold is None:
            breaker_threshold = get_env("MXNET_SERVING_BREAKER_THRESHOLD",
                                        3, int)
        if breaker_cooldown_ms is None:
            breaker_cooldown_ms = get_env(
                "MXNET_SERVING_BREAKER_COOLDOWN_MS", 1000.0, float)
        if dispatch_retries is None:
            dispatch_retries = get_env("MXNET_SERVING_DISPATCH_RETRIES",
                                       2, int)
        if breaker_threshold < 1:
            raise MXNetError("breaker_threshold must be >= 1, got %s"
                             % breaker_threshold)
        self._breaker_threshold = int(breaker_threshold)
        self._breaker_cooldown_s = float(breaker_cooldown_ms) / 1000.0
        self._dispatch_retries = max(0, int(dispatch_retries))

    # ------------------------------------------------------------------
    # registration
    # ------------------------------------------------------------------
    def register(self, name, symbol, arg_params, aux_params=None,
                 version=1, ctx=None, replicas=None, default=None,
                 warmup_shapes=None, **engine_kwargs):
        """Build and register one model version.

        ``replicas`` (default: ``MXNET_SERVING_REPLICAS``, 1) runs the
        version as that many replicas on the cards of the base device's
        type, colocated on card 0 past the card count: every replica
        stages its own weights and owns its own captured programs and
        batcher; dispatch is least-loaded. ``ctx`` None is the card.
        ``default`` controls the default-version alias: the FIRST version
        registered for a model becomes the default unless a later
        ``register``/:meth:`set_default_version` says otherwise. ``warmup_shapes``
        builds (captures) every bucket on every replica before traffic.
        Remaining kwargs reach the `InferenceEngine` (buckets,
        max_delay_ms, default_deadline_ms, ...). Returns the version
        label."""
        if replicas is None:
            replicas = int(get_env("MXNET_SERVING_REPLICAS", 1, int))
        if replicas < 1:
            raise MXNetError("replicas must be >= 1, got %d" % replicas)
        if isinstance(ctx, (list, tuple)):
            ctxs = [resolve_device(c) for c in ctx]
        else:
            ctxs = _replica_ctxs(resolve_device(ctx), replicas)
        engines = [InferenceEngine(symbol, arg_params, aux_params,
                                   ctx=c, name=name, **engine_kwargs)
                   for c in ctxs]
        if warmup_shapes:
            for eng in engines:
                eng.warmup(warmup_shapes)
        return self.register_engines(name, engines, version=version,
                                     default=default)

    def register_engines(self, name, engines, version=1, default=None):
        """Register pre-built engine(s) as one model version (accepts a
        single `InferenceEngine` or a list — the replica set)."""
        if isinstance(engines, InferenceEngine):
            engines = [engines]
        if not engines:
            raise MXNetError("register: need at least one engine")
        for i, eng in enumerate(engines):
            eng.replica = i   # fault-spec matcher + breaker identity
        reps = [_Replica(e, _Breaker(self._breaker_threshold,
                                     self._breaker_cooldown_s))
                for e in engines]
        with self._lock:
            if self._stopped:
                raise MXNetError("ModelServer is stopped")
            entry = self._models.get(name)
            if entry is None:
                entry = self._models[name] = _ModelEntry()
            if version in entry.versions:
                raise MXNetError(
                    "model %r version %r is already registered — rollover "
                    "or unregister it first" % (name, version))
            entry.versions[version] = reps
            if default or entry.default_version is None:
                entry.default_version = version
        return version

    def unregister(self, name, version=None):
        """Remove one version (or, with ``version=None``, the whole
        model). Removed engines are stopped; a removed default re-points
        to the newest remaining version."""
        with self._lock:
            entry = self._models.get(name)
            if entry is None:
                raise MXNetError("unknown model %r" % name)
            if version is None:
                removed = [r for reps in entry.versions.values()
                           for r in reps]
                del self._models[name]
            else:
                if version not in entry.versions:
                    raise MXNetError("model %r has no version %r"
                                     % (name, version))
                removed = entry.versions.pop(version)
                if not entry.versions:
                    del self._models[name]
                elif entry.default_version == version:
                    # newest remaining = most recently registered (dict
                    # insertion order) — label types are caller-chosen
                    # (ints, strings, checkpoint steps), so no value
                    # ordering is assumed
                    entry.default_version = next(reversed(entry.versions))
        for rep in removed:
            rep.engine.stop()

    # ------------------------------------------------------------------
    # stateful decode
    # ------------------------------------------------------------------
    def register_decode(self, name, engine):
        """Register a :class:`~.decode.DecodeEngine` replica under
        ``name``. Decode is the STATEFUL serving path: a sequence's KV
        cache lives on one replica for its whole life, so dispatch pins
        by sequence id and the hedger never sees this path — hedging a
        decode request would start a divergent twin with its own cache
        instead of cutting tail latency."""
        with self._lock:
            if self._stopped:
                raise MXNetError("ModelServer is stopped")
            self._decode.setdefault(name, []).append(engine)

    def unregister_decode(self, name):
        """Remove (and stop) every decode replica under ``name``."""
        with self._lock:
            engines = self._decode.pop(name, None)
        if engines is None:
            raise MXNetError("unknown decode model %r" % name)
        for eng in engines:
            eng.stop()

    def decode_models(self):
        with self._lock:
            return sorted(self._decode)

    def decode_engine(self, name, replica=0):
        with self._lock:
            engines = self._decode.get(name)
            if not engines:
                raise MXNetError("unknown decode model %r (registered: %s)"
                                 % (name, sorted(self._decode)))
            return engines[replica]

    def submit_decode(self, name, tokens, pin=None, **kw):
        """Submit one sequence for decode; returns the engine's
        :class:`~.decode.DecodeStream`.

        ``pin`` is the stable sequence key (e.g. the request id): the
        replica is chosen by hash of the pin, so every
        resubmit/resume of the same sequence lands on the replica that
        holds its KV state. No hedging, no failover mid-sequence —
        replaying from the prefix is the client's recovery story, not
        the dispatcher's."""
        with self._lock:
            engines = self._decode.get(name)
            if not engines:
                raise MXNetError("unknown decode model %r (registered: %s)"
                                 % (name, sorted(self._decode)))
            if pin is not None:
                import zlib
                idx = zlib.crc32(str(pin).encode("utf-8")) % len(engines)
            else:
                loads = [e.stats() for e in engines]
                idx = min(range(len(engines)),
                          key=lambda i: (loads[i]["active"]
                                         + loads[i]["waiting"]))
            engine = engines[idx]
        return engine.submit(tokens, **kw)

    def decode_stats(self):
        """Per-decode-model engine stats (counters, KV occupancy,
        program family sizes)."""
        with self._lock:
            snapshot = {name: list(engines)
                        for name, engines in self._decode.items()}
        return {name: [eng.stats() for eng in engines]
                for name, engines in snapshot.items()}

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------
    def models(self):
        with self._lock:
            return sorted(self._models)

    def versions(self, name):
        with self._lock:
            entry = self._models.get(name)
            if entry is None:
                raise MXNetError("unknown model %r" % name)
            return sorted(entry.versions, key=str)

    def default_version(self, name):
        with self._lock:
            entry = self._models.get(name)
            if entry is None:
                raise MXNetError("unknown model %r" % name)
            return entry.default_version

    def set_default_version(self, name, version):
        """Atomically re-point the model's default-version alias."""
        with self._lock:
            entry = self._models.get(name)
            if entry is None:
                raise MXNetError("unknown model %r" % name)
            if version not in entry.versions:
                raise MXNetError("model %r has no version %r"
                                 % (name, version))
            entry.default_version = version

    def engine(self, name, version=None, replica=0):
        """One replica's engine (introspection/tests — dispatch goes
        through :meth:`predict`/:meth:`predict_async`)."""
        with self._lock:
            reps = self._resolve_locked(name, version)[1]
            return reps[replica].engine

    def _resolve_locked(self, name, version):
        entry = self._models.get(name)
        if entry is None:
            raise MXNetError("unknown model %r (registered: %s)"
                             % (name, sorted(self._models)))
        label = version if version is not None else entry.default_version
        reps = entry.versions.get(label)
        if reps is None:
            raise MXNetError("model %r has no version %r (has: %s)"
                             % (name, label, sorted(entry.versions,
                                                    key=str)))
        return label, reps

    def _acquire(self, name, version, exclude=()):
        """Pick the least-loaded AVAILABLE replica and count the request
        in-flight (the counter is what 'least-loaded' means — live queue
        depth, not a stale round-robin).

        Availability is the circuit breaker's verdict: open-breaker
        replicas are routed around; a replica whose cooldown has elapsed
        is admitted as a single half-open probe. ``exclude`` (the
        resubmit path) removes replicas this request already failed on.
        When NOTHING is available — every replica open/excluded — the
        least-loaded replica is dispatched anyway (forced probe):
        degraded capacity must never become a self-inflicted full
        outage."""
        now = time.monotonic()
        with self._lock:
            _, reps = self._resolve_locked(name, version)
            avail = [r for r in reps
                     if r not in exclude and r.breaker.available(now)]
            if not avail:
                avail = [r for r in reps if r.breaker.available(now)] \
                    or list(reps)
            rep = min(avail, key=lambda r: r.inflight)
            rep.breaker.note_dispatch(now)
            rep.inflight += 1
            return rep

    def _complete(self, rep, outcome, name=None):
        """One dispatch finished on `rep`: release the in-flight slot and
        feed the breaker. `outcome`: "success" | "failure" | "shed"
        (sheds are overload, breaker-neutral — but they DO release a
        half-open probe slot, see `_Breaker.on_neutral`)."""
        with self._lock:
            rep.inflight -= 1
            if outcome == "success":
                rep.breaker.on_success()
            elif outcome == "shed":
                rep.breaker.on_neutral()
            elif outcome == "failure":
                if rep.breaker.on_failure(time.monotonic()):
                    logging.warning(
                        "serving breaker OPEN for %s replica %s after %d "
                        "consecutive failures",
                        rep.engine.name, rep.engine.replica,
                        rep.breaker.failures)
                    if name is not None:
                        entry = self._models.get(name)
                        if entry is not None:
                            entry.counters["breaker_opens"] += 1

    def _count(self, name, key, n=1):
        with self._lock:
            entry = self._models.get(name)
            if entry is not None and key in entry.counters:
                entry.counters[key] += n

    def _local_bucket_tail(self, name, rows):
        """(bucket, step-tail seconds) for a request of ``rows`` rows
        from the first replica's program cache — the hedger's per-bucket
        signal; (None, None) when nothing has measured anything."""
        try:
            with self._lock:
                _, reps = self._resolve_locked(name, None)
                engines = [r.engine for r in reps]
        except MXNetError:
            return None, None
        for eng in engines:
            cache = getattr(eng, "_cache", None)
            if cache is None:
                continue
            try:
                bucket = cache.bucket_for(rows) if rows else None
                tail = cache.step_time_tail(bucket) \
                    if bucket is not None else None
            except MXNetError:
                return None, None   # rows above the top bucket
            return bucket, tail
        return None, None

    def predict(self, name, data, version=None):
        """Synchronous inference on the (model, version)'s least-loaded
        available replica (default version when ``version`` is None). A
        replica failure feeds its breaker and retries on a different
        replica up to the server's ``dispatch_retries``. Counts into the
        same per-model accounting as the async path (stats()'s
        submitted == served + shed + failed invariant covers BOTH
        surfaces)."""
        with self._lock:
            self._resolve_locked(name, version)  # unknown model/version
            #                                      surfaces before counting
        self._count(name, "submitted")
        tried = set()
        last_err = None
        for _attempt in range(self._dispatch_retries + 1):
            rep = self._acquire(name, version, exclude=tried)
            try:
                out = rep.engine.predict(data)
            except BaseException as e:
                self._complete(rep, "failure", name)
                tried.add(rep)
                last_err = e
                if _attempt < self._dispatch_retries:
                    self._count(name, "dispatch_retries")
                continue
            self._complete(rep, "success", name)
            self._count(name, "served")
            return out
        self._count(name, "failed")
        raise last_err

    def predict_async(self, name, data, version=None, deadline_ms=None,
                      priority=0):
        """Queue onto the least-loaded available replica's micro-batcher;
        returns a future-like request handle (see
        `InferenceEngine.predict_async` for the deadline/priority SLA
        semantics). A replica stays counted in-flight until its dispatch
        resolves; a FAILED dispatch (replica death, device error — not a
        shed) resubmits to a different replica with the remaining
        deadline budget, so one sick replica degrades capacity, never
        correctness (exactly-once: a failed dispatch never produced a
        result)."""
        req = _ServerRequest(self, name, version, data, deadline_ms,
                             priority, self._dispatch_retries)
        req._attempt()   # synchronous submit errors propagate to caller
        self._count(name, "submitted")
        return req

    # ------------------------------------------------------------------
    # zero-downtime rollover
    # ------------------------------------------------------------------
    def rollover(self, name, arg_params, aux_params=None, version=None):
        """Swap the DEFAULT version's weights on every replica and
        (optionally) relabel it ``version`` — atomically re-pointing the
        default alias.

        Zero captures: each replica copies the new values into the weight
        tensors its captured programs read, in stream order between
        replays (`InferenceEngine.update_params`), so an answer is
        computed from the old set or the new one. Returns the serving
        version label."""
        with self._lock:
            label, reps = self._resolve_locked(name, None)
        # per-replica isolation: one failing replica must not abort the
        # fan-out mid-swap; the failure surfaces as a typed error after
        # the loop (no relabel), and a retry re-runs the idempotent swap
        failures = []
        for rep in reps:
            try:
                rep.engine.update_params(arg_params, aux_params)
            except Exception as e:
                failures.append("replica %s: %s: %s"
                                % (rep.engine.replica,
                                   type(e).__name__, e))
        if failures:
            raise MXNetError(
                "rollover of %r reached %d/%d replicas — failed on: %s "
                "(weights that DID swap stay swapped; retry re-runs the "
                "idempotent fan-out)"
                % (name, len(reps) - len(failures), len(reps),
                   "; ".join(failures)))
        if version is None or version == label:
            return label
        with self._lock:
            entry = self._models.get(name)
            if entry is None or entry.versions.get(label) is not reps:
                raise MXNetError(
                    "model %r changed during rollover — relabel aborted "
                    "(weights on the live replicas DID swap)" % name)
            if version in entry.versions:
                raise MXNetError("model %r already has a version %r"
                                 % (name, version))
            entry.versions[version] = entry.versions.pop(label)
            if entry.default_version == label:
                entry.default_version = version
        return version

    def reload_from(self, name, directory, poll_interval=None):
        raise MXNetError("ModelServer.reload_from (checkpoints) is not yet "
                         "ported (ROADMAP A8)")

    # ------------------------------------------------------------------
    # lifecycle / observability
    # ------------------------------------------------------------------
    def stop(self):
        """Stop every registered engine (queued async requests drain
        first — the batcher's stop contract)."""
        with self._lock:
            self._stopped = True
            engines = [rep.engine for entry in self._models.values()
                       for reps in entry.versions.values()
                       for rep in reps]
            engines.extend(e for engs in self._decode.values()
                           for e in engs)
            self._decode.clear()
        if self._hedger is not None:
            self._hedger.stop()
        for eng in engines:
            eng.stop()

    def stats(self):
        """Per-model serving surface: default version, per-version
        per-replica engine stats (+ live in-flight), and the model's
        latency histograms (queue/device/total p50/p95/p99)."""
        from .. import profiler as _prof
        with self._lock:
            snapshot = {
                name: (entry.default_version,
                       {label: list(reps)
                        for label, reps in entry.versions.items()},
                       dict(entry.counters))
                for name, entry in self._models.items()}
        out = {}
        for name, (default, versions, counters) in snapshot.items():
            vstats = {}
            for label, reps in versions.items():
                vstats[str(label)] = [
                    dict(rep.engine.stats(), inflight=rep.inflight,
                         ctx=str(rep.engine.device),
                         breaker=rep.breaker.snapshot())
                    for rep in reps]
            out[name] = {
                "default_version": default,
                "versions": vstats,
                # server-level request accounting: submitted ==
                # served + shed + failed (the chaos-suite invariant)
                "counters": counters,
                # trailing dot: "serving.res" must not absorb
                # "serving.resnet.*"
                "latency": _prof.latency_counters(
                    prefix="serving.%s." % name),
                # program-build accounting for this model's engines:
                # captures (ahead of time or on demand) and replays
                "compile": _prof.compile_counters()["sites"].get(
                    "serving.%s" % name, {})}
        return out
