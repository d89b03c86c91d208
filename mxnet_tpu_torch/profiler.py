"""Always-on counters of the serving and training paths.

Counterpart of the counter families of ``mxnet_tpu/profiler.py`` that
the port's paths feed: latency histograms (``record_latency`` /
``latency_histogram`` / ``latency_counters`` /
``percentile_from_counts``), the per-kernel roofline records
(``record_kernel_roofline`` / ``kernel_counters``), the stateful-decode
counters (``record_decode_event`` / ``decode_counters``), the per-site
program-build counters that ``compile.builder.ProgramBuilder`` records
(``compile_counters``), the training pipeline's overlap counters
(``record_pipeline_event`` / ``pipeline_counters``: the device prefetch
and the fused step's dispatch and readback), the training supervisor's
(``record_supervisor_event`` / ``supervisor_counters``), the serving
fleet's membership and autoscaler events (``record_fleet_event`` /
``fleet_counters``), and the retry, fault-injection and watchdog counts
the resilience modules record. The keys are the reference's. Plain adds
under one lock, no profiler session.
"""
from __future__ import annotations

import math
import threading

__all__ = ["record_latency", "latency_histogram", "latency_counters",
           "percentile_from_counts",
           "record_kernel_roofline", "kernel_counters",
           "record_decode_event", "decode_counters",
           "record_compile", "record_compile_hit", "compile_counters",
           "record_pipeline_event", "pipeline_counters",
           "record_supervisor_event", "supervisor_counters",
           "record_fleet_event", "fleet_counters",
           "record_retry", "retry_counters",
           "record_fault_injection", "fault_counters",
           "record_watchdog_event", "watchdog_counters"]

_lock = threading.Lock()

# ----------------------------------------------------------------------
# latency histograms: 10 log-spaced buckets per decade from 1 us (1e3 ns)
# to ~17 min (1e12 ns), fixed at import so every snapshot is mergeable.
# Sum and max are exact per key.
# ----------------------------------------------------------------------
_LAT_MIN_EXP = 3
_LAT_MAX_EXP = 12
_LAT_PER_DECADE = 10
_LAT_EDGES_NS = tuple(
    10.0 ** (_LAT_MIN_EXP + i / float(_LAT_PER_DECADE))
    for i in range((_LAT_MAX_EXP - _LAT_MIN_EXP) * _LAT_PER_DECADE + 1))
_latency = {}


def _lat_bucket_index(ns):
    if ns <= _LAT_EDGES_NS[0]:
        return 0
    if ns >= _LAT_EDGES_NS[-1]:
        return len(_LAT_EDGES_NS) - 1
    return min(int(math.ceil((math.log10(ns) - _LAT_MIN_EXP)
                             * _LAT_PER_DECADE)),
               len(_LAT_EDGES_NS) - 1)


def record_latency(key, ns):
    """Record one latency observation (nanoseconds) under ``key``."""
    ns = float(ns)
    if ns < 0:
        return
    idx = _lat_bucket_index(ns)
    with _lock:
        h = _latency.get(key)
        if h is None:
            h = _latency[key] = {
                "counts": [0] * len(_LAT_EDGES_NS),
                "count": 0, "sum_ns": 0.0, "max_ns": 0.0}
        h["counts"][idx] += 1
        h["count"] += 1
        h["sum_ns"] += ns
        h["max_ns"] = max(h["max_ns"], ns)


def latency_histogram(key):
    """Raw cumulative bucket counts for ``key`` (a copy), or None."""
    with _lock:
        h = _latency.get(key)
        return list(h["counts"]) if h else None


def _lat_percentile_ns(h, q):
    """Upper edge (ns) of the bucket where the cumulative count crosses
    ``q``: a percentile that never underestimates."""
    target = q * h["count"]
    cum = 0
    for i, c in enumerate(h["counts"]):
        cum += c
        if cum >= target and c:
            return _LAT_EDGES_NS[i]
    return h["max_ns"]


def percentile_from_counts(counts, q):
    """Upper-bucket-edge percentile in milliseconds from a bucket-count
    list (typically the difference of two :func:`latency_histogram`
    snapshots); None when it holds no samples."""
    total = sum(counts)
    if total <= 0:
        return None
    target = q * total
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= target and c:
            return _LAT_EDGES_NS[i] / 1e6
    return _LAT_EDGES_NS[-1] / 1e6


def latency_counters(reset=False, prefix=None):
    """Snapshot (optionally reset) the latency histograms as key ->
    ``{count, p50_ms, p95_ms, p99_ms, mean_ms, max_ms}``. ``prefix``
    filters the keys; a reset with a prefix clears only those."""
    out = {}
    with _lock:
        for key, h in _latency.items():
            if prefix is not None and not key.startswith(prefix):
                continue
            if not h["count"]:
                continue
            out[key] = {
                "count": h["count"],
                "p50_ms": round(_lat_percentile_ns(h, 0.50) / 1e6, 3),
                "p95_ms": round(_lat_percentile_ns(h, 0.95) / 1e6, 3),
                "p99_ms": round(_lat_percentile_ns(h, 0.99) / 1e6, 3),
                "mean_ms": round(h["sum_ns"] / h["count"] / 1e6, 3),
                "max_ms": round(h["max_ns"] / 1e6, 3)}
        if reset:
            if prefix is None:
                _latency.clear()
            else:
                for key in [k for k in _latency if k.startswith(prefix)]:
                    del _latency[key]
    return out


# ----------------------------------------------------------------------
# per-kernel roofline records: a kernel's measured figure beside its
# ideal one (achieved against peak rate, or bytes against must-move
# bytes), recorded by whoever measured it
# ----------------------------------------------------------------------
_kernels = {}


def record_kernel_roofline(kernel, measured, ideal, unit=""):
    """Record one kernel's measured-vs-ideal pair; the ratio is derived,
    so a later record with a better measurement stays consistent."""
    with _lock:
        _kernels[kernel] = {
            "measured": float(measured), "ideal": float(ideal),
            "unit": unit,
            "measured_vs_ideal": (round(float(measured) / float(ideal), 4)
                                  if ideal else None)}


def kernel_counters(reset=False):
    """Snapshot (optionally reset) the per-kernel roofline records."""
    with _lock:
        out = {k: dict(v) for k, v in _kernels.items()}
        if reset:
            _kernels.clear()
    return out


# ----------------------------------------------------------------------
# stateful-decode counters (serving/decode.py): tokens, steps, occupancy
# (slot_steps / slot_capacity), typed cache-overflow sheds.
# ----------------------------------------------------------------------
_DECODE_ZERO = {"submitted": 0, "served": 0, "shed": 0, "failed": 0,
                "tokens": 0, "prefills": 0, "steps": 0, "slot_steps": 0,
                "slot_capacity": 0, "cache_oom": 0}
_decode = dict(_DECODE_ZERO)


def record_decode_event(**deltas):
    """Accumulate stateful-decode counters (free-form int deltas)."""
    with _lock:
        for k, v in deltas.items():
            _decode[k] = _decode.get(k, 0) + v


def decode_counters(reset=False):
    """Snapshot (optionally reset) the stateful-decode counters."""
    with _lock:
        out = dict(_decode)
        if reset:
            _decode.clear()
            _decode.update(_DECODE_ZERO)
    return out


# ----------------------------------------------------------------------
# program-build counters, per ProgramBuilder site. A "compile" is the
# first sight of a distinct shape/dtype signature, ahead of time (warmup)
# or on demand (first dispatch): for a capturing builder on the card, the
# signature's CUDA-graph capture. A cache hit is a request served by a
# known one (a replay, for a captured program). compile_ms is the wall
# the builds took (a capture's warm run and capture on the card), which
# ModelServer.health() windows between polls.
# ----------------------------------------------------------------------
_COMPILE_ZERO = {"compiles": 0, "compile_ms": 0.0, "aot": 0, "ondemand": 0,
                 "cache_hits": 0}
_compile_total = dict(_COMPILE_ZERO)
_compile_sites = {}


def record_compile(site, aot=True, compile_ms=0.0):
    """Record one new program signature at ``site``, built in
    ``compile_ms`` of wall time."""
    with _lock:
        for d in (_compile_total,
                  _compile_sites.setdefault(site, dict(_COMPILE_ZERO))):
            d["compiles"] += 1
            d["compile_ms"] += float(compile_ms)
            d["aot" if aot else "ondemand"] += 1


def record_compile_hit(site):
    """Record one request served by an already-known signature."""
    with _lock:
        for d in (_compile_total,
                  _compile_sites.setdefault(site, dict(_COMPILE_ZERO))):
            d["cache_hits"] += 1


def compile_counters(reset=False):
    """``{"total": {...}, "sites": {site: {...}}}``."""
    with _lock:
        out = {"total": dict(_compile_total),
               "sites": {k: dict(v) for k, v in _compile_sites.items()}}
        if reset:
            _compile_total.clear()
            _compile_total.update(_COMPILE_ZERO)
            _compile_sites.clear()
    return out


# ----------------------------------------------------------------------
# training-pipeline overlap counters (Module's fused path and
# io_device.DevicePrefetchIter): was the next batch already staged
# (prefetch_hit / prefetch_stall[_ms]), the worker's staging time
# (prefetch_stage_ms), the host time to enqueue a fused step
# (dispatch_ms), and the wait on step i - depth (readback_stall_ms)
# ----------------------------------------------------------------------
_PIPELINE_ZERO = {"steps": 0, "prefetch_hit": 0, "prefetch_stall": 0,
                  "prefetch_stall_ms": 0.0, "prefetch_stage_ms": 0.0,
                  "dispatch_ms": 0.0, "readback_stall_ms": 0.0}
_pipeline = dict(_PIPELINE_ZERO)


def record_pipeline_event(**deltas):
    """Accumulate step-time breakdown counters (free-form deltas)."""
    with _lock:
        for k, v in deltas.items():
            _pipeline[k] = _pipeline.get(k, 0) + v


def pipeline_counters(reset=False):
    """Snapshot (optionally reset) the pipeline overlap counters."""
    with _lock:
        out = dict(_pipeline)
        if reset:
            _pipeline.clear()
            _pipeline.update(_PIPELINE_ZERO)
    return out


# ----------------------------------------------------------------------
# training-supervisor counters (resilience/supervisor.py): steps
# (verdicts observed), bad_steps (skipped), divergences, restarts,
# stalls, scale_backoffs, scale_regrows, resumes
# ----------------------------------------------------------------------
_SUPERVISOR_ZERO = {"steps": 0, "bad_steps": 0, "divergences": 0,
                    "restarts": 0, "stalls": 0, "scale_backoffs": 0,
                    "scale_regrows": 0, "resumes": 0}
_supervisor = dict(_SUPERVISOR_ZERO)


def record_supervisor_event(**deltas):
    """Accumulate training-supervisor counters (free-form int deltas)."""
    with _lock:
        for k, v in deltas.items():
            _supervisor[k] = _supervisor.get(k, 0) + v


def supervisor_counters(reset=False):
    """Snapshot (optionally reset) the training-supervisor counters."""
    with _lock:
        out = dict(_supervisor)
        if reset:
            _supervisor.clear()
            _supervisor.update(_SUPERVISOR_ZERO)
    return out


# ----------------------------------------------------------------------
# serving-fleet counters (serving/pool.py, serving/autoscaler.py): worker
# membership transitions and autoscaler actions
# ----------------------------------------------------------------------
_FLEET_ZERO = {"joins": 0, "rejoins": 0, "suspects": 0, "deads": 0,
               "recoveries": 0, "scale_ups": 0, "scale_downs": 0}
_fleet = dict(_FLEET_ZERO)


def record_fleet_event(event):
    """Count one fleet membership/autoscaler event: "join", "rejoin",
    "suspect", "dead", "recovery", "scale_up", "scale_down"."""
    total_key = {"join": "joins", "rejoin": "rejoins",
                 "suspect": "suspects", "dead": "deads",
                 "recovery": "recoveries", "scale_up": "scale_ups",
                 "scale_down": "scale_downs"}.get(event)
    with _lock:
        if total_key is not None:
            _fleet[total_key] += 1
        else:
            _fleet[event] = _fleet.get(event, 0) + 1


def fleet_counters(reset=False):
    """Snapshot (optionally reset) the serving-fleet counters."""
    with _lock:
        out = dict(_fleet)
        if reset:
            _fleet.clear()
            _fleet.update(_FLEET_ZERO)
    return out


# ----------------------------------------------------------------------
# resilience counters: the retry policy (resilience.retry), injected
# faults (resilience.faults) and watchdog stalls/deaths
# (resilience.watchdog)
# ----------------------------------------------------------------------
_RETRY_ZERO = {"retries": 0, "recoveries": 0, "giveups": 0}
_retry = dict(_RETRY_ZERO)
_WATCHDOG_ZERO = {"stalls": 0, "deaths": 0, "restarts": 0,
                  "stall_recoveries": 0}
_watchdog = dict(_WATCHDOG_ZERO)
_faults = {"injected": 0}


def record_retry(site, outcome):
    """Count one retry-policy event for ``site``: "retry" (a failed
    attempt that will be retried), "recovery" (success after a retry),
    "giveup" (the error surfaced)."""
    total_key = {"retry": "retries", "recovery": "recoveries",
                 "giveup": "giveups"}.get(outcome)
    with _lock:
        if total_key is not None:
            _retry[total_key] += 1
        key = "%s.%s" % (site, outcome)
        _retry[key] = _retry.get(key, 0) + 1


def retry_counters(reset=False):
    """Snapshot (optionally reset) the retry counters: totals plus
    per-site ``<site>.retry`` / ``.recovery`` / ``.giveup`` keys."""
    with _lock:
        out = dict(_retry)
        if reset:
            _retry.clear()
            _retry.update(_RETRY_ZERO)
    return out


def record_fault_injection(site):
    """Count one fired injected fault."""
    with _lock:
        _faults["injected"] += 1
        _faults[site] = _faults.get(site, 0) + 1


def fault_counters(reset=False):
    """Snapshot (optionally reset) injected-fault counts per site."""
    with _lock:
        out = dict(_faults)
        if reset:
            _faults.clear()
            _faults["injected"] = 0
    return out


def record_watchdog_event(name, event):
    """Count one watchdog observation for thread ``name``: "stall",
    "stall_recovered", "death", "restart", "restart_failed"."""
    total_key = {"stall": "stalls", "death": "deaths",
                 "restart": "restarts",
                 "stall_recovered": "stall_recoveries"}.get(event)
    with _lock:
        if total_key is not None:
            _watchdog[total_key] += 1
        key = "%s.%s" % (name, event)
        _watchdog[key] = _watchdog.get(key, 0) + 1


def watchdog_counters(reset=False):
    """Snapshot (optionally reset) the watchdog stall/death counters."""
    with _lock:
        out = dict(_watchdog)
        if reset:
            _watchdog.clear()
            _watchdog.update(_WATCHDOG_ZERO)
    return out
