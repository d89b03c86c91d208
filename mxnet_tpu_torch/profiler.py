"""Always-on counters of the serving path.

Counterpart of the counter families of ``mxnet_tpu/profiler.py`` that
decode serving feeds: latency histograms (``record_latency`` /
``latency_histogram``), the stateful-decode
counters (``record_decode_event`` / ``decode_counters``), the per-site
program-build counters that ``compile.builder.ProgramBuilder`` records
(``compile_counters``), and the fault-injection and watchdog counts the
resilience modules record. Plain adds under one lock, no profiler session.
"""
from __future__ import annotations

import math
import threading

__all__ = ["record_latency", "latency_histogram",
           "record_decode_event", "decode_counters",
           "record_compile", "record_compile_hit", "compile_counters",
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
# program-build counters, per ProgramBuilder site. The port runs program
# bodies eagerly, so a "compile" is the first sight of a distinct
# shape/dtype signature: ahead of time (warmup) or on demand (first
# dispatch), and a cache hit is a warmup re-request of a known one.
# ----------------------------------------------------------------------
_COMPILE_ZERO = {"compiles": 0, "aot": 0, "ondemand": 0, "cache_hits": 0}
_compile_total = dict(_COMPILE_ZERO)
_compile_sites = {}


def record_compile(site, aot=True):
    """Record one new program signature at ``site``."""
    with _lock:
        for d in (_compile_total,
                  _compile_sites.setdefault(site, dict(_COMPILE_ZERO))):
            d["compiles"] += 1
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
# resilience counters: injected faults (resilience.faults) and watchdog
# stalls/deaths (resilience.watchdog)
# ----------------------------------------------------------------------
_WATCHDOG_ZERO = {"stalls": 0, "deaths": 0, "restarts": 0,
                  "stall_recoveries": 0}
_watchdog = dict(_WATCHDOG_ZERO)
_faults = {"injected": 0}


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
