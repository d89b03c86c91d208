"""Unified retry/backoff: ONE policy for every transient-failure site.

A copy of ``mxnet_tpu/resilience/retry.py`` (the port imports nothing of
the JAX package); no framework code. In the port the training
supervisor's restarts (``train.restart``) and the device prefetch's
staging (``prefetch.stage``) run under it.

* exponential backoff with FULL jitter (each delay is drawn uniformly
  from [0, min(cap, base * 2^attempt)], so decorrelated retries don't
  stampede a recovering dependency);
* a typed retryable classification: by default OS/connection/timeout
  errors plus the framework's explicit :class:`~.faults.TransientError`
  marker retry, everything else surfaces immediately (a genuine bug must
  never be retried into a 3x-slower genuine bug);
* an optional per-call DEADLINE budget: attempts (and their backoff
  sleeps) stop when the budget is spent, whatever the attempt count says;
* always-on observability: every retried attempt, recovery, and give-up
  records into ``profiler.record_retry`` (``profiler.retry_counters()``).

Env defaults: ``MXNET_TPU_RETRY_ATTEMPTS`` (3),
``MXNET_TPU_RETRY_BASE_MS`` (50), ``MXNET_TPU_RETRY_CAP_MS`` (2000).
"""
from __future__ import annotations

import random
import time

from ..base import MXNetError, get_env
from .faults import TransientError

__all__ = ["RetryPolicy", "RETRYABLE_DEFAULT", "TransientError",
           "retry_call"]

# the transient-by-construction classes: I/O and transport hiccups, plus
# the framework's explicit marker. NOT Exception — retrying an arbitrary
# bug just triples its latency.
RETRYABLE_DEFAULT = (OSError, ConnectionError, TimeoutError,
                     InterruptedError, TransientError)


class RetryPolicy:
    """Exponential-backoff-with-full-jitter retry executor.

    Parameters
    ----------
    attempts : int
        Total tries including the first (default
        ``MXNET_TPU_RETRY_ATTEMPTS``, 3).
    base_delay_s, cap_delay_s : float
        Backoff curve: attempt k (0-based failures) sleeps
        ``uniform(0, min(cap, base * 2**k))`` seconds (defaults from
        ``MXNET_TPU_RETRY_BASE_MS`` / ``MXNET_TPU_RETRY_CAP_MS``).
    deadline_s : float, optional
        Wall-clock budget for the WHOLE call (attempts + sleeps). A
        retry whose backoff would cross the deadline is not taken; the
        last error surfaces instead. None: attempts alone bound it.
    retryable : exception class / tuple / callable(exc) -> bool
        What counts as transient (default :data:`RETRYABLE_DEFAULT`).
    site : str
        Counter key for ``profiler.record_retry`` (e.g.
        ``"checkpoint.write"``). None disables recording.
    rng : random.Random, optional
        Jitter source (tests pass a seeded one for determinism).
    """

    def __init__(self, attempts=None, base_delay_s=None, cap_delay_s=None,
                 deadline_s=None, retryable=None, site=None, rng=None):
        if attempts is None:
            attempts = get_env("MXNET_TPU_RETRY_ATTEMPTS", 3, int)
        if base_delay_s is None:
            base_delay_s = get_env("MXNET_TPU_RETRY_BASE_MS", 50.0,
                                   float) / 1000.0
        if cap_delay_s is None:
            cap_delay_s = get_env("MXNET_TPU_RETRY_CAP_MS", 2000.0,
                                  float) / 1000.0
        if int(attempts) < 1:
            raise MXNetError("RetryPolicy needs attempts >= 1, got %s"
                             % attempts)
        self.attempts = int(attempts)
        self.base_delay_s = float(base_delay_s)
        self.cap_delay_s = float(cap_delay_s)
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self.retryable = retryable if retryable is not None \
            else RETRYABLE_DEFAULT
        self.site = site
        self._rng = rng if rng is not None else random.Random()

    # ------------------------------------------------------------------
    def is_retryable(self, exc):
        # non-Exception BaseExceptions (KeyboardInterrupt, SystemExit,
        # GeneratorExit) are NEVER retryable, whatever the predicate
        # says: swallowing a Ctrl-C into backoff sleeps turns an
        # interrupt into a hang
        if not isinstance(exc, Exception):
            return False
        if callable(self.retryable) and not isinstance(self.retryable,
                                                       (type, tuple)):
            return bool(self.retryable(exc))
        return isinstance(exc, self.retryable)

    def backoff_s(self, failure_index):
        """Full-jitter delay after the (0-based) Nth failed attempt."""
        ceiling = min(self.cap_delay_s,
                      self.base_delay_s * (2.0 ** failure_index))
        return self._rng.uniform(0.0, ceiling)

    def _record(self, outcome):
        if self.site is None:
            return
        from .. import profiler as _prof
        _prof.record_retry(self.site, outcome)

    def call(self, fn, *args, **kwargs):
        """Run ``fn(*args, **kwargs)`` under the policy; returns its
        value or re-raises the final error. Records one ``retry`` per
        failed-then-retried attempt, one ``recovery`` when a retried
        call eventually succeeds, one ``giveup`` when it never does."""
        deadline = None if self.deadline_s is None \
            else time.monotonic() + self.deadline_s
        failures = 0
        while True:
            try:
                result = fn(*args, **kwargs)
            except BaseException as e:
                if not self.is_retryable(e) \
                        or failures >= self.attempts - 1:
                    if failures:
                        self._record("giveup")
                    raise
                delay = self.backoff_s(failures)
                if deadline is not None \
                        and time.monotonic() + delay > deadline:
                    # the budget cannot afford another attempt: surface
                    # the real error, not a synthetic timeout
                    self._record("giveup")
                    raise
                failures += 1
                self._record("retry")
                if delay > 0:
                    time.sleep(delay)
                continue
            if failures:
                self._record("recovery")
            return result


def retry_call(fn, *args, site=None, attempts=None, deadline_s=None,
               retryable=None, **kwargs):
    """One-shot convenience: build a policy and run ``fn`` under it."""
    return RetryPolicy(attempts=attempts, deadline_s=deadline_s,
                       retryable=retryable, site=site).call(fn, *args,
                                                            **kwargs)
