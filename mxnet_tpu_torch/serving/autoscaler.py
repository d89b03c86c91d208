"""Autoscaler — the control loop that polls ``ModelServer.health()``,
"the autoscaling signal", and launches or retires fleet workers.

Counterpart of ``mxnet_tpu/serving/autoscaler.py``.

Control law (deliberately boring — a serving autoscaler must be
predictable before it is clever):

* **signal**: the worst per-model ``queue_wait_p95_ms`` plus the
  WINDOWED shed rate (sheds since the previous tick over submissions
  since the previous tick — the cumulative ratio `health()` reports
  would keep echoing an overload long after it ended);
* **scale up** when queue-wait p95 exceeds ``up_queue_ms`` OR the
  windowed shed rate exceeds ``up_shed_rate`` for ``hysteresis``
  consecutive ticks; **scale down** when p95 sits under
  ``down_queue_ms`` with zero window sheds for ``hysteresis`` ticks —
  hysteresis means one GC pause never births a worker and one quiet
  tick never kills one;
* **cooldown** after every action: a freshly launched worker needs
  warmup + join + probe before it absorbs load, and judging the signal
  mid-transition oscillates;
* **hard floor**: scale-down is refused below ``min_workers`` AND
  whenever any served model would drop to <= 1 available replica —
  scale-down can never drain the last live replica.

The actuator is a pluggable **launcher** (``launch()`` /
``terminate_one()`` / ``alive_count()``): `LocalProcessLauncher` spawns
real `python -m mxnet_tpu_torch.serving.worker` processes on this host
(with ``subprocess.Popen`` only: nothing is forked from a process whose
CUDA context is up), the zero→one story for a single box; cluster
schedulers implement the same three methods.
"""
from __future__ import annotations

import logging
import subprocess
import sys
import threading
import time

from ..base import MXNetError

__all__ = ["Autoscaler", "LocalProcessLauncher"]

_log = logging.getLogger(__name__)

#: the module `LocalProcessLauncher` runs as each worker process
WORKER_MODULE = "mxnet_tpu_torch.serving.worker"


class LocalProcessLauncher:
    """Spawn/reap `ReplicaWorker` OS processes on the local host.

    Parameters
    ----------
    gateway : str
        The FleetPool control address (``"host:port"``) workers join.
    builder : str
        ``module:function`` import spec the worker CLI resolves to a
        warmed ModelServer.
    env : dict, optional
        Extra environment for spawned workers (merged over os.environ —
        e.g. a PYTHONPATH carrying the builder module, or
        ``MXNET_SERVING_AUTH_KEY``).
    """

    def __init__(self, gateway, builder, env=None, python=None,
                 extra_args=()):
        self._gateway = gateway
        self._builder = builder
        self._env = env
        self._python = python or sys.executable
        self._extra_args = list(extra_args)
        self._lock = threading.Lock()
        self._procs = []
        self.launches = 0
        self.terminations = 0

    def launch(self):
        import os
        env = dict(os.environ)
        if self._env:
            env.update(self._env)
        proc = subprocess.Popen(
            [self._python, "-m", WORKER_MODULE,
             "--gateway", str(self._gateway),
             "--builder", self._builder, "--port", "0"]
            + self._extra_args, env=env)
        with self._lock:
            self._procs.append(proc)
            self.launches += 1
        _log.info("autoscaler: launched worker pid %d", proc.pid)
        return proc

    def alive(self):
        with self._lock:
            self._procs = [p for p in self._procs if p.poll() is None]
            return list(self._procs)

    def alive_count(self):
        return len(self.alive())

    def terminate_one(self):
        """SIGTERM the newest live worker (its front door drains before
        exit). Returns the process or None when nothing is running.

        The SIGTERM path is crash-equivalent from the gateway's view:
        the worker's control channel drops and the pool fast-suspects it
        on the next monitor tick, so at most one tick's dispatches ride
        the breaker/resubmit path (never lost — the exactly-once
        machinery owns them). A launcher co-located with the `FleetPool`
        can do strictly better by calling ``pool.drain_worker(id)``
        first (detach from routing, THEN drain)."""
        alive = self.alive()
        if not alive:
            return None
        proc = alive[-1]
        proc.terminate()
        with self._lock:
            self.terminations += 1
        _log.info("autoscaler: terminating worker pid %d", proc.pid)
        return proc

    def stop_all(self, timeout=15.0):
        for proc in self.alive():
            proc.terminate()
        deadline = time.monotonic() + timeout
        for proc in self.alive():
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()


class Autoscaler:
    """Poll a health signal, drive a launcher (see module docstring).

    ``health_fn`` is any zero-arg callable returning the
    `ModelServer.health()` shape — ``server.health`` in-process,
    ``pool.health`` for the merged fleet view, or ``client.health`` over
    the wire from a separate controller process."""

    def __init__(self, health_fn, launcher, min_workers=0, max_workers=4,
                 interval_s=2.0, up_queue_ms=100.0, down_queue_ms=10.0,
                 up_shed_rate=0.02, hysteresis=2, cooldown_s=15.0,
                 model=None):
        if max_workers < min_workers:
            raise MXNetError("max_workers (%s) < min_workers (%s)"
                             % (max_workers, min_workers))
        if hysteresis < 1:
            raise MXNetError("hysteresis must be >= 1")
        self._health_fn = health_fn
        self._launcher = launcher
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self._interval_s = float(interval_s)
        self._up_queue_ms = float(up_queue_ms)
        self._down_queue_ms = float(down_queue_ms)
        self._up_shed_rate = float(up_shed_rate)
        self._hysteresis = int(hysteresis)
        self._cooldown_s = float(cooldown_s)
        self._model = model
        self._stop_evt = threading.Event()
        self._thread = None
        self._up_streak = 0
        self._down_streak = 0
        self._last_action_at = None
        self._prev_totals = None      # (submitted, shed) at previous tick
        self.actions = []             # [(wall time, "up"/"down"), ...]
        self.stats = {"ticks": 0, "scale_ups": 0, "scale_downs": 0,
                      "held_floor": 0, "held_cooldown": 0,
                      "signal_errors": 0}

    # ------------------------------------------------------------------
    def start(self):
        if self._thread is not None:
            raise MXNetError("autoscaler already started")
        self._thread = threading.Thread(target=self._loop,
                                        name="mx-serving-autoscale",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop_evt.set()
        thread = self._thread
        if thread is not None and thread.is_alive() \
                and thread is not threading.current_thread():
            thread.join(timeout=10.0)

    def _loop(self):
        from ..resilience.watchdog import watchdog as _watchdog
        hb = _watchdog().register("serving:autoscaler",
                                  thread=threading.current_thread())
        try:
            while not self._stop_evt.wait(self._interval_s):
                hb.beat()
                try:
                    self.tick()
                except Exception as e:
                    self.stats["signal_errors"] += 1
                    _log.warning("autoscaler: tick failed (%s) — holding "
                                 "current scale", e)
                hb.idle()
        finally:
            hb.close()

    # ------------------------------------------------------------------
    def _signal(self):
        """(worst queue p95 ms or None, windowed shed rate, windowed
        submissions, min available replicas, health dict) for the
        models under control. q95 None means NO latency signal this
        window — e.g. another health() poller consumed the window on a
        loaded gateway — which must read as "hold", never as "idle"."""
        health = self._health_fn()
        models = health.get("models", {})
        if self._model is not None:
            models = {k: v for k, v in models.items() if k == self._model}
        q95 = None
        submitted = shed = 0
        min_avail = None
        for m in models.values():
            mq = m.get("queue_wait_p95_ms")
            if mq is not None:
                q95 = mq if q95 is None else max(q95, mq)
            submitted += m.get("submitted", 0)
            shed += m.get("shed", 0)
            avail = m.get("replicas_available")
            if avail is not None:
                min_avail = avail if min_avail is None \
                    else min(min_avail, avail)
        prev = self._prev_totals
        self._prev_totals = (submitted, shed)
        if prev is None:
            window_rate, d_sub = 0.0, 0
        else:
            d_sub = submitted - prev[0]
            d_shed = shed - prev[1]
            window_rate = (d_shed / float(d_sub)) if d_sub > 0 else 0.0
        return q95, window_rate, d_sub, min_avail, health

    def tick(self, now=None):
        """One control evaluation. Returns "up", "down", or None — what
        tests assert on directly (the background loop just calls
        this)."""
        now = time.monotonic() if now is None else now
        self.stats["ticks"] += 1
        q95, shed_rate, d_sub, min_avail, _health = self._signal()
        overloaded = ((q95 is not None and q95 > self._up_queue_ms)
                      or shed_rate > self._up_shed_rate)
        # idle needs POSITIVE evidence: a measured-low queue wait, or a
        # window with genuinely zero submissions. q95=None with traffic
        # flowing (another poller consumed the latency window) is "no
        # signal" and holds the current scale
        idle = shed_rate <= 0.0 and (
            (q95 is not None and q95 < self._down_queue_ms)
            or (q95 is None and d_sub == 0))
        self._up_streak = self._up_streak + 1 if overloaded else 0
        self._down_streak = self._down_streak + 1 if idle else 0
        in_cooldown = (self._last_action_at is not None
                       and now - self._last_action_at < self._cooldown_s)
        alive = self._launcher.alive_count()
        if alive < self.min_workers and not in_cooldown:
            # below the configured baseline (a worker died and nothing
            # replaced it): restore capacity regardless of load — this
            # is the recovery half of the chaos gate
            self._launcher.launch()
            self._act(now, "up")
            _log.warning("autoscaler: below min_workers (%d < %d) — "
                         "launched replacement", alive, self.min_workers)
            return "up"
        if overloaded and self._up_streak >= self._hysteresis:
            if in_cooldown:
                self.stats["held_cooldown"] += 1
                return None
            if alive >= self.max_workers:
                return None
            self._launcher.launch()
            self._act(now, "up")
            _log.info("autoscaler: scale UP (queue p95 %s ms, shed "
                      "rate %.3f, workers %d -> %d)",
                      "%.1f" % q95 if q95 is not None else "n/a",
                      shed_rate, alive, alive + 1)
            return "up"
        if idle and self._down_streak >= self._hysteresis:
            if in_cooldown:
                self.stats["held_cooldown"] += 1
                return None
            if alive <= self.min_workers or alive <= 0 \
                    or (min_avail is not None and min_avail <= 1):
                # the HARD FLOOR: min_workers, and never a termination
                # that could drain the last available replica of any
                # served model
                self.stats["held_floor"] += 1
                return None
            if self._launcher.terminate_one() is not None:
                self._act(now, "down")
                _log.info("autoscaler: scale DOWN (idle: queue p95 "
                          "%s ms; workers %d -> %d)",
                          "%.1f" % q95 if q95 is not None else "n/a",
                          alive, alive - 1)
                return "down"
        return None

    def _act(self, now, direction):
        from .. import profiler as _prof
        self._last_action_at = now
        self._up_streak = self._down_streak = 0
        key = "scale_ups" if direction == "up" else "scale_downs"
        self.stats[key] += 1
        self.actions.append((time.time(), direction))
        _prof.record_fleet_event("scale_up" if direction == "up"
                                 else "scale_down")
