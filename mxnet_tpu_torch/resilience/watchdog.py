"""Thread watchdog — heartbeat supervision for every background thread.

A copy of ``mxnet_tpu/resilience/watchdog.py`` (the port imports nothing
of the JAX package); in the port's serving slice the decode engine's loop
thread is the supervised worker. One monitor watches every registered
daemon thread and offers a restart policy:

* worker loops ``register`` a :class:`Heartbeat` and call ``beat()``
  each iteration; before blocking on a work-wait they call ``idle()``
  (an idle thread is *supposed* to be silent — only a BUSY heartbeat
  that stops beating is a stall);
* a single lazy daemon monitor scans all heartbeats every
  ``MXNET_TPU_WATCHDOG_INTERVAL_S``: a busy heartbeat silent longer than
  its stall timeout records a ``stall`` (once per episode, recovery
  recorded when it beats again); a dead thread that never ``close()``d
  records a ``death`` and applies the heartbeat's policy — ``restart``
  (a supplied factory rebuilds the worker) or ``surface`` (log +
  counter; the default, because most workers here already surface
  through their own sticky sentinel / ensure-worker paths);
* everything lands in ``profiler.watchdog_counters()`` — always-on adds,
  same family as the pipeline/retry counters.

``MXNET_TPU_WATCHDOG=0`` disables supervision entirely: ``register``
hands back a no-op heartbeat and no monitor thread ever starts.
"""
from __future__ import annotations

import logging
import threading
import time

from ..base import env_flag, get_env

__all__ = ["Watchdog", "Heartbeat", "watchdog"]

_log = logging.getLogger(__name__)


class Heartbeat:
    """Per-thread beat handle. ``beat()`` marks the thread busy-and-alive
    (one attribute store — cheap enough for every loop iteration);
    ``idle()`` marks it deliberately waiting; ``close()`` retires it
    (clean exits are not deaths)."""

    __slots__ = ("name", "thread", "stall_timeout", "on_death", "restart",
                 "last_beat", "busy", "closed", "stalled", "deaths",
                 "stalls", "restarts")

    def __init__(self, name, thread=None, stall_timeout=None,
                 on_death="surface", restart=None):
        self.name = name
        self.thread = thread
        self.stall_timeout = stall_timeout
        self.on_death = on_death
        self.restart = restart
        self.last_beat = time.monotonic()
        self.busy = False
        self.closed = False
        self.stalled = False
        self.deaths = 0
        self.stalls = 0
        self.restarts = 0

    def beat(self):
        self.last_beat = time.monotonic()
        self.busy = True

    def idle(self):
        self.last_beat = time.monotonic()
        self.busy = False

    def close(self):
        self.closed = True
        self.busy = False


class _NullHeartbeat(Heartbeat):
    """What ``register`` returns when supervision is off — same surface,
    no monitor behind it."""

    def beat(self):
        pass

    def idle(self):
        pass

    def close(self):
        pass


class Watchdog:
    """The monitor. One instance supervises any number of heartbeats; the
    module-level :func:`watchdog` accessor holds the process singleton.

    ``interval_s`` — scan period (default
    ``MXNET_TPU_WATCHDOG_INTERVAL_S``, 5s). ``stall_timeout_s`` — default
    busy-silence threshold for heartbeats that don't set their own
    (default ``MXNET_TPU_WATCHDOG_STALL_S``, 30s)."""

    def __init__(self, interval_s=None, stall_timeout_s=None, enabled=None):
        if interval_s is None:
            interval_s = get_env("MXNET_TPU_WATCHDOG_INTERVAL_S", 5.0, float)
        if stall_timeout_s is None:
            stall_timeout_s = get_env("MXNET_TPU_WATCHDOG_STALL_S", 30.0,
                                      float)
        if enabled is None:
            enabled = env_flag("MXNET_TPU_WATCHDOG", True)
        self.interval_s = float(interval_s)
        self.stall_timeout_s = float(stall_timeout_s)
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        # serializes whole scans (NOT self._lock: restart factories may
        # re-register, which takes self._lock) — a monitor-tick scan
        # racing an explicit scan (io_device._maybe_restart) must never
        # apply one death's restart policy twice (two live workers over
        # one base iterator)
        self._scan_lock = threading.Lock()
        self._beats = []
        self._stop = threading.Event()
        self._monitor = None

    # ------------------------------------------------------------------
    def register(self, name, thread=None, stall_timeout=None,
                 on_death="surface", restart=None):
        """Supervise one worker. ``thread`` enables death detection;
        ``restart`` (callable returning a new Thread, or None) is the
        death policy when ``on_death="restart"``. Returns the Heartbeat
        the worker loop must beat."""
        if not self.enabled:
            return _NullHeartbeat(name)
        hb = Heartbeat(name, thread=thread,
                       stall_timeout=(stall_timeout if stall_timeout
                                      is not None else self.stall_timeout_s),
                       on_death=on_death, restart=restart)
        with self._lock:
            self._beats.append(hb)
            self._ensure_monitor()
        return hb

    def _ensure_monitor(self):
        # caller holds self._lock
        if self._monitor is not None and self._monitor.is_alive():
            return
        self._stop = threading.Event()
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         name="mx-watchdog", daemon=True)
        self._monitor.start()

    def stop(self):
        """Stop the monitor thread (tests; production leaves the daemon
        running for the process lifetime)."""
        self._stop.set()
        mon = self._monitor
        if mon is not None and mon.is_alive():
            mon.join(timeout=5.0)
        with self._lock:
            self._monitor = None

    # ------------------------------------------------------------------
    def _monitor_loop(self):
        while not self._stop.wait(self.interval_s):
            self.scan()

    def scan(self, now=None):
        """One supervision pass (the monitor calls this on its interval;
        tests call it directly for determinism). Returns the number of
        events recorded."""
        now = time.monotonic() if now is None else now
        with self._scan_lock:
            return self._scan_locked(now)

    def _scan_locked(self, now):
        from .. import profiler as _prof
        events = 0
        with self._lock:
            beats = list(self._beats)
        retired = []
        for hb in beats:
            if hb.closed:
                retired.append(hb)
                continue
            if hb.thread is not None and hb.thread.ident is not None \
                    and not hb.thread.is_alive():
                # ident None = registered before start() — not a death
                hb.deaths += 1
                events += 1
                _prof.record_watchdog_event(hb.name, "death")
                _log.warning("watchdog: thread %s died without close()",
                             hb.name)
                if hb.on_death == "restart" and hb.restart is not None:
                    try:
                        new_thread = hb.restart()
                    except Exception as e:
                        _log.error("watchdog: restart of %s failed: %s",
                                   hb.name, e)
                        _prof.record_watchdog_event(hb.name, "restart_failed")
                        retired.append(hb)
                        continue
                    hb.restarts += 1
                    hb.thread = new_thread
                    hb.idle()
                    _prof.record_watchdog_event(hb.name, "restart")
                    _log.warning("watchdog: restarted %s", hb.name)
                else:
                    # surfaced: counter + log is the contract; the owning
                    # subsystem's own sentinel carries the error to callers
                    retired.append(hb)
                continue
            if hb.busy and now - hb.last_beat > hb.stall_timeout:
                if not hb.stalled:
                    hb.stalled = True
                    hb.stalls += 1
                    events += 1
                    _prof.record_watchdog_event(hb.name, "stall")
                    _log.warning(
                        "watchdog: %s busy but silent for %.1fs "
                        "(threshold %.1fs)", hb.name, now - hb.last_beat,
                        hb.stall_timeout)
            elif hb.stalled:
                hb.stalled = False
                events += 1
                _prof.record_watchdog_event(hb.name, "stall_recovered")
                _log.info("watchdog: %s recovered", hb.name)
        if retired:
            with self._lock:
                self._beats = [h for h in self._beats if h not in retired]
        return events


_singleton = None
_singleton_lock = threading.Lock()


def watchdog():
    """The process-wide Watchdog (built lazily on first use, honoring the
    env knobs at that moment)."""
    global _singleton
    if _singleton is None:
        with _singleton_lock:
            if _singleton is None:
                _singleton = Watchdog()
    return _singleton
