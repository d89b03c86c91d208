"""Deterministic fault injection — the "prove recovery works" half of the
resilience layer (docs/faq/resilience.md).

A copy of ``mxnet_tpu/resilience/faults.py`` (the port imports nothing of
the JAX package). The port's hooks: the decode engine's ``decode.step``,
the fused train step's ``train.step``, the training supervisor's
``train.nan``, ``train.stall`` and ``train.restore``, and the device
prefetch's ``prefetch.stage``.

A recovery path only counts when a fault can be produced on demand. This
module gives each one a deterministic trigger: lightweight ``fault_point``
hooks sit on the real hot paths and an env-configured registry decides
which hook fires what fault when.

Spec grammar (``MXNET_TPU_FAULT_SPEC``, ``;``-separated specs)::

    spec    = site[:matcher|trigger]*[:action]
    site    = dotted hook name, e.g. checkpoint.write, serving.dispatch
    trigger = count=N   fire on exactly the Nth matching hit (1-based)
              after=N   fire on every matching hit past the Nth
              times=K   fire at most K times, then disarm
              prob=P    fire with probability P per matching hit
              seed=S    RNG seed for prob (default 0 — deterministic)
    matcher = key=value any other key: string-compared against the
              hook's context kwargs (e.g. step=3, replica=0); a hit
              only matches when every matcher agrees
    action  = raise=Exc[,message]   raise Exc (builtin name, MXNetError,
                                    or TransientError)
              delay=MS              sleep MS milliseconds, then continue
              kill[=SIG]            signal OWN pid (default SIGTERM) —
                                    how preemption timing is exercised

Examples::

    MXNET_TPU_FAULT_SPEC="checkpoint.write:step=3:raise=OSError"
    MXNET_TPU_FAULT_SPEC="serving.dispatch:replica=0:after=2:raise=OSError,sick replica"
    MXNET_TPU_FAULT_SPEC="kvstore.pull:prob=0.1:seed=7:raise=ConnectionError"

Overhead contract: when no spec is configured every ``fault_point`` call
is a no-op guarded by ONE cached module flag (``_ENABLED``) — no registry
walk, no lock, no env read.
"""
from __future__ import annotations

import os
import re
import threading
import time

from ..base import MXNetError, get_env

__all__ = ["fault_point", "configure", "reset", "enabled", "stats",
           "parse_spec", "register_exception", "FaultInjected",
           "TransientError"]


class FaultInjected(MXNetError):
    """Default exception raised by a ``raise=`` action with no explicit
    class — typed so chaos tests can tell an injected fault from a real
    one."""


class TransientError(MXNetError):
    """Marker for explicitly-retryable framework errors (retry.py treats
    it as retryable by construction; fault specs may raise it to exercise
    a retry path end to end)."""


_TRIGGER_KEYS = frozenset({"count", "after", "times", "prob", "seed"})
_ACTION_KEYS = frozenset({"raise", "delay", "kill"})

# exception classes a `raise=` action may name: a fixed builtin set plus
# the framework's own typed errors — never an arbitrary attribute lookup
import builtins as _builtins

_EXC_WHITELIST = {
    "MXNetError": MXNetError,
    "FaultInjected": FaultInjected,
    "TransientError": TransientError,
}
for _name in ("OSError", "IOError", "RuntimeError", "ValueError",
              "KeyError", "TimeoutError", "ConnectionError",
              "ConnectionResetError", "BrokenPipeError",
              "FileNotFoundError", "PermissionError", "MemoryError",
              "InterruptedError", "Exception"):
    _EXC_WHITELIST[_name] = getattr(_builtins, _name)

_SITE_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_.\-]*$")


def register_exception(name, exc_cls):
    """Add a framework-typed exception to the ``raise=`` whitelist so
    specs can exercise a subsystem's own typed failure path (e.g.
    ``train.stall:raise=TrainingStalled``). Never an arbitrary attribute
    lookup: callers register explicit classes at import time."""
    if not (isinstance(exc_cls, type) and issubclass(exc_cls, BaseException)):
        raise MXNetError("register_exception needs an exception class, "
                         "got %r" % (exc_cls,))
    _EXC_WHITELIST[name] = exc_cls


class _FaultSpec:
    """One parsed spec: site + matchers + trigger + action, with its own
    hit/fired state (mutated under the registry lock only)."""

    __slots__ = ("site", "matchers", "count", "after", "times", "prob",
                 "seed", "action", "arg", "hits", "fired", "_rng", "text")

    def __init__(self, text):
        self.text = text
        self.matchers = {}
        self.count = None
        self.after = None
        self.times = None
        self.prob = None
        self.seed = 0
        self.action = None
        self.arg = None
        self.hits = 0
        self.fired = 0
        self._rng = None
        tokens = text.split(":")
        self.site = tokens[0].strip()
        if not _SITE_RE.match(self.site):
            raise MXNetError("fault spec %r: bad site name %r"
                             % (text, self.site))
        for tok in tokens[1:]:
            tok = tok.strip()
            if not tok:
                continue
            key, sep, val = tok.partition("=")
            if not sep:
                if key == "kill":  # bare kill: default signal
                    self._set_action("kill", None)
                    continue
                raise MXNetError("fault spec %r: token %r is neither "
                                 "key=value nor 'kill'" % (text, tok))
            if key in _TRIGGER_KEYS:
                try:
                    if key == "prob":
                        self.prob = float(val)
                        if not 0.0 <= self.prob <= 1.0:
                            raise ValueError(val)
                    else:
                        setattr(self, key, int(val))
                except ValueError:
                    raise MXNetError("fault spec %r: %s needs a number, "
                                     "got %r" % (text, key, val))
            elif key in _ACTION_KEYS:
                self._set_action(key, val)
            else:
                self.matchers[key] = val
        if self.action is None:
            raise MXNetError("fault spec %r has no action (raise=/delay=/"
                             "kill)" % text)
        if self.prob is not None:
            import random
            self._rng = random.Random(self.seed)

    def _set_action(self, key, val):
        if self.action is not None:
            raise MXNetError("fault spec %r: more than one action"
                             % self.text)
        self.action = key
        if key == "raise":
            name, _, msg = (val or "FaultInjected").partition(",")
            if name not in _EXC_WHITELIST:
                raise MXNetError(
                    "fault spec %r: unknown exception %r (allowed: %s)"
                    % (self.text, name, sorted(_EXC_WHITELIST)))
            self.arg = (_EXC_WHITELIST[name], msg or None)
        elif key == "delay":
            try:
                self.arg = float(val) / 1000.0
            except (TypeError, ValueError):
                raise MXNetError("fault spec %r: delay needs milliseconds, "
                                 "got %r" % (self.text, val))
        else:  # kill
            self.arg = val or "SIGTERM"

    # -- matching ----------------------------------------------------
    def matches(self, ctx):
        for key, want in self.matchers.items():
            if key not in ctx or str(ctx[key]) != want:
                return False
        return True

    def should_fire(self):
        """Trigger decision for one MATCHING hit (self.hits already
        incremented). Caller holds the registry lock."""
        if self.times is not None and self.fired >= self.times:
            return False
        if self.count is not None:
            return self.hits == self.count
        if self.after is not None:
            return self.hits > self.after
        if self.prob is not None:
            return self._rng.random() < self.prob
        return True  # no trigger: every matching hit fires


# ---------------------------------------------------------------------
# registry (module-level; configure()/reset() swap it atomically)
# ---------------------------------------------------------------------
_ENABLED = False            # THE cached zero-overhead guard
_lock = threading.Lock()
_specs = []                 # list of _FaultSpec
_injected = {}              # site -> fired count (stats())


def parse_spec(text):
    """Parse a full spec string into a list of _FaultSpec (empty for
    None/blank). Raises MXNetError on grammar errors."""
    if not text or not text.strip():
        return []
    return [_FaultSpec(part.strip())
            for part in re.split(r"[;\n]+", text) if part.strip()]


def configure(spec_text):
    """(Re)configure the registry from a spec string (what the env var
    holds). Passing None/"" disables injection and restores the
    zero-overhead no-op path. Returns the number of active specs."""
    global _ENABLED, _specs
    specs = parse_spec(spec_text)
    with _lock:
        _specs = specs
        _ENABLED = bool(specs)
        _injected.clear()
    return len(specs)


def reset():
    """Disable injection and clear all spec state/stats."""
    configure(None)


def enabled():
    return _ENABLED


def stats():
    """{site: fired count} of injected faults plus per-spec hit/fired
    detail under "specs"."""
    with _lock:
        out = dict(_injected)
        out["specs"] = [{"spec": s.text, "hits": s.hits, "fired": s.fired}
                        for s in _specs]
    return out


def fault_point(site, **ctx):
    """Fault hook. Instrumented call sites invoke this with their site
    name and whatever context identifies the hit (step=, replica=, ...).

    Disabled (no spec configured): returns immediately off ONE cached
    flag — the instrumented hot paths pay a predicate, nothing else."""
    if not _ENABLED:
        return
    _fire(site, ctx)


def _fire(site, ctx):
    actions = []
    with _lock:
        for spec in _specs:
            if spec.site != site or not spec.matches(ctx):
                continue
            spec.hits += 1
            if not spec.should_fire():
                continue
            spec.fired += 1
            _injected[site] = _injected.get(site, 0) + 1
            actions.append(spec)
    for spec in actions:
        from .. import profiler as _prof
        _prof.record_fault_injection(site)
        if spec.action == "delay":
            time.sleep(spec.arg)
        elif spec.action == "kill":
            import signal as _signal
            sig = spec.arg
            signum = getattr(_signal, sig, None) if isinstance(sig, str) \
                else sig
            if signum is None:
                try:
                    signum = int(sig)
                except (TypeError, ValueError):
                    raise MXNetError("fault spec %r: unknown signal %r"
                                     % (spec.text, sig))
            os.kill(os.getpid(), int(signum))
        else:  # raise
            exc_cls, msg = spec.arg
            raise exc_cls(msg or "injected fault at %s (spec %r)"
                          % (site, spec.text))


# one env read at import: the flag must be cached before any hot path
# runs, and re-reading the environment per fault_point would defeat the
# zero-overhead contract
configure(get_env("MXNET_TPU_FAULT_SPEC"))
