"""Training supervisor: NaN/stall containment and bounded restarts of a
``Module.fit``.

Counterpart of ``mxnet_tpu/resilience/supervisor.py`` (L69-359), with the
same environment variables, defaults, fault sites and checkpointed state.
``Module.fit(supervisor=...)`` (or ``MXNET_TPU_TRAIN_SUPERVISE=1``) hands
the fit to :meth:`TrainingSupervisor.run_fit`:

1. **Numeric-fault containment.** The fused train step, built with
   ``supervise=True`` (``parallel.DataParallelTrainStep``), seeds its
   backward with the loss scale, unscales the gradients, and computes an
   all-finite verdict on the device over the outputs and the gradients'
   sum of squares. A bad step leaves params, optimizer slots and BatchNorm
   statistics as they were: kernel #7 reads the verdict through a device
   pointer and writes nothing when it is false. The host reads the
   verdict only in :meth:`await_ready`, where the bounded dispatch
   already waits on step ``i - depth``: no sync is added to a clean step.
   Reduced precision gets dynamic loss scaling: a bad step halves the
   scale, ``scale_window`` clean steps double it (powers of two, so the
   unscale is exact); ``bad_steps_limit`` consecutive bad steps raise
   :class:`NumericDivergence`.
2. **Stall and crash recovery.** A step whose readback outlives
   ``step_deadline_s`` raises :class:`TrainingStalled`; stalls and the
   retry policy's transient errors restart the fit under full-jitter
   backoff. Without a checkpoint manager a restart continues from the
   in-memory state (no rewind), as the reference's does without one.

Not yet ported, and raising: a checkpoint manager (``manager=``, or the
fit's ``checkpoint_manager=``), with which each restart would resume from
the newest checkpoint (ROADMAP A8).

Fault sites (``MXNET_TPU_FAULT_SPEC``): ``train.nan`` (a ``raise=`` action
poisons that step's loss scale with NaN), ``train.stall`` (inside the
readback's deadline window, so a ``delay=`` past the deadline is a stall)
and ``train.restore`` (between restart attempts); ``train.step`` fires in
``Module``'s dispatch. Everything lands in
``profiler.supervisor_counters()``.
"""
from __future__ import annotations

import logging
import threading
import time

import torch

from ..base import MXNetError, env_flag, get_env
from . import faults as _faults
from .retry import RETRYABLE_DEFAULT, RetryPolicy

__all__ = ["TrainingSupervisor", "NumericDivergence", "TrainingStalled",
           "supervisor_from_env"]

_log = logging.getLogger(__name__)


class NumericDivergence(MXNetError):
    """Raised after ``bad_steps_limit`` CONSECUTIVE numerically bad
    (NaN/Inf loss or gradient) steps: the run is diverging, not blipping,
    and restarting would replay the same deterministic divergence."""


class TrainingStalled(MXNetError):
    """A step's readback outlived the supervisor's ``step_deadline_s``.
    Classified retryable: the supervisor restarts the fit."""


_faults.register_exception("TrainingStalled", TrainingStalled)
_faults.register_exception("NumericDivergence", NumericDivergence)


def _no_manager(manager):
    if manager is not None:
        raise MXNetError("TrainingSupervisor with a checkpoint manager is "
                         "not yet ported (ROADMAP A8)")


def supervisor_from_env(checkpoint_manager=None):
    """A TrainingSupervisor when ``MXNET_TPU_TRAIN_SUPERVISE=1``, else
    None. Read once per fit call, never on a step path."""
    if not env_flag("MXNET_TPU_TRAIN_SUPERVISE"):
        return None
    return TrainingSupervisor(manager=checkpoint_manager)


class TrainingSupervisor:
    """Drives one (or more) supervised ``Module.fit`` runs.

    Parameters (environment defaults as in the reference):

    * ``manager`` — a checkpoint manager: not yet ported (ROADMAP A8),
      so anything but None raises.
    * ``max_restarts`` — restart budget across the whole fit
      (``MXNET_TPU_TRAIN_MAX_RESTARTS``, default 3).
    * ``bad_steps_limit`` — consecutive bad steps before
      :class:`NumericDivergence` (``MXNET_TPU_TRAIN_BAD_STEPS``, 3).
    * ``loss_scale`` — initial dynamic loss scale; default 1.0 for float32
      steps, 2**15 when the fused step computes in reduced precision.
    * ``scale_window`` — clean steps between loss-scale doublings
      (``MXNET_TPU_TRAIN_SCALE_WINDOW``, 200; 0 disables regrowth).
    * ``step_deadline_s`` — readback deadline; 0/None disables stall
      detection (``MXNET_TPU_TRAIN_STEP_DEADLINE_S``, 0).
    """

    _SCALE_MAX = 2.0 ** 24

    def __init__(self, manager=None, max_restarts=None, bad_steps_limit=None,
                 loss_scale=None, scale_window=None, step_deadline_s=None,
                 retryable=None, logger=None):
        _no_manager(manager)
        self.manager = manager
        if max_restarts is None:
            max_restarts = get_env("MXNET_TPU_TRAIN_MAX_RESTARTS", 3, int)
        if bad_steps_limit is None:
            bad_steps_limit = get_env("MXNET_TPU_TRAIN_BAD_STEPS", 3, int)
        if scale_window is None:
            scale_window = get_env("MXNET_TPU_TRAIN_SCALE_WINDOW", 200, int)
        if step_deadline_s is None:
            step_deadline_s = get_env("MXNET_TPU_TRAIN_STEP_DEADLINE_S",
                                      0.0, float)
        self.max_restarts = max(0, int(max_restarts))
        self.bad_steps_limit = max(1, int(bad_steps_limit))
        self.scale_window = max(0, int(scale_window))
        self.step_deadline_s = float(step_deadline_s) or None
        # None = derived from the fused step's compute dtype at attach
        self._explicit_scale = loss_scale
        self.loss_scale = float(loss_scale) if loss_scale is not None else 1.0
        # restarts: stalls and the transient set; a numeric divergence is
        # deterministic and never restarted
        self.retryable = retryable if retryable is not None else \
            (TrainingStalled,) + RETRYABLE_DEFAULT
        self._backoff = RetryPolicy(attempts=self.max_restarts + 1,
                                    retryable=self.retryable,
                                    site="train.restart")
        self.logger = logger or _log
        # per-run step state (state_dict/load_state)
        self.clean_streak = 0
        self.bad_streak = 0
        self.bad_steps = 0
        self.steps = 0
        self.restarts = 0
        self._dispatched = 0
        self._hb = None

    # ------------------------------------------------------------------
    # the supervised fit
    # ------------------------------------------------------------------
    def run_fit(self, module, fit_kwargs):
        """Run ``module.fit(**fit_kwargs)`` under supervision, with
        bounded restarts under full-jitter backoff. Called by
        ``BaseModule.fit`` when a supervisor is active."""
        from .. import profiler as _prof
        fit_kwargs = dict(fit_kwargs)
        fit_kwargs["supervisor"] = False  # the inner fit must not re-enter
        _no_manager(fit_kwargs.get("checkpoint_manager"))
        module._supervisor = self
        # a module built by an UNsupervised fit carries a fused step with
        # no verdict and no scale: rebuild it rather than run unsupervised
        fused = getattr(module, "_fused_step", None)
        if fused is not None and not getattr(fused, "supervise", False):
            self.logger.warning(
                "training supervisor: rebuilding the fused step with "
                "supervision (it was built by an unsupervised fit)")
            module._fused_step = None
            module.optimizer_initialized = False
        from .watchdog import watchdog as _watchdog
        self._hb = _watchdog().register("mx-train-supervisor",
                                        thread=threading.current_thread())
        failures = 0
        try:
            while True:
                try:
                    return module.fit(**fit_kwargs)
                except BaseException as e:
                    if not self._backoff.is_retryable(e) \
                            or failures >= self.max_restarts:
                        raise
                    failures += 1
                    self.restarts += 1
                    _prof.record_supervisor_event(restarts=1)
                    delay = self._backoff.backoff_s(failures - 1)
                    self.logger.warning(
                        "training supervisor: restart %d/%d after %s: %s "
                        "(backoff %.2fs)", failures, self.max_restarts,
                        type(e).__name__, e, delay)
                    _faults.fault_point("train.restore", attempt=failures)
                    if delay > 0:
                        time.sleep(delay)
                    # a fresh attempt: the data iterator rewinds, streaks
                    # restart, and the failed attempt's in-flight verdicts
                    # are dropped unjudged
                    td = fit_kwargs.get("train_data")
                    if td is not None and callable(getattr(td, "reset",
                                                           None)):
                        td.reset()
                    infl = getattr(module, "_inflight", None)
                    if infl is not None:
                        infl.clear()
                    self._reset_attempt_state()
        finally:
            module._supervisor = None
            if self._hb is not None:
                self._hb.close()
                self._hb = None

    def _reset_attempt_state(self):
        self.clean_streak = 0
        self.bad_streak = 0
        self._dispatched = 0

    # ------------------------------------------------------------------
    # per-step hooks (called from Module's fused dispatch loop)
    # ------------------------------------------------------------------
    def attach_step(self, fused_step):
        """Derive the default loss scale from the freshly built fused
        step's compute dtype (reduced precision wants headroom; float32
        keeps the exact multiply-by-one)."""
        if self._explicit_scale is None and self.loss_scale == 1.0 \
                and getattr(fused_step, "compute_dtype", None) is not None:
            self.loss_scale = 2.0 ** 15

    def step_scale(self):
        """The loss scale for the NEXT dispatch. The ``train.nan`` fault
        site lives here: a ``raise=`` action poisons THIS step's scale
        with NaN, every gradient goes NaN on the device, the step skips,
        and the real scale backs off at readback."""
        if self._hb is not None:
            self._hb.beat()
        self._dispatched += 1
        try:
            _faults.fault_point("train.nan", step=self._dispatched - 1)
        except Exception:
            return float("nan")
        return self.loss_scale

    def await_ready(self, outs, flag):
        """Readback of one retiring in-flight step: a bounded wait (the
        stall deadline), then the device verdict folded into the state
        machine. ``outs`` is the step's ``torch.cuda.Event`` (or anything
        with ``query()``/``synchronize()``, or tensors, or None) and
        ``flag`` its 0-d bool verdict tensor (or None); on the card the
        wait is the one bounded dispatch does anyway, so reading the
        verdict then adds no sync."""
        t0 = time.monotonic()
        _faults.fault_point("train.stall", step=self.steps)
        deadline = self.step_deadline_s
        waits = [x for x in (outs if isinstance(outs, (list, tuple))
                             else [outs]) if hasattr(x, "query")]
        if deadline is not None:
            if time.monotonic() - t0 > deadline:
                self._stalled(t0)  # an injected delay consumed the budget
            while waits:
                waits = [x for x in waits if not x.query()]
                if not waits:
                    break
                if time.monotonic() - t0 > deadline:
                    self._stalled(t0)
                time.sleep(0.005)
        for x in waits:
            x.synchronize()
        if flag is not None:
            self.observe_step(bool(flag.item()) if isinstance(
                flag, torch.Tensor) else bool(flag))

    def _stalled(self, t0):
        from .. import profiler as _prof
        _prof.record_supervisor_event(stalls=1)
        raise TrainingStalled(
            "step readback exceeded the %.1fs deadline (%.1fs elapsed): "
            "device wedged or dispatch dead" % (self.step_deadline_s,
                                                time.monotonic() - t0))

    def observe_step(self, good):
        """Fold one step verdict into the containment state machine:
        loss-scale backoff and regrowth, and the consecutive-bad-step
        limit."""
        from .. import profiler as _prof
        self.steps += 1
        if good:
            self.clean_streak += 1
            self.bad_streak = 0
            _prof.record_supervisor_event(steps=1)
            # regrow only while scaling is active (scale != 1): float32
            # runs keep the exact multiply-by-one
            if self.scale_window and 1.0 < self.loss_scale < self._SCALE_MAX \
                    and self.clean_streak % self.scale_window == 0:
                self.loss_scale *= 2.0
                _prof.record_supervisor_event(scale_regrows=1)
            return
        self.bad_streak += 1
        self.bad_steps += 1
        self.clean_streak = 0
        _prof.record_supervisor_event(steps=1, bad_steps=1)
        if self.loss_scale > 1.0:
            self.loss_scale = max(1.0, self.loss_scale / 2.0)
            _prof.record_supervisor_event(scale_backoffs=1)
        self.logger.warning(
            "training supervisor: non-finite step skipped (streak %d/%d, "
            "loss scale now %g)", self.bad_streak, self.bad_steps_limit,
            self.loss_scale)
        if self.bad_streak >= self.bad_steps_limit:
            _prof.record_supervisor_event(divergences=1)
            raise NumericDivergence(
                "%d consecutive non-finite steps (loss scale %g): the run "
                "is diverging, not blipping" % (self.bad_streak,
                                                self.loss_scale))

    def idle(self):
        """Mark the supervised loop deliberately waiting (epoch
        boundaries, eval sweeps) so the watchdog does not read the pause
        as a stall."""
        if self._hb is not None:
            self._hb.idle()

    # ------------------------------------------------------------------
    # state (what a checkpoint manifest would carry)
    # ------------------------------------------------------------------
    def state_dict(self):
        return {"loss_scale": self.loss_scale,
                "clean_streak": self.clean_streak,
                "bad_streak": self.bad_streak,
                "bad_steps": self.bad_steps,
                "steps": self.steps}

    def load_state(self, state):
        from .. import profiler as _prof
        if not state:
            return
        self.loss_scale = float(state.get("loss_scale", self.loss_scale))
        self.clean_streak = int(state.get("clean_streak", 0))
        self.bad_streak = int(state.get("bad_streak", 0))
        self.bad_steps = int(state.get("bad_steps", 0))
        self.steps = int(state.get("steps", 0))
        self._explicit_scale = self.loss_scale  # restored, not re-derived
        _prof.record_supervisor_event(resumes=1)
