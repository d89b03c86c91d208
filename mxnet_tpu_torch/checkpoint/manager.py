"""CheckpointManager: asynchronous saves, retention, resume and preemption
(reference: ``mxnet_tpu/checkpoint/manager.py`` L35-720).

``save(step, ...)`` captures the training state on the calling thread
(device clones behind one CUDA event, ``state.py``) and queues the write
on one background writer thread, so the next step is enqueued at once.
Waiting on the event, the host copies, serialization, the atomic commit
(``layout.py``) and retention run on the writer. A kill at any moment
leaves the last committed checkpoint whole.

Environment defaults, as in the reference:

* ``MXNET_CHECKPOINT_DIR`` — default ``directory``
* ``MXNET_CHECKPOINT_PERIOD`` — default ``save_period``, the epochs
  between saves in ``Module.fit(checkpoint_manager=...)``
* ``MXNET_CHECKPOINT_KEEP_LAST`` — default ``keep_last_n``
* ``MXNET_TPU_PREEMPT_NOTICE_S`` — ``notify_preemption``'s default
  deadline

Transient write errors retry under ``resilience.retry`` (site
``checkpoint.write``); the fault sites are ``checkpoint.write``,
``checkpoint.commit`` and ``checkpoint.preempt``. One process writes a
checkpoint: the multi-host shared staging of the reference and server
snapshots of ``dist_async`` stores are not yet ported (ROADMAP A7 part 2).
"""
from __future__ import annotations

import atexit
import logging
import os
import pickle
import queue
import threading
import time

from ..base import MXNetError, atomic_write, get_env
from ..resilience import faults as _faults
from ..resilience.retry import RetryPolicy, TransientError
from . import layout, state as state_mod

__all__ = ["CheckpointManager", "SaveHandle", "RestoredCheckpoint"]


class SaveHandle:
    """Returned by ``CheckpointManager.save``; ``wait()`` blocks until the
    checkpoint is committed or re-raises the writer's error."""

    def __init__(self):
        self._event = threading.Event()
        self._err = []
        self._observed = False  # its error already reached a caller
        self.path = None

    def wait(self, timeout=None):
        if not self._event.wait(timeout):
            raise MXNetError("checkpoint write still in flight after %ss"
                             % timeout)
        if self._err:
            self._observed = True
            raise self._err[0]
        return self.path

    def done(self):
        return self._event.is_set()

    def _finish(self, path=None, error=None):
        self.path = path
        if error is not None:
            self._err.append(error)
        self._event.set()


class RestoredCheckpoint:
    """A loaded checkpoint (``CheckpointManager.restore``). ``rng`` is the
    port's RNG state, or None for a checkpoint written by the JAX
    package."""

    __slots__ = ("path", "meta", "symbol", "arg_params", "aux_params",
                 "optimizer", "rng")

    def __init__(self, path, meta, symbol, arg_params, aux_params, optimizer,
                 rng):
        self.path = path
        self.meta = meta
        self.symbol = symbol
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.optimizer = optimizer
        self.rng = rng

    @property
    def step(self):
        return self.meta.get("step")

    @property
    def epoch(self):
        return self.meta.get("epoch")


class CheckpointManager:
    """Asynchronous, preemption-safe checkpoints in one directory.

    ``keep_last_n`` keeps the N highest committed steps (None: all);
    ``keep_every_k_steps`` also keeps every step divisible by k;
    ``save_period`` is the epochs between saves in ``Module.fit``;
    ``preemption_signal`` (a signal number, or True for SIGTERM) makes
    ``Module.fit`` install the hook that flushes a final checkpoint."""

    FORMAT = 1
    _WAIT_S = 1.0

    def __init__(self, directory=None, keep_last_n=None,
                 keep_every_k_steps=None, save_period=None,
                 preemption_signal=None, logger=None):
        directory = directory or get_env("MXNET_CHECKPOINT_DIR")
        if not directory:
            raise MXNetError("CheckpointManager needs a directory (argument "
                             "or MXNET_CHECKPOINT_DIR)")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep_last_n = keep_last_n if keep_last_n is not None else \
            get_env("MXNET_CHECKPOINT_KEEP_LAST", None, int)
        self.keep_every_k_steps = keep_every_k_steps
        self.save_period = max(1, save_period if save_period is not None
                               else get_env("MXNET_CHECKPOINT_PERIOD", 1,
                                            int))
        self.preemption_signal = preemption_signal
        self.logger = logger or logging.getLogger(__name__)
        self._queue = queue.Queue()
        self._writer = None
        # reentrant: the preemption handler runs on the thread that holds
        # the GIL, possibly inside one of these lock sections, and calls
        # save() and wait() itself
        self._lock = threading.RLock()
        self._handles = []        # outstanding SaveHandles
        self._active_tmp = set()  # staging directories being written
        self._live_capture = None
        self._preempt_notice_t = None
        self._preempt_deadline_s = None
        self._prev_handlers = {}
        self._atexit_registered = False
        # each attempt stages and commits from a fresh directory, so a
        # retry never inherits a half-written file
        self._write_retry = RetryPolicy(site="checkpoint.write",
                                        retryable=(OSError, TransientError))

    # ------------------------------------------------------------------
    # save
    # ------------------------------------------------------------------
    def save(self, step, module=None, state=None, symbol=None,
             arg_params=None, aux_params=None, epoch=None, blocking=False,
             **meta_extra):
        """Capture and queue one checkpoint; returns a SaveHandle. One
        source: a ``module``, a ``TrainingState`` or explicit
        symbol/params. ``blocking=True`` writes on the calling thread."""
        if state is None:
            if module is not None:
                state = state_mod.capture_module(
                    module, epoch=epoch, step=step, arg_params=arg_params,
                    aux_params=aux_params, **meta_extra)
            else:
                state = state_mod.capture_params(
                    symbol=symbol, arg_params=arg_params,
                    aux_params=aux_params, epoch=epoch, step=step,
                    **meta_extra)
        state.step = step
        if epoch is not None:
            state.epoch = epoch
        handle = SaveHandle()
        if blocking:
            self._write_one(step, state, handle)
            if handle._err:
                raise handle._err[0]
            return handle
        with self._lock:
            self._handles.append(handle)
            self._ensure_writer()
        self._queue.put((step, state, handle))
        return handle

    def save_module(self, module, step, epoch=None, **kw):
        return self.save(step, module=module, epoch=epoch, **kw)

    def import_legacy(self, prefix, epoch, step=None):
        """Convert a ``prefix-symbol.json`` + ``prefix-%04d.params``
        checkpoint into a managed step (blocking)."""
        state = state_mod.from_legacy(prefix, epoch)
        return self.save(epoch if step is None else step, state=state,
                         epoch=epoch, blocking=True)

    # ------------------------------------------------------------------
    # writer thread
    # ------------------------------------------------------------------
    def _ensure_writer(self):
        if self._writer is not None and self._writer.is_alive():
            return
        self._writer = threading.Thread(target=self._writer_loop,
                                        name="mx-checkpoint-writer",
                                        daemon=True)
        self._writer.start()
        if not self._atexit_registered:
            # drain in-flight writes at a normal exit; the commit protocol
            # covers the others
            atexit.register(self._atexit_flush)
            self._atexit_registered = True

    def _writer_loop(self):
        # one long-lived daemon a manager: a thread retiring when idle
        # could race a save() past its liveness check
        from ..resilience.watchdog import watchdog as _watchdog
        hb = _watchdog().register("mx-checkpoint-writer",
                                  thread=self._writer)
        while True:
            hb.idle()
            try:
                step, state, handle = self._queue.get(timeout=self._WAIT_S)
            except queue.Empty:
                continue
            hb.beat()
            self._write_one(step, state, handle)
            self._queue.task_done()

    def _write_attempt(self, step, state):
        """One whole staging and commit; discards its own staging
        directory when it fails."""
        tmp = layout.begin_write(self.directory, step)
        with self._lock:
            self._active_tmp.add(tmp)
        try:
            _faults.fault_point("checkpoint.write", step=step)
            meta = self._write_files(tmp, step, state)
            layout.write_meta(tmp, meta)  # the commit marker, written last
            _faults.fault_point("checkpoint.commit", step=step)
            return layout.commit(tmp, self.directory, step)
        except BaseException:
            layout.discard(tmp)
            raise
        finally:
            with self._lock:
                self._active_tmp.discard(tmp)

    def _write_one(self, step, state, handle):
        try:
            state.wait_ready()
            path = self._write_retry.call(self._write_attempt, step, state)
            handle._finish(path=path)
        except BaseException as e:  # surfaced at handle.wait()
            handle._finish(error=e)
        finally:
            with self._lock:
                self._handles[:] = [h for h in self._handles
                                    if not h.done() or h._err]
        try:
            self._prune()
            with self._lock:
                active = set(self._active_tmp)
            layout.clean_stale(self.directory, active=active)
        except Exception as e:
            # retention is advisory: the next committed save runs it again
            self.logger.warning("checkpoint retention sweep failed: %s", e)

    def _write_files(self, tmp, step, state):
        meta = {"format": self.FORMAT, "step": step, "epoch": state.epoch,
                "time": time.time()}
        meta.update(state.meta_extra)
        if state.symbol_json is not None:
            with open(os.path.join(tmp, layout.SYMBOL_FILE), "w") as f:
                f.write(state.symbol_json)
        state_mod.save_params_files(tmp, state.arg_params, state.aux_params)
        if state.optimizer is not None:
            atomic_write(os.path.join(tmp, layout.OPTIMIZER_FILE),
                         state_mod._serialize_opt_payload(state.optimizer))
        if state.rng is not None:
            atomic_write(os.path.join(tmp, layout.RNG_FILE),
                         pickle.dumps(state.rng,
                                      protocol=pickle.HIGHEST_PROTOCOL))
        return meta

    # ------------------------------------------------------------------
    # flush / error surfacing
    # ------------------------------------------------------------------
    def wait(self, timeout=None):
        """Block until every queued checkpoint is committed; re-raises the
        first writer error. ``timeout`` is one deadline for all of them; a
        write still in flight then stays tracked for a later wait."""
        with self._lock:
            handles = list(self._handles)
            self._handles.clear()
        deadline = None if timeout is None else time.time() + timeout
        err = None
        unfinished = []
        for h in handles:
            if h._observed:
                continue  # its error was raised at handle.wait()
            try:
                remaining = None if deadline is None \
                    else max(0.0, deadline - time.time())
                h.wait(remaining)
            except BaseException as e:
                if not h.done():
                    unfinished.append(h)
                err = err or e
        if unfinished:
            with self._lock:
                self._handles.extend(unfinished)
        if err is not None:
            raise err

    flush = wait

    def _atexit_flush(self):
        try:
            self.wait(timeout=60.0)
        except Exception as e:
            # the interpreter is exiting: logging is all that is left
            self.logger.error("checkpoint flush at exit: %s", e)

    # ------------------------------------------------------------------
    # discovery / retention
    # ------------------------------------------------------------------
    def all_steps(self):
        return [s for s, _ in layout.list_checkpoints(self.directory)]

    def latest_step(self):
        return layout.latest_step(self.directory)

    def latest_path(self):
        return layout.latest_checkpoint(self.directory)

    def _prune(self):
        ckpts = layout.list_checkpoints(self.directory)
        if not ckpts or self.keep_last_n is None:
            # unbounded retention: keep_every_k_steps alone prunes nothing
            return
        steps = [s for s, _ in ckpts]
        boundary = []
        for s, path in ckpts:
            try:
                if not layout.read_meta(path).get("mid_epoch"):
                    boundary.append(s)
            except Exception:
                boundary.append(s)  # an unreadable manifest is kept
        keep = {steps[-1]}
        if boundary:
            # resume() skips mid-epoch snapshots: the newest epoch-boundary
            # checkpoint always survives
            keep.add(boundary[-1])
        if self.keep_last_n:
            keep.update(steps[-self.keep_last_n:])
        if self.keep_every_k_steps:
            keep.update(s for s in steps if s % self.keep_every_k_steps == 0)
        layout.prune(self.directory, keep)

    # ------------------------------------------------------------------
    # restore
    # ------------------------------------------------------------------
    def restore(self, step=None):
        """A committed checkpoint (``step=None``: the latest) as a
        RestoredCheckpoint, or None when the directory has none."""
        if step is None:
            path = layout.latest_checkpoint(self.directory)
        else:
            path = layout.step_path(self.directory, step)
            if not layout.is_committed(path):
                raise MXNetError("no committed checkpoint for step %d under "
                                 "%s" % (step, self.directory))
        if path is None:
            return None
        return self._load(path)

    def _load(self, path):
        meta = layout.read_meta(path)
        symbol = None
        sym_file = os.path.join(path, layout.SYMBOL_FILE)
        if os.path.isfile(sym_file):
            from .. import symbol as sym_mod
            symbol = sym_mod.load(sym_file)
        arg_params, aux_params = state_mod.load_params_files(path, meta)
        optimizer = None
        opt_file = os.path.join(path, layout.OPTIMIZER_FILE)
        if os.path.isfile(opt_file):
            with open(opt_file, "rb") as f:
                optimizer = state_mod._parse_opt_payload(f.read())
        rng = None
        rng_file = os.path.join(path, layout.RNG_FILE)
        if os.path.isfile(rng_file):
            with open(rng_file, "rb") as f:
                rng = state_mod.loads(f.read())
        return RestoredCheckpoint(path, meta, symbol, arg_params, aux_params,
                                  optimizer, rng)

    def restore_module(self, module, step=None, restore_rng=True):
        """Restore params, optimizer slots and RNG onto a bound, initialized
        Module. Returns the checkpoint's manifest, or None when nothing is
        committed."""
        data = self.restore(step)
        if data is None:
            return None
        module.set_params(data.arg_params, data.aux_params)
        kv = getattr(module, "_kvstore", None)
        if kv is not None and getattr(module, "_update_on_kvstore", False) \
                and getattr(module, "_fused_step", None) is None:
            # the store owns the weights the next push and pull go through
            for name, val in data.arg_params.items():
                if name in kv._store:
                    kv._store[name]._data.copy_(val._data)
        if data.optimizer is not None and \
                getattr(module, "optimizer_initialized", False):
            state_mod.apply_optimizer_payload(module, data.optimizer)
        if restore_rng and data.rng is not None:
            state_mod.restore_rng(data.rng)
        return data.meta

    def resume(self, module, default_begin_epoch=0, train_data=None,
               supervisor=None):
        """``fit``'s resume: restore the newest EPOCH-BOUNDARY checkpoint
        and return the epoch to continue from. Mid-epoch snapshots are
        skipped: re-running the interrupted epoch from its boundary keeps
        the run bit for bit the uninterrupted one. ``train_data`` replays
        the manifest's exact data position; ``supervisor`` gets its
        loss-scale and streak state back."""
        for step, path in reversed(layout.list_checkpoints(self.directory)):
            meta = layout.read_meta(path)
            if meta.get("mid_epoch"):
                continue
            self.restore_module(module, step=step)
            self._apply_data_position(meta, train_data)
            if supervisor is not None and meta.get("supervisor_state"):
                supervisor.load_state(meta["supervisor_state"])
            epoch = meta.get("epoch")
            self.logger.info("checkpoint resume: step %d from %s", step,
                             path)
            if epoch is None:
                return default_begin_epoch
            return max(default_begin_epoch, int(epoch) + 1)
        return default_begin_epoch

    def _apply_data_position(self, meta, train_data):
        """The manifest's iterator position onto the live train iterator.
        A changed data pipeline degrades to a fresh iterator with a
        warning: resume never fails on it, it only loses the exact
        replay."""
        pos = meta.get("data_position")
        if not pos or train_data is None:
            return
        if not callable(getattr(train_data, "iter_restore", None)):
            self.logger.warning(
                "checkpoint carries a data_position but the train iterator "
                "(%s) is not resumable; replaying from a fresh iterator",
                type(train_data).__name__)
            return
        try:
            train_data.iter_restore(pos["iter"])
            if pos.get("pending_reset"):
                # the original run reset after this save: replay it on the
                # restored shuffle-RNG chain
                train_data.reset()
        except Exception as e:
            from .. import profiler as _prof
            _prof.record_supervisor_event(data_position_failures=1)
            self.logger.warning("data position restore failed (%s); "
                                "replaying from a fresh iterator", e)

    # ------------------------------------------------------------------
    # preemption
    # ------------------------------------------------------------------
    def set_live_capture(self, capture):
        """``capture() -> save(**kwargs)``: what the preemption hook and
        ``notify_preemption`` save (fit points it at the live module)."""
        self._live_capture = capture

    def notify_preemption(self, deadline_s=None):
        """An advance notice of preemption: the save cadence drops to every
        epoch, and one live snapshot is queued now. Returns its SaveHandle,
        or None without a live capture or when the step is committed."""
        if deadline_s is None:
            deadline_s = get_env("MXNET_TPU_PREEMPT_NOTICE_S", 60.0, float)
        with self._lock:
            self._preempt_notice_t = time.monotonic()
            self._preempt_deadline_s = float(deadline_s)
            cap = self._live_capture
        self.logger.warning("preemption notice: instance going away in "
                            "%.0fs; saving every epoch", float(deadline_s))
        if cap is None:
            return None
        kwargs = dict(cap())
        kwargs.setdefault("mid_epoch", True)
        kwargs.setdefault("preempted", True)
        step = kwargs.get("step")
        if step is not None and layout.is_committed(
                layout.step_path(self.directory, step)):
            return None
        return self.save(**kwargs)

    def preemption_notice(self):
        """Seconds left on a preemption notice (at least 0), or None."""
        with self._lock:
            if self._preempt_notice_t is None:
                return None
            elapsed = time.monotonic() - self._preempt_notice_t
            return max(0.0, self._preempt_deadline_s - elapsed)

    def effective_save_period(self):
        """``save_period``, or 1 once a preemption notice arrived."""
        with self._lock:
            if self._preempt_notice_t is not None:
                return 1
        return self.save_period

    def install_preemption_hook(self, signals=None, capture=None):
        """Signal handlers that drain the queue, write one final
        checkpoint of the live capture (``mid_epoch``) on the calling
        thread, then chain to the previous handler (or exit with 128 +
        the signal). Install from the main thread."""
        import signal as _signal
        if signals is None:
            sig = self.preemption_signal
            if sig in (None, False, True):
                sig = _signal.SIGTERM
            signals = (sig,)

        def _handler(signum, frame):
            self.logger.warning("signal %d: flushing final checkpoint",
                                signum)
            try:
                _faults.fault_point("checkpoint.preempt", signum=signum)
                # queued boundary saves first: the final snapshot may reuse
                # the current epoch's step number
                try:
                    self.wait(timeout=300.0)
                except Exception as e:
                    # best effort; the blocking final save below still runs
                    self.logger.error("preemption flush: %s", e)
                cap = capture or self._live_capture
                if cap is not None:
                    kwargs = dict(cap())
                    kwargs.setdefault("blocking", True)
                    kwargs.setdefault("mid_epoch", True)
                    kwargs.setdefault("preempted", True)
                    step = kwargs.get("step")
                    committed = layout.step_path(self.directory, step) \
                        if step is not None else None
                    if committed is not None \
                            and layout.is_committed(committed) \
                            and not layout.read_meta(committed).get(
                                "mid_epoch"):
                        # never replace an epoch-boundary checkpoint with a
                        # mid-epoch snapshot: resume() needs it
                        self.logger.info("step %s already committed; "
                                         "skipping preemption snapshot",
                                         step)
                    else:
                        self.save(**kwargs)
            finally:
                prev = self._prev_handlers.get(signum)
                if callable(prev):
                    prev(signum, frame)
                elif prev != _signal.SIG_IGN:
                    raise SystemExit(128 + signum)

        for sig in signals:
            self._prev_handlers[sig] = _signal.signal(sig, _handler)
        return signals

    def uninstall_preemption_hook(self):
        import signal as _signal
        for sig, prev in self._prev_handlers.items():
            _signal.signal(sig, prev if prev is not None else _signal.SIG_DFL)
        self._prev_handlers.clear()
