"""Training callbacks of the port (reference: ``mxnet_tpu/callback.py``
L12-133): ``Speedometer``, ``do_checkpoint``, ``module_checkpoint`` and
``log_train_metric``, with the reference's log lines.

``do_checkpoint`` writes synchronously. Its ``background=True`` (a writer
thread) and a ``CheckpointManager`` prefix are not yet ported (ROADMAP
A8).
"""
from __future__ import annotations

import logging
import time

from .base import MXNetError

__all__ = ["Speedometer", "do_checkpoint", "log_train_metric",
           "module_checkpoint"]


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback saving ``mod``'s checkpoint every ``period``
    epochs."""
    every = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        epoch = iter_no + 1
        if epoch % every == 0:
            mod.save_checkpoint(prefix, epoch, save_optimizer_states)

    return _callback


def do_checkpoint(prefix, period=1, background=False):
    """Epoch-end callback writing ``save_checkpoint(prefix, epoch, ...)``
    every ``period`` epochs."""
    if background:
        raise MXNetError("do_checkpoint(background=True) is not yet ported "
                         "(ROADMAP A8)")
    if not isinstance(prefix, str):
        raise MXNetError("do_checkpoint with a %s is not yet ported "
                         "(ROADMAP A8)" % type(prefix).__name__)
    from .model import save_checkpoint
    every = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        epoch = iter_no + 1
        if epoch % every == 0:
            save_checkpoint(prefix, epoch, sym, arg, aux)

    return _callback


def log_train_metric(period, auto_reset=False):
    """Batch-end callback: log each metric every ``period`` batches,
    optionally resetting the running aggregate afterward."""

    def _callback(param):
        metric = param.eval_metric
        if metric is None or param.nbatch % period:
            return
        for pair in metric.get_name_value():
            logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                         param.epoch, param.nbatch, *pair)
        if auto_reset:
            metric.reset()

    return _callback


class Speedometer:
    """Log samples/sec every ``frequent`` batches. The first call of an
    epoch only arms the timer, so a rate never includes the first batch;
    an nbatch that goes backwards (a new epoch) re-arms."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self._armed = False
        self._tic = 0.0
        self._prev_nbatch = 0

    def __call__(self, param):
        n = param.nbatch
        if n < self._prev_nbatch:
            self._armed = False
        self._prev_nbatch = n
        if not self._armed:
            self._armed = True
            self._tic = time.time()
            return
        if n % self.frequent:
            return
        speed = self.frequent * self.batch_size / (time.time() - self._tic)
        metric = param.eval_metric
        if metric is not None:
            pairs = metric.get_name_value()
            if self.auto_reset:
                metric.reset()
            tail = "".join("\t%s=%f" % nv for nv in pairs)
            logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec%s",
                         param.epoch, n, speed, tail)
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, n, speed)
        self._tic = time.time()
