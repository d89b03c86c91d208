"""Monitor — per-op output statistics during training.

Counterpart of ``mxnet_tpu/monitor.py``. ``install`` hooks an executor's
monitor callback (``Executor.set_monitor_callback``); every ``interval``
batches ``tic`` turns the executors' capture on, the forward passes the
output of every interior node (``<node>_output``, ``<node>_output<i>``)
to the callback, and ``toc`` returns ``(step, name, stat)`` for the names
that match ``pattern``, ``stat_func`` (default: the mean absolute value)
reducing each on the host.
"""
from __future__ import annotations

import re

import numpy as _np

from .ndarray.ndarray import NDArray

__all__ = ["Monitor"]


class Monitor(object):
    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def asum_stat(x):
                return _np.abs(x.asnumpy()).mean()
            stat_func = asum_stat
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

    def install(self, exe):
        """Hook an executor (``Module.install_monitor`` calls this)."""
        exe.set_monitor_callback(self._stat_helper)
        exe.monitor_activate(False)  # tic() enables capture per interval
        self.exes.append(exe)

    def _stat_helper(self, name, array):
        if not self.activated or not self.re_prog.match(name):
            return
        if not isinstance(array, NDArray):
            array = NDArray(array)
        self.queue.append((self.step, name, self.stat_func(array)))

    def tic(self):
        if self.step % self.interval == 0:
            for exe in self.exes:
                exe.monitor_activate(True)
                exe.monitor_flush()
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        if not self.activated:
            return []
        for exe in self.exes:
            exe.monitor_flush()
            exe.monitor_activate(False)
        self.activated = False
        res = []
        queue = sorted(self.queue) if self.sort else self.queue
        for n, k, v_list in queue:
            if isinstance(v_list, (tuple, list)):
                v = ", ".join(str(x) for x in v_list)
            else:
                v = str(v_list)
            res.append((n, k, v))
        self.queue = []
        return res

    def toc_print(self):
        res = self.toc()
        for n, k, v in res:
            print("Batch: {:7d} {:30s} {:s}".format(n, k, v))
