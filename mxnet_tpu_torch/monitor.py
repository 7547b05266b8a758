"""Monitor: statistics of intermediate outputs during training.

A copy of ``mxnet_tpu/monitor.py`` (parity: reference
``python/mxnet/monitor.py``): an executor's monitor callback feeds every
op output (named as ``get_internals()`` names them) to ``stat_helper``,
which keeps ``stat_func`` of those matching ``pattern`` in the batches
``tic`` activates (every ``interval``-th); ``toc`` adds the matching
arguments and returns ``(step, name, "v1,v2,...")`` rows. In the port
the executor taps the op outputs during the forward (and the
forward-backward the Module runs) itself, instead of evaluating the
graph's internals again.
"""
from __future__ import annotations

import logging
import re

from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["Monitor"]


class Monitor:
    """(parity: mx.monitor.Monitor)"""

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def asum_stat(x):
                return x.abs().mean()
            stat_func = asum_stat
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

        def stat_helper(name, arr):
            if not self.activated or not self.re_prog.match(name):
                return
            self.queue.append((self.step, name, self.stat_func(arr)))
        self.stat_helper = stat_helper

    def install(self, exe):
        """Feed ``exe``'s op outputs to ``stat_helper``."""
        exe.set_monitor_callback(self.stat_helper)
        self.exes.append(exe)

    def tic(self):
        """Start a batch; collect its statistics every ``interval``-th."""
        if self.step % self.interval == 0:
            for exe in self.exes:
                for array in exe.arg_arrays:
                    array.wait_to_read()
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """End the batch: the collected ``(step, name, value string)``
        rows, the matching arguments' statistics included."""
        if not self.activated:
            return []
        for exe in self.exes:
            for array in exe.arg_arrays:
                array.wait_to_read()
        for exe in self.exes:
            for name, array in zip(exe._symbol.list_arguments(),
                                   exe.arg_arrays):
                if self.re_prog.match(name):
                    self.queue.append((self.step, name,
                                       self.stat_func(array)))
        self.activated = False
        res = []
        if self.sort:
            self.queue.sort(key=lambda x: x[1])
        for n, k, v_list in self.queue:
            if isinstance(v_list, NDArray):
                v_list = [v_list]
            if not isinstance(v_list, list):
                raise MXNetError("Monitor: stat_func must return an NDArray "
                                 "or a list of them")
            s = ",".join(str(float(v.asscalar()) if isinstance(v, NDArray)
                             else v) for v in v_list)
            res.append((n, k, s))
        self.queue = []
        return res

    def toc_print(self):
        """``toc`` and log each row."""
        for n, k, v in self.toc():
            logging.info("Batch: %7d %30s %s", n, k, v)
