"""Training callbacks (parity: python/mxnet/callback.py).

Counterpart of ``mxnet_tpu/callback.py`` (``module_checkpoint``,
``do_checkpoint``, ``log_train_metric``, ``Speedometer``), kept as a
copy: the port imports nothing of the JAX package. The telemetry,
progress-bar and validation-logging callbacks are not ported yet.
"""
from __future__ import annotations

import logging
import time

__all__ = ["module_checkpoint", "do_checkpoint", "log_train_metric",
           "Speedometer"]


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """(parity: callback.module_checkpoint)"""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback


def do_checkpoint(prefix, period=1):
    """Epoch-end checkpoint callback (parity: callback.do_checkpoint)."""
    from .model import save_checkpoint
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


def log_train_metric(period, auto_reset=False):
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()
    return _callback


class Speedometer:
    """Log samples/sec every ``frequent`` batches (parity:
    callback.Speedometer). Reading the metric waits for the device."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0
        self.auto_reset = auto_reset

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                speed = self.frequent * self.batch_size \
                    / (time.time() - self.tic)
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec" \
                        % (param.epoch, count, speed)
                    msg += "".join("\t%s=%f" % kv for kv in name_value)
                    logging.info(msg)
                else:
                    logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f "
                                 "samples/sec", param.epoch, count, speed)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()
