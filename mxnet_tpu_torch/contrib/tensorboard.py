"""TensorBoard integration.

Counterpart of ``mxnet_tpu/contrib/tensorboard.py`` (parity:
python/mxnet/contrib/tensorboard.py): ``LogMetricsCallback`` writes eval
metrics as scalar summaries through ``tensorboardX``'s or
``torch.utils.tensorboard``'s SummaryWriter where one imports (the
latter needs the ``tensorboard`` package), else as one JSON line per
scalar in ``<logging_dir>/events.jsonl``, as in the JAX package, so no
metric is dropped without a writer.
"""
from __future__ import annotations

import json
import os
import time

__all__ = ["LogMetricsCallback"]


class _JsonlWriter:
    """Minimal stand-in for SummaryWriter: one JSON line per scalar."""

    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        self._f = open(os.path.join(logdir, "events.jsonl"), "a")

    def add_scalar(self, tag, value, global_step=None):
        self._f.write(json.dumps({
            "wall_time": time.time(), "tag": tag,
            "value": float(value), "step": global_step}) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


def _make_writer(logging_dir):
    try:
        from tensorboardX import SummaryWriter  # type: ignore
        return SummaryWriter(logging_dir)
    except ImportError:
        pass
    try:
        from torch.utils.tensorboard import SummaryWriter  # type: ignore
        return SummaryWriter(logging_dir)
    except ImportError:
        return _JsonlWriter(logging_dir)


class LogMetricsCallback:
    """Log metrics periodically in TensorBoard (epoch/batch callback).

    Example::

        logging_dir = 'logs/'
        lc = mx.contrib.tensorboard.LogMetricsCallback(logging_dir)
        mod.fit(train, eval_metric='acc', batch_end_callback=lc)
    """

    def __init__(self, logging_dir, prefix=None):
        self.prefix = prefix
        self.step = 0
        self.summary_writer = _make_writer(logging_dir)

    def __call__(self, param):
        """Callback to log training speed and metrics in TensorBoard."""
        if param.eval_metric is None:
            return
        self.step += 1
        name_value = param.eval_metric.get_name_value()
        for name, value in name_value:
            if self.prefix is not None:
                name = "%s-%s" % (self.prefix, name)
            self.summary_writer.add_scalar(name, value, self.step)
