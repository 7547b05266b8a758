"""Runtime configuration knobs.

Counterpart of ``mxnet_tpu/config.py``: the storage fallback's warning
(``MXNET_STORAGE_FALLBACK_LOG_VERBOSE``: a sparse array that an op reads
through its dense view is logged once per site) and
``MXNET_PROFILER_AUTOSTART`` (the profiler starts at import and writes
its trace at exit), and upstream's ``MXNET_CUDA_ALLOW_TENSOR_CORE`` (0:
float32 convolutions and matrix products run in full float32, not TF32).
A program over the C ABI sets these in its environment, as it has no
Python to set ``torch.backends`` with.
"""
from __future__ import annotations

import logging

from .base import get_env

__all__ = ["storage_fallback_log"]

_fallback_logged = set()


def storage_fallback_log(what):
    """Warn (once per site) when a sparse op computes via its dense view
    (parity: MXNET_STORAGE_FALLBACK_LOG_VERBOSE, src/common/utils.h)."""
    if not get_env("MXNET_STORAGE_FALLBACK_LOG_VERBOSE", 0, int):
        return
    if what in _fallback_logged:
        return
    _fallback_logged.add(what)
    logging.getLogger("mxnet_tpu_torch").warning(
        "storage fallback: %s computes via its dense view", what)


def _autostart_profiler():
    """MXNET_PROFILER_AUTOSTART=1: ``profiler.set_state("run")`` when
    this module is imported (at ``import mxnet_tpu_torch``). A trace still
    running at exit is stopped and written then (to the configured
    filename, ``profile.json`` in the working directory by default), as
    upstream's profiler dumps at shutdown; a Kineto session left open
    when the interpreter tears down crashes it."""
    if get_env("MXNET_PROFILER_AUTOSTART", 0, int):
        import atexit
        from . import profiler
        profiler.set_state("run")
        atexit.register(profiler.set_state, "stop")


def _tensor_core_math():
    """MXNET_CUDA_ALLOW_TENSOR_CORE=0: both of PyTorch's TF32 flags off
    (``torch.backends.cudnn.allow_tf32``,
    ``torch.backends.cuda.matmul.allow_tf32``), as upstream's knob turns
    tensor-core math off for float32; unset or 1 leaves PyTorch's
    defaults."""
    if not get_env("MXNET_CUDA_ALLOW_TENSOR_CORE", 1, int):
        import torch
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


_autostart_profiler()
_tensor_core_math()
