"""Runtime configuration knobs.

Counterpart of ``mxnet_tpu/config.py``: the storage fallback's warning
(``MXNET_STORAGE_FALLBACK_LOG_VERBOSE``: a sparse array that an op reads
through its dense view is logged once per site) and
``MXNET_PROFILER_AUTOSTART`` (the profiler starts at import and writes
its trace at exit).
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


_autostart_profiler()
