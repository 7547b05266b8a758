"""Runtime configuration knobs.

Counterpart of ``mxnet_tpu/config.py``; for now only the storage
fallback's warning (``MXNET_STORAGE_FALLBACK_LOG_VERBOSE``): a sparse
array that an op reads through its dense view is logged once per site.
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
