"""Atomic file writes (the part of ``mxnet_tpu/checkpoint.py`` the flight
recorder writes through).

A copy of ``mxnet_tpu/checkpoint.py:82-142`` (``atomic_write``,
``atomic_save_ndarrays``): temp file in the same directory, fsync,
rename, so a crash at any instant leaves either the old complete file or
the new one. The JAX package's ``atomic_save_ndarrays`` also accepts
remote URIs through ``filesystem.register_scheme``; the port has no
``filesystem`` module, so it writes local paths only.
``CheckpointManager``, ``TrainingPreempted`` and ``DivergenceError`` are
not ported yet (ROADMAP Queue 1 item 3.4).
"""
from __future__ import annotations

import os

__all__ = ["atomic_write", "atomic_save_ndarrays"]


def _fsync_path(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _tmp_beside(path):
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, ".%s.tmp.%d" % (os.path.basename(path),
                                           os.getpid()))


def atomic_write(path, data):
    """Write ``data`` (bytes or str) to ``path`` atomically: temp file
    in the same directory, fsync, rename. A crash at ANY instant leaves
    either the old complete file or the new complete file."""
    if isinstance(data, str):
        data = data.encode()
    tmp = _tmp_beside(path)
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_save_ndarrays(path, save_dict):
    """``nd.save`` semantics with the temp+fsync+rename discipline."""
    from .ndarray import save as _nd_save
    tmp = _tmp_beside(path)
    try:
        _nd_save(tmp, save_dict)
        _fsync_path(tmp)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
