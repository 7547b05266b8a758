"""Information about the native libraries.

Counterpart of ``mxnet_tpu/libinfo.py`` (parity: reference
``python/mxnet/libinfo.py``, whose ``find_lib_path`` locates
libmxnet.so). The port's native libraries are the kernels and host
libraries that ``kernels/_build.py`` builds at first use from
``kernels/csrc/`` into ``kernels/_build/``: the CUDA kernels
(:data:`kernels._build.SOURCES`), the host libraries
(:data:`kernels._build.HOST_SOURCES`) and the C ABI, ``libmxnet.so``
(:data:`kernels._build.EMBED_SOURCES`), which a C or C++ program links as
upstream's programs link ``libmxnet.so``.
"""
from __future__ import annotations

import os

from .kernels import _build

__all__ = ["find_lib_path", "find_include_path", "__version__"]


def find_lib_path():
    """The paths of the native libraries built so far.

    Returns
    -------
    lib_path : list(string)
        Every ``kernels/_build/lib<name>.so`` that exists; empty before
        the first build (nothing is built at import).
    """
    names = ["lib%s.so" % n for n in _build.SOURCES + _build.HOST_SOURCES
             + tuple(_build.EMBED_SOURCES)]
    return [os.path.join(_build.BUILD_DIR, n) for n in names
            if os.path.exists(os.path.join(_build.BUILD_DIR, n))]


def find_include_path():
    """The directory of the native sources and their headers
    (``kernels/csrc``: the ``.cu``, ``.cuh`` and ``.cc`` files)."""
    return _build.SRC_DIR


__version__ = "0.12.1"
