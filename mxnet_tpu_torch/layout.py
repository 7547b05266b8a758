"""Default image-tensor layout for Gluon conv/pool/norm layers.

Counterpart of ``mxnet_tpu/layout.py``. Models built under
``set_default_layout("NHWC")`` (or with ``MXTPU_IMAGE_LAYOUT=NHWC`` in
the environment) run channels-last end to end; explicit per-layer
``layout=``/``axis=`` arguments always win. The op-level API is
unchanged: ``layout=None`` on Convolution/Pooling means NC+spatial.

On the card a channels-last activation is an NHWC-shaped tensor whose
NCHW permutation is a ``torch.channels_last`` view, the layout cuDNN
prefers.
"""
from __future__ import annotations

import os

from .base import MXNetError

_CHANNELS_LAST = {1: "NWC", 2: "NHWC", 3: "NDHWC"}
_CHANNELS_FIRST = {1: "NCW", 2: "NCHW", 3: "NCDHW"}

_default = None


def set_default_layout(layout):
    """Set the process default: "NHWC"/"NWC"/"NDHWC" (channels-last),
    "NCHW"/"NCW"/"NCDHW" (channels-first), or None (reference default)."""
    global _default
    if layout is not None:
        layout = str(layout).upper()
        if layout not in list(_CHANNELS_LAST.values()) + \
                list(_CHANNELS_FIRST.values()):
            raise MXNetError("unknown layout %r" % layout)
    _default = layout


def get_default_layout():
    return _default


if os.environ.get("MXTPU_IMAGE_LAYOUT"):
    set_default_layout(os.environ["MXTPU_IMAGE_LAYOUT"])


def default_is_channels_last():
    return bool(_default) and _default.endswith("C") and _default != "NC"


def resolve(layout, ndim):
    """Layer-construction helper: explicit layout wins; otherwise the
    process default (adapted to ndim); otherwise None (NC+spatial)."""
    if layout is not None:
        return str(layout).upper()
    if _default is None:
        return None
    table = _CHANNELS_LAST if _default.endswith("C") and _default != "NC" \
        else _CHANNELS_FIRST
    return table.get(ndim)
