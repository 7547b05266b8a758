"""Legacy layers: Crop and the ``_v1``/cuDNN aliases.

Counterpart of ``mxnet_tpu/ops/contrib_extra3.py:330-369``: ``Crop``
(reference crop-inl.h) and the aliases ``Convolution_v1``,
``Pooling_v1`` and ``CuDNNBatchNorm``, which share the modern ops'
computation. The rest of that file is the long tail (ROADMAP Queue 1
item 6).
"""
from __future__ import annotations

from ..base import MXNetError
from .common import as_tuple
from .registry import register, alias


@register("Crop", nin=-1,
          defaults={"num_args": 1, "offset": (0, 0), "h_w": (0, 0),
                    "center_crop": False})
def crop(*inputs, num_args=1, offset=(0, 0), h_w=(0, 0), center_crop=False):
    """Crop (N, C, H, W) to ``h_w``, or to the spatial shape of a second
    input (whose values are not read: it gets no gradient), at ``offset``
    (y, x) or centred. A window past the input's extent raises."""
    data = inputs[0]
    H, W = data.shape[2], data.shape[3]
    if len(inputs) == 2:
        th, tw = inputs[1].shape[2], inputs[1].shape[3]
    else:
        th, tw = as_tuple(h_w, 2)
    if center_crop:
        oy, ox = (H - th) // 2, (W - tw) // 2
    else:
        oy, ox = as_tuple(offset, 2)
    if oy < 0 or ox < 0 or oy + th > H or ox + tw > W:
        raise MXNetError("Crop: the %dx%d window at (%d, %d) exceeds the "
                         "input's %dx%d" % (th, tw, oy, ox, H, W))
    return data[:, :, oy:oy + th, ox:ox + tw]


alias("Convolution", "Convolution_v1")
alias("Pooling", "Pooling_v1")
alias("BatchNorm", "CuDNNBatchNorm")
