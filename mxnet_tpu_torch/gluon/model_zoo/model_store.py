"""Pretrained weights for the model zoo (parity: model_zoo/model_store).

The reference downloads each network's parameter file; the port reads
nothing from the network, so asking for pretrained weights raises.
"""
from __future__ import annotations

from ...base import MXNetError

__all__ = ["get_model_file"]


def get_model_file(name, root="~/.mxnet/models"):
    raise MXNetError("pretrained=True for %r needs a download of the "
                     "reference's weights, which the port does not do; "
                     "build the network and load a parameter file with "
                     "load_params" % name)
