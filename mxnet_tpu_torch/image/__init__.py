"""The image pipeline (parity: ``mxnet_tpu/image``, the reference's
``python/mxnet/image``)."""
from .image import *  # noqa: F401,F403
from . import detection  # noqa: F401
from .detection import *  # noqa: F401,F403
