"""Model zoo (parity: python/mxnet/gluon/model_zoo)."""
from . import vision  # noqa: F401
from . import model_store  # noqa: F401
