"""Gluon: imperative blocks, hybridize, layers, recurrent layers and
cells, losses, the Trainer, the data pipeline and the model zoo."""
from .parameter import (Parameter, ParameterDict,  # noqa: F401
                        DeferredInitializationError)
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import nn  # noqa: F401
from . import rnn  # noqa: F401
from . import loss  # noqa: F401
from . import utils  # noqa: F401
from . import model_zoo  # noqa: F401
from . import data  # noqa: F401
from . import contrib  # noqa: F401
