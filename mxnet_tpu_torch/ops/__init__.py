"""Operator implementations; importing this package registers them."""
from . import nn, tensor, elemwise, reduce  # noqa: F401
from . import random_ops, rnn, optimizer_ops  # noqa: F401
from . import linalg, ctc, contrib, contrib_extra  # noqa: F401
from . import contrib_extra3, spatial  # noqa: F401
from . import shape_infer as _shape_infer

_shape_infer.install()
