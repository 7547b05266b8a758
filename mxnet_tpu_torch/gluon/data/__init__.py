"""Gluon data: datasets, samplers, the DataLoader and the vision
datasets (parity: gluon.data)."""
from .dataset import *  # noqa: F401,F403
from .dataloader import *  # noqa: F401,F403
from .sampler import *  # noqa: F401,F403
from . import sampler  # noqa: F401
from . import vision  # noqa: F401
