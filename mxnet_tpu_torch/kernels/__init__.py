"""Hand-written Hopper kernels, one module per TPU kernel they replace.

Each module holds the kernel's wrapper, its plain PyTorch version and a
launch counter; ``_build`` compiles the CUDA sources in ``csrc/``.
"""
from . import fused_bn  # noqa: F401
from . import flash_attention  # noqa: F401
