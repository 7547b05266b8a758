"""Parallel execution: meshes, the SPMD train step, sequence-parallel
attention.

Counterpart of ``mxnet_tpu/parallel``. This slice runs on one device: a
mesh of more than one device raises ``MXNetError`` until the distributed
slice (ROADMAP queue 6).

- mesh:           ``Mesh``, ``make_mesh``, ``default_mesh``, ``P``
- spmd:           ``SPMDTrainer``, ``shard_params_rule``
- opt_kernels:    pure optimizer kernels of the train step
- ring_attention: ``ring_attention`` (flash kernel K2 per ring step),
                  the plain ``attention`` and ``decode_attention``
- ulysses:        ``ulysses_attention`` (flash kernels K2 + K3)
"""
from .mesh import Mesh, PartitionSpec, P, make_mesh, default_mesh  # noqa: F401
from .spmd import SPMDTrainer, shard_params_rule  # noqa: F401
from . import opt_kernels  # noqa: F401
from .ring_attention import ring_attention, attention, decode_attention  # noqa: F401
from .ulysses import ulysses_attention  # noqa: F401
