"""Parallel execution: meshes, collectives, the SPMD train step,
sequence-parallel attention.

Counterpart of ``mxnet_tpu/parallel``. A ``dp`` axis may span several
Contexts in one process and the worker processes of a launched job
(``launch.py``); any other axis wider than one device raises
``MXNetError`` until ROADMAP Queue 1 item 4, second half.

- mesh:           ``Mesh``, ``make_mesh``, ``default_mesh``,
                  ``mesh_from_contexts``, ``barrier``, ``P``
- collectives:    ``all_reduce``, ``all_gather``, ``reduce_scatter``,
                  ``broadcast`` over ``torch.distributed``
- spmd:           ``SPMDTrainer``, ``shard_params_rule``, ``dp_spec``,
                  ``dist_dp_spec``, ``broadcast_from_zero``,
                  ``check_batch_divisible``
- opt_kernels:    pure optimizer kernels of the train step
- ring_attention: ``ring_attention`` (flash kernel K2 per ring step),
                  the plain ``attention`` and ``decode_attention``
- ulysses:        ``ulysses_attention`` (flash kernels K2 + K3)
"""
from .mesh import (Mesh, PartitionSpec, P, make_mesh, default_mesh,  # noqa: F401
                   mesh_from_contexts, barrier)
from . import collectives  # noqa: F401
from .spmd import (SPMDTrainer, shard_params_rule, dp_spec,  # noqa: F401
                   dist_dp_spec, broadcast_from_zero, check_batch_divisible)
from . import opt_kernels  # noqa: F401
from .ring_attention import ring_attention, attention, decode_attention  # noqa: F401
from .ulysses import ulysses_attention  # noqa: F401
