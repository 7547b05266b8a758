"""Parallel execution: meshes, collectives, partition rules, the SPMD
train step, sequence, expert and pipeline parallelism.

Counterpart of ``mxnet_tpu/parallel``. Any mesh axis may span several
Contexts in one process (one thread per Context) and the worker
processes of a launched job (``launch.py``); members meet in collectives
over each axis (``mesh.py``).

- mesh:           ``Mesh``, ``AxisGroup``, ``make_mesh``,
                  ``default_mesh``, ``mesh_from_contexts``, ``barrier``,
                  ``P``
- collectives:    ``all_reduce``, ``all_gather``, ``reduce_scatter``,
                  ``broadcast``, ``ppermute``, ``all_to_all``
- partition:      ``PartitionRules``, ``UNMATCHED_*``, ``Placement``,
                  ``partition_summary``
- spmd:           ``SPMDTrainer``, ``shard_params_rule``,
                  ``DataParallelSpec``, ``dp_spec``, ``rule_spec``,
                  ``dist_dp_spec``, ``shard_put``, ``broadcast_from_zero``,
                  ``check_batch_divisible``
- opt_kernels:    pure optimizer kernels of the train step
- ring_attention: ``ring_attention`` (flash kernel K2 per ring step),
                  the plain ``attention`` and ``decode_attention``
- ulysses:        ``ulysses_attention`` (flash kernels K2 + K3)
- moe:            ``moe_ffn``
- pipeline:       ``pipeline_apply``

The JAX package's ``shard_map`` (and its ``compat`` module) is JAX's own
API: here every member runs the per-device code itself.
"""
from .mesh import (Mesh, AxisGroup, PartitionSpec, P, make_mesh,  # noqa: F401
                   default_mesh, mesh_from_contexts, barrier)
from . import collectives  # noqa: F401
from .collectives import (all_reduce, all_gather, reduce_scatter,  # noqa: F401
                          ppermute, all_to_all)
from .spmd import (SPMDTrainer, shard_params_rule, DataParallelSpec,  # noqa: F401
                   dp_spec, rule_spec, dist_dp_spec, broadcast_from_zero,
                   check_batch_divisible, shard_put, DP_AXIS, MP_AXIS)
from .partition import (PartitionRules, UNMATCHED_REPLICATE,  # noqa: F401
                        UNMATCHED_ERROR, Placement, partition_summary)
from . import opt_kernels  # noqa: F401
from .ring_attention import ring_attention, attention, decode_attention  # noqa: F401
from .ulysses import ulysses_attention  # noqa: F401
from .moe import moe_ffn  # noqa: F401
from .pipeline import pipeline_apply  # noqa: F401
