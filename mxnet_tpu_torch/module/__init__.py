"""Module API (parity: python/mxnet/module/__init__.py).

Counterpart of ``mxnet_tpu/module/``: ``BaseModule`` (``fit``, ``score``,
``forward_backward``, ``fused_step``), ``Module`` and ``BucketingModule``
on one device, ``SequentialModule``, ``PythonModule`` and
``PythonLossModule``, and the ``DataParallelExecutorGroup`` facade.
"""
from .base_module import BaseModule, FusedFallback, FUSED_FALLBACK_CODES
from .module import Module
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule
from .python_module import PythonModule, PythonLossModule
from . import executor_group
from .executor_group import DataParallelExecutorGroup
