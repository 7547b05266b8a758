"""Module API (parity: python/mxnet/module/__init__.py).

Counterpart of ``mxnet_tpu/module/``: ``BaseModule`` (``fit``, ``score``,
``forward_backward``, ``fused_step``), ``Module`` and ``BucketingModule``
on one device and the ``DataParallelExecutorGroup`` facade.
``SequentialModule`` and ``PythonModule`` are not ported yet.
"""
from .base_module import BaseModule, FusedFallback, FUSED_FALLBACK_CODES
from .module import Module
from .bucketing_module import BucketingModule
from . import executor_group
from .executor_group import DataParallelExecutorGroup
