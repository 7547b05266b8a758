"""Ulysses (all-to-all) sequence parallelism.

Counterpart of ``mxnet_tpu/parallel/ulysses.py``. Each member holds its
block of the sequence; one ``all_to_all`` over the ``sp`` axis re-shards
q/k/v from the sequence axis to the head axis (``seq_to_heads``), each
member runs full-sequence attention for its ``H / n`` heads —
:func:`~..kernels.flash_attention.flash_attention` (K2 forward, K3
backward) or the plain ``attention`` — and a second ``all_to_all``
restores sequence sharding (``heads_to_seq``). q, k and v travel stacked
in one ``all_to_all``.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..kernels.flash_attention import flash_attention
from . import collectives as C
from .mesh import PartitionSpec as P
from .ring_attention import _check_axes, _finish, _prepare
from .ring_attention import attention as _plain_attention

__all__ = ["ulysses_attention", "seq_to_heads", "heads_to_seq",
           "PARTITION_RULES"]

# The Ulysses layout as a partition-rule set (``mxnet_tpu`` ``:20-25``):
# head-major q/k/v producers shard dim 0 over ``sp``, the output
# projection consumes head-major dim 1; everything else replicates.
PARTITION_RULES = [
    (r"(q|k|v)_proj.*weight$", P("sp", None)),
    (r"out_proj.*weight$", P(None, "sp")),
    (r".*", P()),
]


def seq_to_heads(x, group):
    """(..., H, S/n, D) -> (..., H/n, S, D): split heads, gather the
    sequence (the last three axes)."""
    return C.all_to_all(x, group, split_axis=x.ndim - 3,
                        concat_axis=x.ndim - 2)


def heads_to_seq(x, group):
    """The inverse of :func:`seq_to_heads`."""
    return C.all_to_all(x, group, split_axis=x.ndim - 2,
                        concat_axis=x.ndim - 3)


def ulysses_attention(q, k, v, mesh, axis_name="sp", batch_axis_name=None,
                      causal=False, scale=None, use_pallas=None):
    """All-to-all sequence-parallel attention.

    q/k/v: (B, H, S, D), the calling member's block of the sequence along
    ``axis_name`` (and of the rows along ``batch_axis_name``); H must
    divide evenly by the ``axis_name`` size. Returns the member's block
    of the output, of the same kind (port NDArray or tensor); block for
    block the JAX function's result. ``use_pallas``: the flash kernels
    (True), the plain attention (False), or None — the kernels for CUDA
    tensors and the plain attention for CPU tensors.
    """
    n = mesh.shape[axis_name] if axis_name in mesh.shape else 1
    heads = q.shape[1]
    if heads % n != 0:
        raise MXNetError(
            "ulysses_attention: num_heads (%d) must be divisible by the "
            "'%s' axis size (%d) — use ring_attention for uneven heads"
            % (heads, axis_name, n))
    _check_axes("ulysses_attention", mesh, axis_name, batch_axis_name)
    (q, k, v), wrap = _prepare(q, k, v, mesh)
    if use_pallas is None:
        use_pallas = q.device.type == "cuda"
    group = mesh.group(axis_name)
    qkv = seq_to_heads(torch.stack([q, k, v]), group) if n > 1 \
        else torch.stack([q, k, v])
    attend = flash_attention if use_pallas else _plain_attention
    out = attend(qkv[0], qkv[1], qkv[2], causal=causal, scale=scale)
    if n > 1:
        out = heads_to_seq(out, group)
    return _finish(out, wrap)
