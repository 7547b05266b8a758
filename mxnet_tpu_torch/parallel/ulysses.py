"""Ulysses (all-to-all) sequence parallelism, on one device so far.

Counterpart of ``mxnet_tpu/parallel/ulysses.py``. There an
``all_to_all`` over the ``sp`` axis re-shards q/k/v from the sequence
axis to the head axis, each device runs full-sequence attention for its
heads, and a second ``all_to_all`` restores sequence sharding. On a
one-device ``sp`` axis both all_to_alls are identities, so what remains
is the local attention: :func:`~..kernels.flash_attention.flash_attention`
(K2 forward, K3 backward) or the plain ``attention``.
"""
from __future__ import annotations

from ..base import MXNetError
from ..kernels.flash_attention import flash_attention
from .ring_attention import _check_axes, _finish, _prepare
from .ring_attention import attention as _plain_attention

__all__ = ["ulysses_attention"]


def ulysses_attention(q, k, v, mesh, axis_name="sp", batch_axis_name=None,
                      causal=False, scale=None, use_pallas=None):
    """All-to-all sequence-parallel attention.

    q/k/v: (B, H, S, D) laid out along S over ``axis_name`` (optionally
    along B over ``batch_axis_name``); H must divide evenly by the
    ``axis_name`` size. Returns the same layout and kind (port NDArray or
    tensor). ``use_pallas``: the flash kernels (True), the plain
    attention (False), or None — the kernels for CUDA tensors and the
    plain attention for CPU tensors.
    """
    n = mesh.shape[axis_name]
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
    if use_pallas:
        out = flash_attention(q, k, v, causal=causal, scale=scale)
    else:
        out = _plain_attention(q, k, v, causal=causal, scale=scale)
    return _finish(out, wrap)
