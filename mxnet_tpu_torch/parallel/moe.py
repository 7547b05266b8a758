"""Expert parallelism: a mixture-of-experts FFN with all-to-all dispatch.

Counterpart of ``mxnet_tpu/parallel/moe.py``: top-1 switch routing,
fixed-capacity per-expert buffers (a token past its expert's capacity is
dropped and contributes zeros), one expert per member of the ``ep`` axis,
one ``all_to_all`` to the experts and one back, the router's probability
scaling the combined output. Each member runs :func:`moe_ffn` on its own
tokens.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from . import collectives as C
from .mesh import PartitionSpec as P

__all__ = ["moe_ffn", "route", "PARTITION_RULES"]

# The layer's layout as a partition-rule set (``mxnet_tpu`` ``:36-40``):
# the router replicates; expert weight stacks shard their leading expert
# axis over ``ep``.
PARTITION_RULES = [
    (r"router", P()),
    (r"expert_w[12]$", P("ep")),
    (r"expert", P("ep")),
]


def route(x, router_w, n, capacity):
    """Top-1 routing of tokens ``x`` (T, E) over ``n`` experts
    (``_local_moe`` :50-60): ``(expert, gate, position, keep)`` per token,
    the position counting the tokens before it routed to the same expert
    (``torch.argmax``, like ``jnp.argmax``, takes the first maximum)."""
    f32 = torch.float32
    logits = x.to(f32) @ router_w.T.to(f32)
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(probs, dim=-1)
    gate = probs.gather(-1, expert[:, None])[:, 0]
    onehot = torch.nn.functional.one_hot(expert, n).to(f32)
    pos = ((torch.cumsum(onehot, dim=0) - 1.0) * onehot).sum(-1) \
        .to(torch.int64)
    return expert, gate, pos, pos < capacity


def _local_moe(x, wr, w1, w2, group, capacity):
    """One member's body (``:43-84``): x (T, E) its tokens, wr (n, E) the
    router, w1 (F, E) / w2 (E, F) its expert."""
    n = group.size
    t, e = x.shape
    f32 = torch.float32
    expert, gate, pos, keep = route(x, wr, n, capacity)
    idx_e = torch.where(keep, expert, 0)
    idx_c = torch.where(keep, pos, 0)
    contrib = torch.where(keep[:, None], x, torch.zeros_like(x))
    buf = torch.zeros((n * capacity, e), dtype=x.dtype, device=x.device)
    buf = buf.index_add(0, idx_e * capacity + idx_c, contrib)
    recv = C.all_to_all(buf.reshape(n, capacity, e), group, 0, 0)
    h = torch.relu(recv.reshape(n * capacity, e).to(f32) @ w1.T)
    y = (h @ w2.T).to(x.dtype).reshape(n, capacity, e)
    back = C.all_to_all(y, group, 0, 0).reshape(n * capacity, e)
    out = back[idx_e * capacity + idx_c]
    out = torch.where(keep[:, None], out, torch.zeros_like(out))
    return out * gate[:, None].to(x.dtype)


def moe_ffn(x, router_w, expert_w1, expert_w2, mesh, axis_name="ep",
            capacity_factor=1.25):
    """Top-1 MoE feed-forward over an expert-parallel mesh axis.

    x: (B, T, E), the calling member's rows (the JAX function takes the
    global batch, split over ``axis_name``); router_w (n_exp, E); the
    member's expert as expert_w1 (1, F, E) / expert_w2 (1, E, F) (or the
    whole stacks (n_exp, F, E) / (n_exp, E, F), of which it takes its
    own). n_exp must equal the axis size. Returns the member's (B, T, E)
    block of the output. Capacity is ``max(1, int(capacity_factor *
    local_tokens / n))`` as in the JAX package; dropped tokens give
    zeros. Differentiable in every input.
    """
    from ..ndarray.ndarray import NDArray
    wrap = isinstance(x, NDArray)
    xr, wr, w1, w2 = [a._data if isinstance(a, NDArray) else a
                      for a in (x, router_w, expert_w1, expert_w2)]
    n = mesh.shape[axis_name]
    group = mesh.group(axis_name)
    if wr.shape[0] != n or w1.shape[0] not in (1, n) \
            or w2.shape[0] != w1.shape[0]:
        raise MXNetError("moe_ffn: router %s / experts %s, %s for a %r axis "
                         "of size %d" % (tuple(wr.shape), tuple(w1.shape),
                                         tuple(w2.shape), axis_name, n))
    if w1.shape[0] == n and n > 1:
        w1, w2 = w1[group.index], w2[group.index]
    else:
        w1, w2 = w1[0], w2[0]
    b, t, e = xr.shape
    local_tokens = b * t
    capacity = max(1, int(capacity_factor * local_tokens / n))
    out = _local_moe(xr.reshape(b * t, e), wr, w1, w2, group, capacity) \
        .reshape(b, t, e)
    return NDArray(out) if wrap else out
