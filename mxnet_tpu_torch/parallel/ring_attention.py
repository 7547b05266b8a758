"""Ring attention: sequence-parallel exact attention over a ring of members.

Counterpart of ``mxnet_tpu/parallel/ring_attention.py``. Q stays put
while K/V blocks rotate around the ``sp`` axis (``ppermute`` to the next
member) and each member keeps an online-softmax accumulator
``(o, m, l)``. With ``n`` members, ring step ``t`` merges the block of
member ``src = (my - t) mod n`` at global offsets ``q_offset = my * S``,
``kv_offset = src * S``: its own block first, so the running max is
finite before a block that the causal mask hides completely arrives.

``attention`` and ``decode_attention`` are the plain versions, used for
correctness tests and by the decode path.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from ..kernels import flash_attention as _fa
from . import collectives as C
from .mesh import PartitionSpec as P

__all__ = ["attention", "decode_attention", "ring_attention",
           "PARTITION_RULES", "DECODE_PARTITION_RULES"]

NEG_INF = -1e30


def attention(q, k, v, causal=False, scale=None, q_offset=0, kv_offset=0):
    """Plain scaled-dot-product attention, (B, H, S, D) layout.

    ``q_offset``/``kv_offset`` give the global sequence positions of the
    local blocks (used by ring attention's causal masking).
    """
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        qpos = torch.arange(q.shape[2], device=q.device) + q_offset
        kpos = torch.arange(k.shape[2], device=q.device) + kv_offset
        mask = qpos[:, None] >= kpos[None, :]
        scores = torch.where(mask, scores, -math.inf)
    probs = torch.softmax(scores, dim=-1)
    # rows that are fully masked produce NaN from softmax(-inf); zero them
    if causal:
        probs = torch.where(torch.isfinite(scores).any(-1, keepdim=True),
                            probs, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def decode_attention(q, k_cache, v_cache, length, scale=None):
    """Single-query attention against a KV cache: ``q`` (..., H, D),
    ``k_cache``/``v_cache`` (..., H, T, D) with positions ``[0, length)``
    valid; returns (..., H, D). ``length`` is an int or a tensor of the
    leading dims' shape, one length per row (the decode engine's batched
    step gives each slot its own). A fully masked row (``length == 0``)
    is 0."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    scores = torch.einsum("...hd,...htd->...ht", q, k_cache) * scale
    pos = torch.arange(k_cache.shape[-2], device=q.device)
    length = torch.as_tensor(length, device=q.device)
    scores = torch.where(pos < length[..., None, None], scores, -math.inf)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(torch.isfinite(scores).any(-1, keepdim=True), probs,
                        0.0)
    return torch.einsum("...ht,...htd->...hd", probs, v_cache)


# The ring layout as a partition-rule set (``mxnet_tpu`` ``:33-44``):
# sequence parallelism shards activations; the projections feeding it
# stay replicated.
PARTITION_RULES = [(r".*", P())]

# The decode layout (``:46-59``): the KV cache and head-major
# projections shard their heads over ``mp``.
DECODE_PARTITION_RULES = [
    (r"cache/(k|v)$", P(None, "mp", None, None)),
    (r"w(q|k|v)$", P(None, "mp", None)),
    (r"wo$", P("mp", None, None)),
    (r".*", P()),
]


# -- shared with ulysses -------------------------------------------------------

def _check_axes(fn, mesh, axis_name, batch_axis_name):
    for ax in (axis_name, batch_axis_name):
        if ax is not None and ax not in mesh.shape:
            raise MXNetError("%s: mesh has no axis %r (axes %s)"
                             % (fn, ax, tuple(mesh.shape)))


def _prepare(q, k, v, mesh):
    """Port NDArrays or tensors -> (tensors on the calling member's
    device, whether to wrap the result as an NDArray)."""
    from ..ndarray.ndarray import NDArray
    wrap = isinstance(q, NDArray)
    dev = mesh.torch_device()
    raw = [(x._data if isinstance(x, NDArray) else x).to(dev)
           for x in (q, k, v)]
    return raw, wrap


def _finish(out, wrap):
    if not wrap:
        return out
    from ..ndarray.ndarray import NDArray
    return NDArray(out)


def _ring(n):
    return [(i, (i + 1) % n) for i in range(n)]


# -- the plain ring --------------------------------------------------------------

def _ring_plain(q, k, v, group, causal, scale):
    """The plain online-softmax ring (``:97-137``): differentiable
    through ``ppermute``; K and V travel stacked, one hop a step."""
    n, my = group.size, group.index
    s = q.shape[2]
    o = torch.zeros_like(q)
    m = torch.full_like(q[..., 0], NEG_INF)
    l = torch.zeros_like(q[..., 0])
    q_pos = my * s + torch.arange(s, device=q.device)
    kv = torch.stack([k, v])
    for t in range(n):
        src = (my - t) % n
        k_blk, v_blk = kv[0], kv[1]
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k_blk) * scale
        if causal:
            k_pos = src * s + torch.arange(s, device=q.device)
            scores = torch.where(q_pos[:, None] >= k_pos[None, :], scores,
                                 NEG_INF)
        new_m = torch.maximum(m, scores.amax(-1))
        correction = torch.exp(m - new_m)
        p = torch.exp(scores - new_m[..., None])
        l = l * correction + p.sum(-1)
        o = o * correction[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                     v_blk)
        m = new_m
        if t < n - 1:
            kv = C.ppermute(kv, group, _ring(n))
    return o / torch.clamp_min(l, 1e-30)[..., None]


# -- the kernel ring ----------------------------------------------------------------

class _RingFlash(torch.autograd.Function):
    """Forward (``_ring_flash_fwd_impl`` :140-169): one K2 carry launch
    per ring step, K/V rotating by ``ppermute`` between launches, then
    the normalisation. Backward (``_ring_flash_bwd`` :183-229): plain
    PyTorch, as in the reference, with dK/dV travelling with their blocks
    and home after ``n`` hops."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        n, my = group.size, group.index
        b, h, s, d = q.shape
        bh = b * h
        flat = lambda x: x.reshape(bh, s, d).contiguous()  # noqa: E731
        qf = flat(q)
        o = torch.zeros((bh, s, d), dtype=torch.float32, device=q.device)
        m = torch.full((bh, s), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((bh, s), dtype=torch.float32, device=q.device)
        kv = torch.stack([flat(k), flat(v)])
        for t in range(n):
            src = (my - t) % n
            o, m, l = _fa.flash_attention_carry(
                qf, kv[0], kv[1], o, m, l, q_offset=my * s,
                kv_offset=src * s, causal=causal, scale=scale)
            if t < n - 1:
                kv = C._ppermute(kv, group, _ring(n))
        l = torch.clamp_min(l, 1e-30)
        out = (o / l[..., None]).to(q.dtype).reshape(b, h, s, d)
        lse = m + torch.log(l)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group, scale = ctx.group, ctx.scale
        n, my = group.size, group.index
        b, h, s, d = q.shape
        bh = b * h
        f32 = torch.float32
        flat = lambda x: x.reshape(bh, s, d).to(f32)  # noqa: E731
        qf, gf, of = flat(q), flat(g), flat(out)
        delta = (gf * of).sum(-1)
        q_pos = my * s + torch.arange(s, device=q.device)
        dq = torch.zeros((bh, s, d), dtype=f32, device=q.device)
        # k, v, dk, dv of the block in hand, travelling together
        blk = torch.stack([flat(k), flat(v), torch.zeros_like(qf),
                           torch.zeros_like(qf)])
        for t in range(n):
            src = (my - t) % n
            kf, vf = blk[0], blk[1]
            sc = torch.einsum("bqd,bkd->bqk", qf, kf) * scale
            if ctx.causal:
                k_pos = src * s + torch.arange(s, device=q.device)
                sc = torch.where(q_pos[:, None] >= k_pos[None, :], sc,
                                 NEG_INF)
            p = torch.exp(sc - lse[..., None])
            dp = torch.einsum("bqd,bkd->bqk", gf, vf)
            ds = p * (dp - delta[..., None]) * scale
            dq = dq + torch.einsum("bqk,bkd->bqd", ds, kf)
            dk = blk[2] + torch.einsum("bqk,bqd->bkd", ds, qf)
            dv = blk[3] + torch.einsum("bqk,bqd->bkd", p, gf)
            if t < n - 1:
                blk = C._ppermute(torch.stack([kf, vf, dk, dv]), group,
                                  _ring(n))
            elif n > 1:
                blk = torch.cat([blk[:2], C._ppermute(
                    torch.stack([dk, dv]), group, _ring(n))])
            else:
                blk = torch.stack([kf, vf, dk, dv])
        return (dq.reshape(b, h, s, d).to(q.dtype),
                blk[2].reshape(b, h, s, d).to(k.dtype),
                blk[3].reshape(b, h, s, d).to(v.dtype), None, None, None)


def ring_attention(q, k, v, mesh, axis_name="sp", batch_axis_name=None,
                   causal=False, scale=None, use_pallas=None):
    """Sequence-parallel attention. q/k/v (B, H, S, D) are the calling
    member's blocks: its sequence positions ``[my*S, (my+1)*S)`` along
    ``axis_name`` (and its rows, when ``batch_axis_name`` splits them);
    returns its block of the output. The JAX function takes the global
    arrays and returns the global output; block for block the results
    are the same. Accepts port NDArrays or tensors (moved to the
    member's device) and returns the same kind.

    ``use_pallas`` picks the flash kernel K2 for every ring step (with
    the plain ring backward); False picks the plain online-softmax ring;
    None (default) means the kernel for CUDA tensors and the plain ring
    for CPU tensors — the counterpart of "Pallas on a real TPU". The
    JAX package's ``tuner.tuned_choice`` measures both on the TPU;
    ``tuner.OperatorTuner`` is ported but not called here, since the port
    runs no plain version of a kernel on the card.
    """
    _check_axes("ring_attention", mesh, axis_name, batch_axis_name)
    (q, k, v), wrap = _prepare(q, k, v, mesh)
    if not q.shape == k.shape == v.shape:
        raise MXNetError("ring_attention: q %s, k %s, v %s must have one "
                         "shape" % (tuple(q.shape), tuple(k.shape),
                                    tuple(v.shape)))
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if use_pallas is None:
        use_pallas = q.device.type == "cuda"
    group = mesh.group(axis_name)
    if use_pallas:
        out = _RingFlash.apply(q, k, v, group, causal, scale)
    else:
        out = _ring_plain(q, k, v, group, causal, scale)
    return _finish(out, wrap)
