"""Ring attention: sequence-parallel exact attention, on one device so far.

Counterpart of ``mxnet_tpu/parallel/ring_attention.py``. There Q stays
put while K/V blocks rotate around the ``sp`` mesh axis and each device
keeps an online-softmax accumulator ``(o, m, l)``. This slice runs meshes
of one device, where the ring has one step and no rotation: the local
block is the whole sequence, at offset 0 (a ``dp`` axis may span
processes: each runs its own batch rows). Rotating blocks between cards
comes with ROADMAP Queue 1 item 4, second half.

``attention`` and ``decode_attention`` are the plain versions, used for
correctness tests and by the decode path.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from ..kernels import flash_attention as _fa

__all__ = ["attention", "decode_attention", "ring_attention"]

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


# -- shared with ulysses -------------------------------------------------------

def _check_axes(fn, mesh, axis_name, batch_axis_name):
    for ax in (axis_name, batch_axis_name):
        if ax is not None and ax not in mesh.shape:
            raise MXNetError("%s: mesh has no axis %r (axes %s)"
                             % (fn, ax, tuple(mesh.shape)))
    n = mesh.shape[axis_name]
    if n != 1:
        raise MXNetError("%s over %d devices on %r: sequence parallelism "
                         "across devices is not ported yet (ROADMAP Queue 1 "
                         "item 4, second half)" % (fn, n, axis_name))


def _prepare(q, k, v, mesh):
    """Port NDArrays or tensors -> (tensors on the mesh's device, whether
    to wrap the result as an NDArray)."""
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


# -- the one-step ring -----------------------------------------------------------

def _ring_plain(q, k, v, causal, scale):
    """The plain online-softmax ring (``:112-137``) for one step."""
    s = q.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    o = torch.zeros_like(q)
    m = torch.full_like(q[..., 0], NEG_INF)
    l = torch.zeros_like(q[..., 0])
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        pos = torch.arange(s, device=q.device)
        scores = torch.where(pos[:, None] >= pos[None, :], scores, NEG_INF)
    new_m = torch.maximum(m, scores.amax(-1))
    correction = torch.exp(m - new_m)
    p = torch.exp(scores - new_m[..., None])
    l = l * correction + p.sum(-1)
    o = o * correction[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v)
    return o / torch.clamp_min(l, 1e-30)[..., None]


class _RingFlash(torch.autograd.Function):
    """Forward: one K2 carry call from the empty accumulator, then the
    normalisation (``_ring_flash_fwd_impl`` :140-169). Backward: the ring
    backward (``_ring_flash_bwd`` :183-229) in plain PyTorch — the
    reference wrote no kernel for it."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        b, h, s, d = q.shape
        bh = b * h
        flat = lambda x: x.reshape(bh, s, d).contiguous()  # noqa: E731
        o0 = torch.zeros((bh, s, d), dtype=torch.float32, device=q.device)
        m0 = torch.full((bh, s), NEG_INF, dtype=torch.float32,
                        device=q.device)
        l0 = torch.zeros((bh, s), dtype=torch.float32, device=q.device)
        o, m, l = _fa.flash_attention_carry(flat(q), flat(k), flat(v), o0, m0,
                                            l0, q_offset=0, kv_offset=0,
                                            causal=causal, scale=scale)
        l = torch.clamp_min(l, 1e-30)
        out = (o / l[..., None]).to(q.dtype).reshape(b, h, s, d)
        lse = m + torch.log(l)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        b, h, s, d = q.shape
        bh = b * h
        f32 = torch.float32
        flat = lambda x: x.reshape(bh, s, d).to(f32)  # noqa: E731
        qf, gf, of, kf, vf = flat(q), flat(g), flat(out), flat(k), flat(v)
        delta = (gf * of).sum(-1)
        sc = torch.einsum("bqd,bkd->bqk", qf, kf) * ctx.scale
        if ctx.causal:
            pos = torch.arange(s, device=q.device)
            sc = torch.where(pos[:, None] >= pos[None, :], sc, NEG_INF)
        p = torch.exp(sc - lse[..., None])
        dp = torch.einsum("bqd,bkd->bqk", gf, vf)
        ds = p * (dp - delta[..., None]) * ctx.scale
        dq = torch.einsum("bqk,bkd->bqd", ds, kf)
        dk = torch.einsum("bqk,bqd->bkd", ds, qf)
        dv = torch.einsum("bqk,bqd->bkd", p, gf)
        return (dq.reshape(b, h, s, d).to(q.dtype),
                dk.reshape(b, h, s, d).to(k.dtype),
                dv.reshape(b, h, s, d).to(v.dtype), None, None)


def ring_attention(q, k, v, mesh, axis_name="sp", batch_axis_name=None,
                   causal=False, scale=None, use_pallas=None):
    """Sequence-parallel attention: q/k/v (B, H, S, D) laid out along S
    over ``axis_name`` (and along B over ``batch_axis_name``) of a
    one-device mesh. Accepts port NDArrays or tensors (moved to the
    mesh's device) and returns the same kind.

    ``use_pallas`` picks the flash kernel K2 for the local block (with
    the plain ring backward); False picks the plain online-softmax loop;
    None (default) means the kernel for CUDA tensors and the plain loop
    for CPU tensors — the counterpart of "Pallas on a real TPU". The
    reference's operator tuner, which measures both on the TPU, is not
    ported.
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
    if use_pallas:
        out = _RingFlash.apply(q, k, v, causal, scale)
    else:
        out = _ring_plain(q, k, v, causal, scale)
    return _finish(out, wrap)
