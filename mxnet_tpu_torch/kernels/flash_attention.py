"""Flash attention: the online-softmax carry (K2) and the backward (K3).

Counterpart of ``mxnet_tpu/pallas/flash_attention.py``:

* :func:`flash_attention_carry` merges one K/V block into an
  online-softmax accumulator ``(o, m, l)`` with causal masking by global
  offsets — the building block ``parallel.ring_attention`` chains;
* :func:`flash_attention` is exact attention on ``(B, H, S, D)``,
  differentiable: its forward is K2 with the normalisation in the
  kernel's epilogue, its backward is K3.

Each dispatches on the tensor's device:

* CUDA — the hand-written kernels of ``csrc/flash_attention.cu`` (built
  by ``_build``, bound through ``ctypes``); every call that launches K2
  adds one to :data:`fwd_launches`, every call that launches K3 (its two
  kernels, dk/dv and dq) adds one to :data:`bwd_launches`;
* CPU — the plain PyTorch versions :func:`flash_attention_carry_reference`
  and :func:`flash_attention_bwd_reference`; with ``matmul=matmul_3xtf32``
  (every product taken as hi·hi + hi·lo + lo·hi of :func:`split_tf32`'s
  parts) and, in the backward, ``ps_dtype=torch.bfloat16`` they repeat the
  kernels' own numerics, so the CPU tests can hold those against JAX;
* ``meta`` — empty outputs of the right shapes.

For a CUDA tensor the wrapper launches the kernel or raises; it never
falls back to the plain version. Not carried over: the operator tuner's
``block_q`` choice (``block_q`` is accepted and does not change the
result: the kernels use their own 64- and 128-row tiles), so
``tuner.tuned_choice`` has no call site here (the JAX package's chooses
between the Pallas kernel and a plain composition, and the port runs no
plain version on the card), and the ``MXTPU_FLASH_BWD=xla`` switch (on a
CUDA tensor the backward is K3).
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from . import _build

__all__ = ["flash_attention", "flash_attention_carry",
           "flash_attention_forward", "flash_attention_bwd",
           "flash_attention_carry_reference", "flash_attention_bwd_reference",
           "split_tf32", "matmul_3xtf32",
           "NEG_INF", "fwd_launches", "bwd_launches"]

DEFAULT_BLOCK_Q = 128
NEG_INF = -1e30
MAX_HEAD_DIM = 128

# kernel launches so far (CUDA path only); callers reset them to 0
fwd_launches = 0     # K2
bwd_launches = 0     # K3

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_F32 = torch.float32


def _scale(scale, d):
    return scale if scale is not None else 1.0 / math.sqrt(d)


# -- the kernels' fp32 numerics, in plain PyTorch ----------------------------

def split_tf32(x):
    """An fp32 tensor as ``(hi, lo)``: ``hi`` keeps the top 10 of the 23
    mantissa bits, rounded to nearest with ties away from zero on the low
    13 (integer add of half a unit, then mask), and ``lo`` is the same
    rounding of ``x - hi``. The fp32 kernels split every operand this way
    (``csrc/hopper_mma.cuh:split_tf32``)."""
    def tf32(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(_F32)
    hi = tf32(x.to(_F32))
    return hi, tf32(x.to(_F32) - hi)


def matmul_3xtf32(a, b):
    """``a @ b`` as the fp32 kernels take it on tf32 tensor cores:
    lo·hi + hi·lo + hi·hi of the :func:`split_tf32` parts (the lo·lo term
    dropped). Each product of two tf32 values is exact in fp32."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_lo)) \
        + torch.matmul(a_hi, b_hi)


# -- plain versions ---------------------------------------------------------

def flash_attention_carry_reference(q, k, v, o, m, l, q_offset=0,
                                    kv_offset=0, causal=False, scale=None,
                                    matmul=torch.matmul):
    """The plain PyTorch version of K2: ``_attn_kernel``
    (``mxnet_tpu/pallas/flash_attention.py:83-126``) over the whole local
    block at once. Products in fp32 (bf16 widens exactly) through
    ``matmul``; p is rounded to ``v.dtype`` before ``p @ v``."""
    s_q, s_kv = q.shape[1], k.shape[1]
    scale = _scale(scale, q.shape[-1])
    scores = matmul(q.to(_F32), k.to(_F32).transpose(-1, -2)) * scale
    q_pos = q_offset + torch.arange(s_q, device=q.device)[:, None]
    k_pos = kv_offset + torch.arange(s_kv, device=q.device)[None, :]
    mask = k_pos < kv_offset + s_kv
    if causal:
        mask = mask & (q_pos >= k_pos)
    scores = torch.where(mask, scores, NEG_INF)
    blk_max = scores.amax(-1) if s_kv else torch.full_like(m, NEG_INF)
    m_new = torch.maximum(m, blk_max)
    corr = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    p = torch.where(mask, p, 0.0)
    l_new = l * corr + p.sum(-1)
    pv = matmul(p.to(v.dtype).to(_F32), v.to(_F32))
    return o * corr[..., None] + pv, m_new, l_new


def flash_attention_bwd_reference(q, k, v, g, lse, delta, causal=False,
                                  scale=None, matmul=torch.matmul,
                                  ps_dtype=None):
    """The plain PyTorch version of K3: ``_bwd_kernel``
    (``mxnet_tpu/pallas/flash_attention.py:261-305``) over the whole
    sequence, on ``(BH, S, D)``; returns fp32 ``(dq, dk, dv)``. As in the
    kernel, p is 0 where the causal mask is false (the reference relies
    on ``exp(NEG_INF - lse)`` underflowing, the same value wherever a row
    has a visible key). Products through ``matmul``; with ``ps_dtype``,
    p and ds are rounded to that type as operands of dv, dq and dk (ds
    itself is computed from the unrounded p), as the bf16 kernel does."""
    s_q, s_kv = q.shape[1], k.shape[1]
    scale = _scale(scale, q.shape[-1])
    qf, kf, vf, gf = (t.to(_F32) for t in (q, k, v, g))
    s = matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        q_pos = torch.arange(s_q, device=q.device)[:, None]
        k_pos = torch.arange(s_kv, device=q.device)[None, :]
        p = torch.where(q_pos >= k_pos, p, 0.0)
    dp = matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    if ps_dtype is not None:
        p, ds = p.to(ps_dtype).to(_F32), ds.to(ps_dtype).to(_F32)
    dv = matmul(p.transpose(-1, -2), gf)
    dq = matmul(ds, kf)
    dk = matmul(ds.transpose(-1, -2), qf)
    return dq, dk, dv


# -- checks -----------------------------------------------------------------

def _check_qkv(fn, q, k, v):
    if q.dtype not in _DTYPE_CODES:
        raise MXNetError("%s: dtype %s not supported (float32, bfloat16)"
                         % (fn, q.dtype))
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise MXNetError("%s: q/k/v must be (BH, S, D), got %s %s %s"
                         % (fn, tuple(q.shape), tuple(k.shape),
                            tuple(v.shape)))
    bh, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise MXNetError("%s: k %s / v %s do not match q %s"
                         % (fn, tuple(k.shape), tuple(v.shape),
                            tuple(q.shape)))
    if not 1 <= d <= MAX_HEAD_DIM:
        raise MXNetError("%s: head dim %d not in [1, %d]"
                         % (fn, d, MAX_HEAD_DIM))
    for nm, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise MXNetError("%s: %s is %s on %s, q is %s on %s"
                             % (fn, nm, t.dtype, t.device, q.dtype,
                                q.device))


def _check_f32(fn, named, shape, device):
    for nm, t in named:
        if t.dtype != _F32 or tuple(t.shape) != shape \
                or t.device != device:
            raise MXNetError("%s: %s must be float32 %s on %s, got %s %s on "
                             "%s" % (fn, nm, shape, device, t.dtype,
                                     tuple(t.shape), t.device))


def _check_kernel_input(fn, named):
    """What only the CUDA path needs: contiguous row-major tensors, and a
    batch*heads count the grid can hold."""
    for nm, t in named:
        if not t.is_contiguous():
            raise MXNetError("%s: %s must be contiguous (row-major), got "
                             "strides %s" % (fn, nm, t.stride()))
    bh = named[0][1].shape[0]
    if bh > 65535:
        raise MXNetError("%s: batch*heads %d over the kernel's grid limit "
                         "65535" % (fn, bh))


def _device_kind(fn, t):
    dev = t.device.type
    if dev not in ("meta", "cpu", "cuda"):
        raise MXNetError("%s: no kernel for device %s" % (fn, t.device))
    return dev


# -- K2 ---------------------------------------------------------------------

def flash_attention_carry(q, k, v, o, m, l, q_offset=0, kv_offset=0,
                          causal=False, scale=None,
                          block_q=DEFAULT_BLOCK_Q):
    """Merge one K/V block into an online-softmax accumulator.

    q: (BH, Sq, D); k/v: (BH, Skv, D), float32 or bfloat16; o: (BH, Sq, D)
    float32 numerator; m/l: (BH, Sq) float32 running max / denominator.
    ``q_offset``/``kv_offset`` are the global positions of row 0 and key 0
    (causal masking). Returns new ``(o, m, l)``; the caller normalises
    ``o / l`` after the last block. ``block_q`` does not change the
    result.
    """
    fn = "flash_attention_carry"
    _check_qkv(fn, q, k, v)
    bh, s_q, d = q.shape
    _check_f32(fn, (("o", o),), (bh, s_q, d), q.device)
    _check_f32(fn, (("m", m), ("l", l)), (bh, s_q), q.device)
    dev = _device_kind(fn, q)
    if dev == "meta":
        return (torch.empty_like(o), torch.empty_like(m),
                torch.empty_like(l))
    if dev == "cpu":
        return flash_attention_carry_reference(q, k, v, o, m, l, q_offset,
                                               kv_offset, causal, scale)
    _check_kernel_input(fn, (("q", q), ("k", k), ("v", v), ("o", o),
                             ("m", m), ("l", l)))
    o2, m2, l2 = torch.empty_like(o), torch.empty_like(m), torch.empty_like(l)
    _launch_fwd(q, k, v, (o, m, l), (o2, m2, l2), None, q_offset, kv_offset,
                causal, _scale(scale, d))
    return o2, m2, l2


def _flash_fwd(q, k, v, causal, scale):
    """(BH, S, D) -> (out in q.dtype, lse float32): K2 from the empty
    carry with the normalisation (``_forward`` :227-228) in its
    epilogue."""
    fn = "flash_attention"
    _check_qkv(fn, q, k, v)
    bh, s_q, d = q.shape
    dev = _device_kind(fn, q)
    if dev == "meta":
        return (torch.empty_like(q),
                torch.empty((bh, s_q), dtype=_F32, device=q.device))
    if dev == "cpu":
        o0 = torch.zeros((bh, s_q, d), dtype=_F32)
        m0 = torch.full((bh, s_q), NEG_INF, dtype=_F32)
        l0 = torch.zeros((bh, s_q), dtype=_F32)
        o, m, l = flash_attention_carry_reference(q, k, v, o0, m0, l0, 0, 0,
                                                  causal, scale)
        l = torch.clamp_min(l, 1e-30)
        return (o / l[..., None]).to(q.dtype), m + torch.log(l)
    _check_kernel_input(fn, (("q", q), ("k", k), ("v", v)))
    out = torch.empty_like(q)
    lse = torch.empty((bh, s_q), dtype=_F32, device=q.device)
    _launch_fwd(q, k, v, None, None, (out, lse), 0, 0, causal,
                _scale(scale, d))
    return out, lse


def _launch_fwd(q, k, v, carry_in, carry_out, final, q_offset, kv_offset,
                causal, scale):
    global fwd_launches
    bh, s_q, d = q.shape
    if s_q == 0:
        return
    lib = _bind()
    o_in, m_in, l_in = carry_in if carry_in is not None else (None,) * 3
    o_out, m_out, l_out = carry_out if carry_out is not None else (None,) * 3
    out, lse = final if final is not None else (None, None)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mx_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(o_in), ptr(m_in),
            ptr(l_in), ptr(o_out), ptr(m_out), ptr(l_out), ptr(out), ptr(lse),
            bh, s_q, k.shape[1], d, int(q_offset), int(kv_offset),
            int(bool(causal)), float(scale), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise MXNetError("flash attention forward: kernel launch failed "
                         "(cudaError %d)" % err)
    fwd_launches += 1


# -- K3 ---------------------------------------------------------------------

def flash_attention_bwd(q, k, v, g, lse, delta, causal=False, scale=None):
    """The flash backward on ``(BH, S, D)``: from q/k/v, the output
    gradient g (same type and shape as q), the forward's float32 ``lse``
    and ``delta = rowsum(g * out)`` (both (BH, Sq)), returns
    ``(dq, dk, dv)`` in the input type."""
    global bwd_launches
    fn = "flash_attention_bwd"
    _check_qkv(fn, q, k, v)
    bh, s_q, d = q.shape
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise MXNetError("%s: g is %s %s on %s, q is %s %s on %s"
                         % (fn, g.dtype, tuple(g.shape), g.device, q.dtype,
                            tuple(q.shape), q.device))
    _check_f32(fn, (("lse", lse), ("delta", delta)), (bh, s_q), q.device)
    dev = _device_kind(fn, q)
    if dev == "meta":
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dev == "cpu":
        grads = flash_attention_bwd_reference(q, k, v, g, lse, delta, causal,
                                              scale)
        return tuple(t.to(q.dtype) for t in grads)
    _check_kernel_input(fn, (("q", q), ("k", k), ("v", v), ("g", g),
                             ("lse", lse), ("delta", delta)))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _bind()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mx_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), bh, s_q, k.shape[1], d, int(bool(causal)),
            float(_scale(scale, d)), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise MXNetError("flash attention backward: kernel launch failed "
                         "(cudaError %d)" % err)
    bwd_launches += 1
    return dq, dk, dv


# -- the differentiable entry -------------------------------------------------

def _flat(x):
    b, h, s, d = x.shape
    return x.reshape(b * h, s, d).contiguous()


def flash_attention_forward(q, k, v, causal=False, scale=None):
    """(B, H, S, D) -> ``(out, lse)``, lse (B, H, Sq) float32."""
    b, h, s_q, d = q.shape
    out, lse = _flash_fwd(_flat(q), _flat(k), _flat(v), causal,
                          _scale(scale, d))
    return out.reshape(b, h, s_q, d), lse.reshape(b, h, s_q)


class _FlashAttention(torch.autograd.Function):
    """Saves the flattened ``(q, k, v, out, lse)``; the backward computes
    ``delta = rowsum(g * out)`` in float32 and runs K3."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        qf, kf, vf = _flat(q), _flat(k), _flat(v)
        scale = _scale(scale, q.shape[-1])
        out, lse = _flash_fwd(qf, kf, vf, causal, scale)
        ctx.save_for_backward(qf, kf, vf, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.shapes = (q.shape, k.shape)
        return out.reshape(q.shape)

    @staticmethod
    def backward(ctx, g):
        qf, kf, vf, out, lse = ctx.saved_tensors
        q_shape, k_shape = ctx.shapes
        gf = _flat(g.to(qf.dtype))
        delta = (gf.to(_F32) * out.to(_F32)).sum(-1)
        dq, dk, dv = flash_attention_bwd(qf, kf, vf, gf, lse, delta,
                                         ctx.causal, ctx.scale)
        return (dq.reshape(q_shape), dk.reshape(k_shape),
                dv.reshape(k_shape), None, None)


def flash_attention(q, k, v, causal=False, scale=None, block_q=None):
    """Exact attention, (B, H, S, D) layout, differentiable: forward K2,
    backward K3 (on CUDA tensors; their plain versions on CPU tensors).
    ``block_q`` is accepted and does not change the result."""
    if q.ndim != 4:
        raise MXNetError("flash_attention: q must be (B, H, S, D), got %s"
                         % (tuple(q.shape),))
    return _FlashAttention.apply(q, k, v, causal, scale)


def _bind():
    import ctypes
    lib = _build.load("flash_attention")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fwd, bwd = lib.mx_flash_attention_fwd, lib.mx_flash_attention_bwd
    if fwd.argtypes is None:
        fwd.argtypes = [p] * 11 + [i64, i64, i64, i32, i64, i64, i32,
                                   ctypes.c_float, i32, p]
        fwd.restype = i32
        bwd.argtypes = [p] * 9 + [i64, i64, i64, i32, i32, ctypes.c_float,
                                  i32, p]
        bwd.restype = i32
    return lib
