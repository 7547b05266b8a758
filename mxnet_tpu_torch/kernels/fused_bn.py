"""Fused BatchNorm-apply + residual-add + ReLU: the ResNet block tail.

Counterpart of ``mxnet_tpu/pallas/fused_bn.py``. The work is

    out = max(x * scale + bias [+ residual], 0)

over the channels-last ``(N*H*W, C)`` view, with ``scale``/``bias`` the
folded BN apply coefficients, so the whole tail reads ``x`` and
``residual`` once and writes ``out`` once.

:func:`scale_bias_add_relu` dispatches on the tensor's device:

* CUDA — the hand-written kernels of ``csrc/fused_bn.cu`` (built by
  ``_build``, bound through ``ctypes``) inside a ``torch.autograd.Function``:
  the forward and a one-pass backward. Each forward launch adds one to
  :data:`launches`, each backward call (its pass and its finishing
  kernel) one to :data:`bwd_launches`;
* CPU — :func:`scale_bias_add_relu_reference`, the plain PyTorch version,
  under the same ``torch.autograd.Function``, whose backward there is
  :func:`scale_bias_add_relu_backward` (as the JAX package runs its custom
  VJP in interpret mode too);
* ``meta`` — an empty output of the right shape (shape inference).

It never falls back from a kernel to the plain version, and never copies
an activation: an input the kernels do not take raises.

The kernels load 16-byte vectors where C and every pointer allow, and
single elements otherwise (a ragged C, offset views). The backward (the
TPU module's XLA ``_fused_vjp_bwd``, ``mxnet_tpu/pallas/fused_bn.py:100``):
with ``m = out > 0``, ``dx = g*m*scale``, ``dres = g*m``, ``dscale =
sum_rows(g*m*x)`` and ``dbias = sum_rows(g*m)`` reduced in fp32, one pass
that writes per-block partial sums and a finishing kernel that adds them
in a fixed order; the blocks (:func:`bwd_partition`) follow from the
shape alone, so a backward repeats bit for bit.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from . import _build

__all__ = ["scale_bias_add_relu", "scale_bias_add_relu_reference",
           "scale_bias_add_relu_backward", "bwd_partition",
           "launches", "bwd_launches", "strided_grads"]

# kernel launches so far (CUDA path only); callers reset them to 0
launches = 0         # forward
bwd_launches = 0     # backward calls, each two kernels (pass + finish)
# backward calls on CUDA tensors whose incoming gradient arrived strided
# (the wrapper makes it dense first)
strided_grads = 0

# the backward's target block count, two an SM of an H100: a constant, so
# the partition, and with it the order of the channel sums, follows from
# the shape alone
_BWD_BLOCKS = 264

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def scale_bias_add_relu_reference(x, scale, bias, residual=None):
    """The plain PyTorch version, op by op in ``x.dtype`` as the TPU
    module's composed chain is: scale/bias are cast to ``x.dtype`` first
    (``mxnet_tpu/pallas/fused_bn.py:88``)."""
    y = x * scale.to(x.dtype) + bias.to(x.dtype)
    if residual is not None:
        y = y + residual
    return torch.clamp_min(y, 0)


def _check(x, scale, bias, residual):
    """Every refusal of the wrapper, in one pass over the inputs' metadata
    (it runs on every launch: the device is read once)."""
    if x.dtype not in _DTYPE_CODES:
        raise MXNetError("scale_bias_add_relu: dtype %s not supported "
                         "(float32, bfloat16)" % x.dtype)
    shape = x.shape
    if not shape or shape[-1] == 0:
        raise MXNetError("scale_bias_add_relu: x must be (..., C) with C > 0, "
                         "got %s" % (tuple(shape),))
    c, dev = shape[-1], x.device
    for nm, v in (("scale", scale), ("bias", bias)):
        if v.shape != (c,):
            raise MXNetError("scale_bias_add_relu: %s shape %s != (%d,)"
                             % (nm, tuple(v.shape), c))
        if v.device != dev:
            raise MXNetError("scale_bias_add_relu: %s on %s, x on %s"
                             % (nm, v.device, dev))
        if not v.is_floating_point():
            raise MXNetError("scale_bias_add_relu: %s must be floating" % nm)
    if residual is not None:
        if residual.shape != shape:
            raise MXNetError("residual shape %s != x shape %s"
                             % (tuple(residual.shape), tuple(shape)))
        if residual.dtype != x.dtype or residual.device != dev:
            raise MXNetError("scale_bias_add_relu: residual %s on %s, x %s "
                             "on %s" % (residual.dtype, residual.device,
                                        x.dtype, dev))
    if dev.type != "meta":
        for nm, v in (("x", x), ("residual", residual)):
            if v is not None and not v.is_contiguous():
                raise MXNetError(
                    "scale_bias_add_relu: %s must be channels-last "
                    "contiguous (row-major (..., C)), got strides %s"
                    % (nm, v.stride()))
    return dev


def scale_bias_add_relu_backward(g, x, scale, bias, out, has_residual):
    """The gradients of the block tail from its saved forward (plain
    PyTorch; the TPU module's ``_fused_vjp_bwd``): ``(dx, dscale, dbias,
    dres)``, ``dres`` None without a residual. ``dx`` and ``dres`` come in
    ``x``'s dtype; the reductions run in fp32 and return in the dtype of
    ``scale`` and ``bias`` (fp32 when the BN folding passed fp32)."""
    gm = g * (out > 0).to(g.dtype)
    red = tuple(range(x.ndim - 1))
    dx = (gm * scale.to(g.dtype)).to(x.dtype)
    gm32 = gm.float()
    dscale = (gm32 * x.float()).sum(dim=red).to(scale.dtype)
    dbias = gm32.sum(dim=red).to(bias.dtype)
    dres = gm.to(x.dtype) if has_residual else None
    return dx, dscale, dbias, dres


def bwd_partition(rows):
    """The backward's blocks from the row count alone: ``(blocks,
    rows_per_block)``. Block ``b`` takes rows ``[b * rows_per_block,
    min(rows, (b + 1) * rows_per_block))``, none empty; up to
    ``_BWD_BLOCKS`` blocks, so on every card the channel sums add the same
    partials in the same order."""
    per = -(-rows // _BWD_BLOCKS)
    return -(-rows // per), per


class _ScaleBiasAddReLU(torch.autograd.Function):
    """The block tail under autograd (the TPU module's custom VJP): the
    kernels on a CUDA tensor, the plain versions on a CPU one."""

    @staticmethod
    def forward(ctx, x, scale, bias, residual):
        if x.device.type == "cuda":
            out = _launch(x, scale, bias, residual)
        else:
            out = scale_bias_add_relu_reference(x, scale, bias, residual)
        ctx.save_for_backward(x, scale, bias, out)
        ctx.has_residual = residual is not None
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, out = ctx.saved_tensors
        if g.device.type == "cuda":
            return _launch_backward(g, x, scale, bias, out, ctx.has_residual)
        # the gradient may arrive as a strided view (channels-last
        # permutations of cuDNN's outputs); a dense g keeps the plain
        # reductions single passes
        return scale_bias_add_relu_backward(
            g.contiguous(), x, scale, bias, out, ctx.has_residual)


def scale_bias_add_relu(x, scale, bias, residual=None):
    """``max(x * scale + bias [+ residual], 0)`` in one device pass,
    differentiable in every input.

    x: ``(..., C)`` channels-last activation, contiguous; scale/bias:
    ``(C,)`` folded BN coefficients (rounded to ``x.dtype`` as the TPU
    kernel's wrapper casts them; their gradients return in their own
    dtype); residual: same shape, dtype and device as ``x``, or None.
    """
    dev = _check(x, scale, bias, residual).type
    if dev == "meta":
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    if dev not in ("cpu", "cuda"):
        raise MXNetError("scale_bias_add_relu: no kernel for device %s"
                         % x.device)
    if torch.is_grad_enabled() and (
            x.requires_grad or scale.requires_grad or bias.requires_grad
            or (residual is not None and residual.requires_grad)):
        return _ScaleBiasAddReLU.apply(x, scale, bias, residual)
    # nothing to differentiate (serving): no autograd node, the same launch
    if dev == "cuda":
        return _launch(x, scale, bias, residual)
    return scale_bias_add_relu_reference(x, scale, bias, residual)


def _coef(v, dtype):
    """A coefficient as the kernels read it: fp32 ``(C,)``, dense. An fp32
    vector goes as it is (the kernels round it to ``dtype`` in-register, as
    ``.to(dtype)`` does); another dtype is cast to ``dtype`` first, so the
    value the kernel sees is the one ``.to(dtype)`` gives."""
    v = v.detach()
    if v.dtype != torch.float32:
        v = v.to(dtype).float()
    return v.contiguous()


def _call(dev, fn, *args):
    """``fn(*args, stream)`` on ``dev``'s current stream (its raw handle,
    as PyTorch's own generated kernels read it); the device guard only
    when ``dev`` is not the current device."""
    cur = torch.cuda.current_device()
    idx = cur if dev.index is None else dev.index
    if idx == cur:
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(idx):
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))


def _launch(x, scale, bias, residual):
    """One launch of the forward kernel on detached inputs."""
    global launches
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.numel() == 0:
        return out
    s, b = _coef(scale, x.dtype), _coef(bias, x.dtype)
    c = x.shape[-1]
    err = _call(x.device, _lib().mx_sbar_forward, x.data_ptr(),
                s.data_ptr(), b.data_ptr(),
                residual.data_ptr() if residual is not None else None,
                out.data_ptr(), x.numel() // c, c, _DTYPE_CODES[x.dtype])
    if err != 0:
        raise MXNetError("scale_bias_add_relu: kernel launch failed "
                         "(cudaError %d)" % err)
    launches += 1
    return out


def _launch_backward(g, x, scale, bias, out, has_residual):
    """The backward kernels (the pass and the finish) on a CUDA gradient:
    ``(dx, dscale, dbias, dres)`` as :func:`scale_bias_add_relu_backward`
    gives them."""
    global bwd_launches, strided_grads
    if g.dtype != x.dtype or g.shape != x.shape:
        raise MXNetError("scale_bias_add_relu backward: gradient %s %s for "
                         "an output %s %s" % (g.dtype, tuple(g.shape),
                                              x.dtype, tuple(x.shape)))
    if not g.is_contiguous():
        strided_grads += 1
        g = g.contiguous()
    c = x.shape[-1]
    rows = x.numel() // c
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    dres = torch.empty_like(dx) if has_residual else None
    if rows == 0:
        z = torch.zeros(c, dtype=torch.float32, device=x.device)
        return dx, z.to(scale.dtype), z.to(bias.dtype), dres
    s = _coef(scale, x.dtype)
    dscale = torch.empty(c, dtype=torch.float32, device=x.device)
    dbias = torch.empty_like(dscale)
    blocks, per = bwd_partition(rows)
    partial = torch.empty((blocks, 2, c), dtype=torch.float32,
                          device=x.device)
    err = _call(x.device, _lib().mx_sbar_backward, g.data_ptr(),
                out.data_ptr(), x.data_ptr(), s.data_ptr(), dx.data_ptr(),
                dres.data_ptr() if dres is not None else None,
                partial.data_ptr(), dscale.data_ptr(), dbias.data_ptr(),
                rows, c, blocks, per, _DTYPE_CODES[x.dtype])
    if err != 0:
        raise MXNetError("scale_bias_add_relu backward: kernel launch "
                         "failed (cudaError %d)" % err)
    bwd_launches += 1
    return dx, dscale.to(scale.dtype), dbias.to(bias.dtype), dres


_bound = None


def _lib():
    """The kernels' library with its entry points' argument types set."""
    global _bound
    if _bound is None:
        import ctypes
        lib = _build.load("fused_bn")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.mx_sbar_forward.argtypes = [p, p, p, p, p, i64, i64, i32, p]
        lib.mx_sbar_forward.restype = i32
        lib.mx_sbar_backward.argtypes = [p] * 9 + [i64] * 4 + [i32, p]
        lib.mx_sbar_backward.restype = i32
        _bound = lib
    return _bound
