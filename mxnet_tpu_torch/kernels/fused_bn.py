"""Fused BatchNorm-apply + residual-add + ReLU: the ResNet block tail.

Counterpart of ``mxnet_tpu/pallas/fused_bn.py``. The work is

    out = max(x * scale + bias [+ residual], 0)

over the channels-last ``(N*H*W, C)`` view, with ``scale``/``bias`` the
folded BN apply coefficients, so the whole tail reads ``x`` and
``residual`` once and writes ``out`` once.

:func:`scale_bias_add_relu` dispatches on the tensor's device:

* CUDA — the hand-written kernel ``csrc/fused_bn.cu`` (built by
  ``_build``, bound through ``ctypes``) inside a ``torch.autograd.Function``
  whose backward is :func:`scale_bias_add_relu_backward`; each launch adds
  one to :data:`launches`;
* CPU — :func:`scale_bias_add_relu_reference`, the plain PyTorch version,
  under the same ``torch.autograd.Function`` (one backward for both
  routes, as the JAX package runs its custom VJP in interpret mode too);
* ``meta`` — an empty output of the right shape (shape inference).

It never falls back from the kernel to the plain version, and never
copies an activation: an input the kernel does not take raises.

The backward is plain PyTorch, as the TPU module's is plain XLA
(``_fused_vjp_bwd``, ``mxnet_tpu/pallas/fused_bn.py:100``): with ``m = out
> 0``, ``dx = g*m*scale``, ``dres = g*m``, ``dscale = sum_rows(g*m*x)``
and ``dbias = sum_rows(g*m)`` reduced in fp32. It is bound by bytes (g,
out and x read, dx and dres written: the residual is not read); a
kernel for it is optional later work.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from . import _build

__all__ = ["scale_bias_add_relu", "scale_bias_add_relu_reference",
           "scale_bias_add_relu_backward", "launches"]

# kernel launches so far (CUDA path only); callers reset it to 0
launches = 0

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
    if x.dtype not in _DTYPE_CODES:
        raise MXNetError("scale_bias_add_relu: dtype %s not supported "
                         "(float32, bfloat16)" % x.dtype)
    if x.ndim < 1 or x.shape[-1] == 0:
        raise MXNetError("scale_bias_add_relu: x must be (..., C) with C > 0, "
                         "got %s" % (tuple(x.shape),))
    c = x.shape[-1]
    for nm, v in (("scale", scale), ("bias", bias)):
        if v.shape != (c,):
            raise MXNetError("scale_bias_add_relu: %s shape %s != (%d,)"
                             % (nm, tuple(v.shape), c))
        if v.device != x.device:
            raise MXNetError("scale_bias_add_relu: %s on %s, x on %s"
                             % (nm, v.device, x.device))
        if not v.is_floating_point():
            raise MXNetError("scale_bias_add_relu: %s must be floating" % nm)
    if residual is not None:
        if residual.shape != x.shape:
            raise MXNetError("residual shape %s != x shape %s"
                             % (tuple(residual.shape), tuple(x.shape)))
        if residual.dtype != x.dtype or residual.device != x.device:
            raise MXNetError("scale_bias_add_relu: residual %s on %s, x %s "
                             "on %s" % (residual.dtype, residual.device,
                                        x.dtype, x.device))
    if x.device.type != "meta":
        for nm, v in (("x", x), ("residual", residual)):
            if v is not None and not v.is_contiguous():
                raise MXNetError(
                    "scale_bias_add_relu: %s must be channels-last "
                    "contiguous (row-major (..., C)), got strides %s"
                    % (nm, v.stride()))


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


class _ScaleBiasAddReLU(torch.autograd.Function):
    """The block tail under autograd (the TPU module's custom VJP): the
    kernel forward on a CUDA tensor, the plain version on a CPU one."""

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
        # the gradient may arrive as a strided view (channels-last
        # permutations of cuDNN's outputs); the reductions need none of
        # _check's contiguity, but a dense g keeps them single passes
        return scale_bias_add_relu_backward(
            g.contiguous(), x, scale, bias, out, ctx.has_residual)


def scale_bias_add_relu(x, scale, bias, residual=None):
    """``max(x * scale + bias [+ residual], 0)`` in one device pass,
    differentiable in every input.

    x: ``(..., C)`` channels-last activation, contiguous; scale/bias:
    ``(C,)`` folded BN coefficients (cast to ``x.dtype`` for the kernel, as
    the TPU kernel's wrapper does; their gradients return in their own
    dtype); residual: same shape, dtype and device as ``x``, or None.
    """
    _check(x, scale, bias, residual)
    dev = x.device.type
    if dev == "meta":
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    if dev not in ("cpu", "cuda"):
        raise MXNetError("scale_bias_add_relu: no kernel for device %s"
                         % x.device)
    return _ScaleBiasAddReLU.apply(x, scale, bias, residual)


def _launch(x, scale, bias, residual):
    """One launch of the CUDA kernel on detached inputs."""
    global launches
    s = scale.detach().to(x.dtype).contiguous()
    b = bias.detach().to(x.dtype).contiguous()
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.numel() == 0:
        return out
    lib = _bind()
    c = x.shape[-1]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mx_scale_bias_add_relu(
            x.data_ptr(), s.data_ptr(), b.data_ptr(),
            residual.data_ptr() if residual is not None else None,
            out.data_ptr(), x.numel() // c, c, _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise MXNetError("scale_bias_add_relu: kernel launch failed "
                         "(cudaError %d)" % err)
    launches += 1
    return out


def _bind():
    import ctypes
    lib = _build.load("fused_bn")
    fn = lib.mx_scale_bias_add_relu
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, p, p, p, p, i64, i64, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib
