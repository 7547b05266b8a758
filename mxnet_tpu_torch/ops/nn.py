"""Neural-network operators.

Counterpart of ``mxnet_tpu/ops/nn.py``: FullyConnected, Convolution,
Pooling, Activation, BatchNorm and _contrib_BatchNormAddReLU (inference
and training statistics, moving-stat updates), LRN, Dropout and
SoftmaxOutput (with its hand-written gradient). What the JAX package
left to XLA is left to PyTorch's own operators here (cuDNN/cuBLAS on the
card); the fused block tail runs the hand-written kernel of
``kernels/fused_bn.py``.

Layouts are the JAX package's logical ones: channels-last activations
are N+spatial+C tensors and their conv weights are O+spatial+I. For
cuDNN, ``x.permute(0, 3, 1, 2)`` and ``w.permute(0, 3, 1, 2)`` of such
tensors are already ``torch.channels_last`` NCHW views (no copy), and the
result permuted back is NHWC-contiguous again. The TPU-only
space-to-depth rewrite of the 7x7/s2 stem is not ported: cuDNN takes
the stem directly.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .common import as_tuple, channels_last
from .registry import register, get_op

# ---------------------------------------------------------------------------
# FullyConnected
# ---------------------------------------------------------------------------


@register("FullyConnected", nin=3, arg_names=["data", "weight", "bias"],
          defaults={"num_hidden": 0, "no_bias": False, "flatten": True})
def fully_connected(data, weight, bias=None, num_hidden=0, no_bias=False,
                    flatten=True):
    """y = x W^T + b; weight (num_hidden, in_units)."""
    if flatten and data.ndim > 2:
        data = data.reshape(data.shape[0], -1)
    out = torch.matmul(data, weight.t())
    if not no_bias and bias is not None:
        out = out + bias
    return out


# ---------------------------------------------------------------------------
# Convolution
# ---------------------------------------------------------------------------

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _to_cf(t, ndim):
    """N+spatial+C -> NC+spatial view (a channels_last view, no copy)."""
    return t.permute(0, ndim + 1, *range(1, ndim + 1))


def _to_cl(t, ndim):
    """NC+spatial -> N+spatial+C view."""
    return t.permute(0, *range(2, ndim + 2), 1)


@register("Convolution", nin=3, arg_names=["data", "weight", "bias"],
          defaults={"kernel": (), "stride": (), "dilate": (), "pad": (),
                    "num_filter": 0, "num_group": 1, "no_bias": False,
                    "workspace": 1024, "cudnn_tune": None, "cudnn_off": False,
                    "layout": None})
def convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                pad=(), num_filter=0, num_group=1, no_bias=False,
                workspace=1024, cudnn_tune=None, cudnn_off=False, layout=None):
    """N-D convolution. layout=None means NC+spatial with OI+spatial
    weights; NWC/NHWC/NDHWC run channels-last with O+spatial+I weights.
    workspace/cudnn_* knobs are accepted for API parity and ignored."""
    kernel = as_tuple(kernel)
    ndim = len(kernel)
    stride = as_tuple(stride, ndim) or (1,) * ndim
    dilate = as_tuple(dilate, ndim) or (1,) * ndim
    pad = as_tuple(pad, ndim) or (0,) * ndim
    conv = _CONV[ndim]
    is_cl = channels_last(layout, ndim)
    if is_cl:
        out = _to_cl(conv(_to_cf(data, ndim), _to_cf(weight, ndim),
                          stride=stride, padding=pad, dilation=dilate,
                          groups=int(num_group)), ndim)
    else:
        out = conv(data, weight, stride=stride, padding=pad,
                   dilation=dilate, groups=int(num_group))
    if not no_bias and bias is not None:
        out = out + (bias if is_cl
                     else bias.reshape((1, -1) + (1,) * ndim))
    return out


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------

_MAXPOOL = {2: F.max_pool2d, 3: F.max_pool3d}
_AVGPOOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


@register("Pooling", defaults={"kernel": (), "pool_type": "max", "stride": (),
                               "pad": (), "global_pool": False,
                               "pooling_convention": "valid", "cudnn_off": False,
                               "layout": None})
def pooling(data, kernel=(), pool_type="max", stride=(), pad=(),
            global_pool=False, pooling_convention="valid", cudnn_off=False,
            layout=None):
    """Max/avg/sum pooling. Windows see ``pad`` cells of padding on both
    sides (-inf for max, 0 for avg/sum); the 'full' convention
    right-pads up to what ceil division of the output size needs; avg
    divides by the full kernel size. Same semantics as the JAX package's
    reduce_window formulation."""
    ndim = data.ndim - 2
    is_cl = channels_last(layout, ndim)
    sp0 = 1 if is_cl else 2
    if global_pool:
        axes = tuple(range(sp0, sp0 + ndim))
        if pool_type == "max":
            return torch.amax(data, dim=axes, keepdim=True)
        if pool_type in ("avg", "sum"):
            out = torch.sum(data, dim=axes, keepdim=True)
            if pool_type == "avg":
                out = out / int(np.prod([data.shape[a] for a in axes]))
            return out
        raise MXNetError("bad pool_type %r" % pool_type)
    if ndim == 1:
        # one spatial dim: the same windows over (1, W)
        ax = 1 if is_cl else 2
        out = pooling(data.unsqueeze(ax), kernel=(1,) + as_tuple(kernel, 1),
                      pool_type=pool_type,
                      stride=(1,) + (as_tuple(stride, 1) or (1,)),
                      pad=(0,) + (as_tuple(pad, 1) or (0,)),
                      pooling_convention=pooling_convention,
                      layout="NHWC" if is_cl else None)
        return out.squeeze(ax)
    if ndim not in _MAXPOOL:
        raise MXNetError("Pooling: windows over 1, 2 or 3 spatial dims "
                         "only")
    kernel = as_tuple(kernel, ndim)
    stride = as_tuple(stride, ndim) or (1,) * ndim
    pad = as_tuple(pad, ndim) or (0,) * ndim
    if pool_type not in ("max", "avg", "sum"):
        raise MXNetError("bad pool_type %r" % pool_type)
    hi = list(pad)
    if pooling_convention == "full":
        for i in range(ndim):
            size = data.shape[sp0 + i] + 2 * pad[i]
            rem = (size - kernel[i]) % stride[i]
            if rem:
                hi[i] += stride[i] - rem
    x = _to_cf(data, ndim) if is_cl else data
    if pool_type == "max" and tuple(hi) == tuple(pad) \
            and all(2 * p <= k for p, k in zip(pad, kernel)):
        # symmetric -inf padding is exactly what max_pool's own padding does
        out = _MAXPOOL[ndim](x, kernel, stride, pad)
    else:
        # explicit padding (F.pad takes the last dim first)
        pads = []
        for lo, h in zip(reversed(pad), reversed(hi)):
            pads += [lo, h]
        fill = float("-inf") if pool_type == "max" else 0.0
        if any(pads):
            x = F.pad(x, pads, value=fill)
        if pool_type == "max":
            out = _MAXPOOL[ndim](x, kernel, stride)
        else:
            # window sums, then one division by the full kernel size
            out = _AVGPOOL[ndim](x, kernel, stride, divisor_override=1)
            if pool_type == "avg":
                out = out / int(np.prod(kernel))
    if is_cl:
        out = _to_cl(out, ndim).contiguous()
    return out


# ---------------------------------------------------------------------------
# Activation
# ---------------------------------------------------------------------------

@register("Activation", defaults={"act_type": "relu"})
def activation(data, act_type="relu"):
    """relu/sigmoid/tanh/softrelu/softsign. relu is ``max(x, 0)`` with
    the JAX package's gradient: 1/2 at exactly 0 (``jnp.maximum``'s tie
    rule, which ``torch.maximum`` shares; ``clamp_min`` passes 1). It
    matters where a BatchNorm channel is constant over the batch and its
    output is exactly beta = 0."""
    if act_type == "relu":
        return torch.maximum(data, data.new_zeros(()))
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return F.softplus(data)
    if act_type == "softsign":
        return data / (1 + torch.abs(data))
    raise MXNetError("unknown act_type %r" % act_type)


# ---------------------------------------------------------------------------
# Normalisation
# ---------------------------------------------------------------------------

def _bn_stats(data, moving_mean, moving_var, red, _train, use_global_stats):
    """BN statistics, one source for BatchNorm and the fused tail: in
    training mode the batch mean and the biased variance (``jnp.var``'s,
    not ``torch.var``'s default) over ``red``, accumulated in fp32 for
    half inputs; otherwise the moving stats, detached."""
    if _train and not use_global_stats:
        stat_in = data.float() if data.dtype in (torch.bfloat16,
                                                 torch.float16) else data
        var, mean = torch.var_mean(stat_in, dim=red, correction=0)
        return mean.to(moving_mean.dtype), var.to(moving_var.dtype)
    return moving_mean.detach(), moving_var.detach()


def _reduce_axes(ndim, axis):
    return tuple(i for i in range(ndim) if i != axis)


@register("BatchNorm", nin=5,
          arg_names=["data", "gamma", "beta", "moving_mean", "moving_var"],
          nout=3,
          defaults={"eps": 1e-3, "momentum": 0.9, "fix_gamma": True,
                    "use_global_stats": False, "output_mean_var": False,
                    "axis": 1, "cudnn_off": False})
def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False, _train=False):
    """Batch normalisation with the JAX package's formula: fp32 data
    normalises as ``(x - mean) * (rsqrt(var+eps)*g) + beta``; half data
    applies fp32-folded scale/offset in its own dtype. In training mode
    the statistics are the batch's and gradients flow through them into
    the data; ``fix_gamma`` replaces gamma by ones (its gradient is
    zero). Returns (out, mean, var)."""
    axis = int(axis) % data.ndim
    shape = [1] * data.ndim
    shape[axis] = data.shape[axis]
    g = torch.ones_like(gamma) if fix_gamma else gamma
    mean, var = _bn_stats(data, moving_mean, moving_var,
                          _reduce_axes(data.ndim, axis), _train,
                          use_global_stats)
    if data.dtype in (torch.bfloat16, torch.float16):
        inv = torch.rsqrt(var.float() + eps)
        s = inv * g.float()
        b = beta.float() - mean.float() * s
        out = data * s.to(data.dtype).reshape(shape) \
            + b.to(data.dtype).reshape(shape)
    else:
        inv = torch.rsqrt(var + eps)
        out = (data - mean.reshape(shape)) * (inv * g).reshape(shape) \
            + beta.reshape(shape)
    return out, mean, var


def _bn_param_dtypes(first_param_idx):
    """gamma/beta/moving stats stay fp32 under half-precision data and
    take fp64 data's type (upstream's AccReal; the JAX package keeps fp32
    for every type, which rounds fp64 batch statistics to fp32)."""
    idxs = tuple(range(first_param_idx, first_param_idx + 4))

    def infer(in_types, params):
        dt = torch.float64 if in_types[0] == torch.float64 \
            else torch.float32
        return {i: dt for i in idxs}

    return infer


def _bn_stateful_update(mean_idx, var_idx):
    """The moving-stat update of a training-mode call, ``new = m * old +
    (1 - m) * batch`` (the JAX package's convention; not
    ``F.batch_norm``'s), keyed by the aux input positions (BN 3/4, fused
    tail 4/5). The values are detached: they never carry the graph."""

    def update(raw_inputs, raw_outputs, params):
        if not params.get("_train") or params.get("use_global_stats"):
            return {}
        m = params.get("momentum", 0.9)
        _, mean, var = raw_outputs[:3]
        return {mean_idx: m * raw_inputs[mean_idx] + (1 - m) * mean.detach(),
                var_idx: m * raw_inputs[var_idx] + (1 - m) * var.detach()}

    return update


_bn = get_op("BatchNorm")
_bn.visible_outputs = 1
_bn.aux_inputs = (3, 4)
_bn.param_dtype_infer = _bn_param_dtypes(1)
_bn.stateful_update = _bn_stateful_update(3, 4)


@register("_contrib_BatchNormAddReLU", nin=6,
          arg_names=["data", "addend", "gamma", "beta", "moving_mean",
                     "moving_var"],
          nout=3,
          defaults={"eps": 1e-3, "momentum": 0.9, "fix_gamma": True,
                    "use_global_stats": False, "axis": 1,
                    "cudnn_off": False})
def batch_norm_add_relu(data, addend, gamma, beta, moving_mean, moving_var,
                        eps=1e-3, momentum=0.9, fix_gamma=True,
                        use_global_stats=False, axis=1, cudnn_off=False,
                        _train=False):
    """Fused BN + residual-add + ReLU — the ResNet block tail as one op.
    The BN coefficients fold in fp32; with the channel axis last the
    apply+add+relu is ONE pass of the hand-written kernel
    (``kernels/fused_bn.py``), otherwise the composed chain. Returns
    (out, mean, var) like BatchNorm."""
    axis = int(axis) % data.ndim
    shape = [1] * data.ndim
    shape[axis] = data.shape[axis]
    g = torch.ones_like(gamma) if fix_gamma else gamma
    mean, var = _bn_stats(data, moving_mean, moving_var,
                          _reduce_axes(data.ndim, axis), _train,
                          use_global_stats)
    inv = torch.rsqrt(var.float() + eps)
    s = inv * g.float()
    b = beta.float() - mean.float() * s
    if axis == data.ndim - 1:
        from ..kernels.fused_bn import scale_bias_add_relu
        out = scale_bias_add_relu(data, s, b, addend)
    else:
        y = data * s.to(data.dtype).reshape(shape) \
            + b.to(data.dtype).reshape(shape) + addend
        out = torch.maximum(y, y.new_zeros(()))   # jnp.maximum's gradient
    return out, mean, var


_bnar = get_op("_contrib_BatchNormAddReLU")
_bnar.visible_outputs = 1
_bnar.aux_inputs = (4, 5)
_bnar.param_dtype_infer = _bn_param_dtypes(2)
_bnar.stateful_update = _bn_stateful_update(4, 5)


# ---------------------------------------------------------------------------
# SoftmaxOutput
# ---------------------------------------------------------------------------

def _softmax_out_grad(prob, label, grad_scale, ignore_label, use_ignore,
                      normalization, multi_output):
    """SoftmaxOutput's gradient, ``prob - onehot(label)`` (parity: the
    JAX package's ``_softmax_out_grad``), with ``use_ignore`` masking,
    ``normalization`` null/batch/valid and ``grad_scale``."""
    lab = label.long()
    axis = 1 if multi_output else -1
    k = prob.shape[axis]
    shape = [1] * prob.ndim
    shape[axis] = k
    # a label outside [0, k) (an ignored -1) has an all-zero row, as
    # jax.nn.one_hot gives it
    oh = (lab.unsqueeze(axis) == torch.arange(k, device=prob.device)
          .reshape(shape)).to(prob.dtype)
    grad = prob - oh
    valid = None
    if use_ignore:
        mask = (lab != int(ignore_label)).to(prob.dtype)
        grad = grad * mask.unsqueeze(axis)
        valid = torch.clamp_min(mask.sum(), 1.0)
    if normalization == "valid" and valid is not None:
        grad = grad / valid
    elif normalization == "batch":
        grad = grad / prob.shape[0]
    return grad * grad_scale


class _SoftmaxOutputFn(torch.autograd.Function):
    """Forward softmax; backward ``p - onehot`` (the JAX package's
    ``custom_vjp``): a loss layer, so the incoming head gradient is
    ignored, and the label gets a zero gradient."""

    @staticmethod
    def forward(ctx, data, label, axis, grad_args):
        prob = torch.softmax(data, dim=axis)
        ctx.save_for_backward(prob, label)
        ctx.grad_args = grad_args
        return prob

    @staticmethod
    def backward(ctx, _head_grad):
        prob, label = ctx.saved_tensors
        grad = _softmax_out_grad(prob, label, *ctx.grad_args)
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] \
            else None
        return grad.to(prob.dtype), dlabel, None, None


@register("SoftmaxOutput", nin=2, arg_names=["data", "label"],
          defaults={"grad_scale": 1.0, "ignore_label": -1.0,
                    "multi_output": False, "use_ignore": False,
                    "preserve_shape": False, "normalization": "null",
                    "out_grad": False, "smooth_alpha": 0.0},
          aliases=("Softmax",))
def softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False, preserve_shape=False,
                   normalization="null", out_grad=False, smooth_alpha=0.0):
    """The softmax loss layer: forward ``softmax(data)`` over the class
    axis (1 with multi_output, else the last); backward ``(p -
    onehot(label)) * grad_scale`` whatever the head gradient."""
    axis = 1 if multi_output else -1
    expected = ((data.shape[0],) + tuple(data.shape[2:]) if multi_output
                else tuple(data.shape[:-1]))
    if tuple(label.shape) != expected:
        flat = (data.shape[0],
                int(np.prod(data.shape[2:])) if data.ndim > 2 else 1)
        if multi_output and tuple(label.shape) == flat:
            label = label.reshape(expected)
        else:
            raise MXNetError(
                "SoftmaxOutput: label shape %s is inconsistent with data "
                "shape %s (expected label %s)"
                % (tuple(label.shape), tuple(data.shape), expected))
    if data.device.type == "meta":
        return torch.softmax(data, dim=axis)
    return _SoftmaxOutputFn.apply(
        data, label, axis, (float(grad_scale), ignore_label,
                            bool(use_ignore), normalization,
                            bool(multi_output)))


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------

def drop_out(x, p, gen, mask_shape=None):
    """``x`` with each element (or each slice along the axes
    ``mask_shape`` sets to 1) kept with probability ``1 - p`` and scaled
    by ``1 / (1 - p)``, the rest zeroed; the keep mask is drawn from
    ``gen`` (a ``torch.Generator``)."""
    keep = torch.empty(mask_shape or x.shape, dtype=torch.float32,
                       device=x.device).bernoulli_(1.0 - p, generator=gen)
    return torch.where(keep.bool(), x / (1.0 - p), torch.zeros_like(x))


@register("Dropout", defaults={"p": 0.5, "mode": "training", "axes": ()})
def dropout(data, p=0.5, mode="training", axes=(), _train=False, _rng=None):
    """(parity: reference dropout-inl.h) identity outside training unless
    ``mode="always"``; one mask value per slice along ``axes``."""
    if (not _train and mode != "always") or p <= 0 or _rng is None:
        return data
    axes = as_tuple(axes) or ()
    shape = tuple(1 if i in axes else s for i, s in enumerate(data.shape))
    return drop_out(data, p, _rng, shape)


# ---------------------------------------------------------------------------
# Softmax family
# ---------------------------------------------------------------------------

@register("LRN", defaults={"alpha": 1e-4, "beta": 0.75, "knorm": 2.0,
                           "nsize": 5})
def lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Local response norm across channels (parity: the reference's
    lrn-inl.h): ``x * (knorm + alpha * sum_window(x^2) / nsize)^-beta``
    over the ``nsize`` channels from ``c - nsize//2`` to
    ``c + (nsize-1)//2``, zero outside. ``F.local_response_norm`` pads
    the channel axis by the same amounts and divides the window sum by
    ``nsize`` (an average pool), so it computes the same function."""
    x = data if data.ndim >= 3 else data.reshape(*data.shape, 1)
    out = F.local_response_norm(x, int(nsize), alpha=alpha, beta=beta,
                                k=knorm)
    return out.reshape(data.shape)


@register("softmax", defaults={"axis": -1, "temperature": None})
def softmax(data, axis=-1, temperature=None):
    """(parity: softmax-inl.h)"""
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    return torch.softmax(data, dim=int(axis))


@register("log_softmax", defaults={"axis": -1, "temperature": None})
def log_softmax(data, axis=-1, temperature=None):
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    return torch.log_softmax(data, dim=int(axis))
