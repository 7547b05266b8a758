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

import contextlib
import threading

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

def _stat_input(x):
    """What batch statistics accumulate in: fp32 for half data."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def _bn_stats(data, moving_mean, moving_var, red, _train, use_global_stats):
    """BN statistics, one source for BatchNorm and the fused tail: in
    training mode the batch mean and the biased variance (``jnp.var``'s,
    not ``torch.var``'s default) over ``red``, accumulated in fp32 for
    half inputs, over every replica's rows inside
    :func:`batch_stats_over` (the graph evaluator's scope for replicas
    run together); otherwise the moving stats, detached."""
    if _train and not use_global_stats:
        group = getattr(_STATS, "group", None)
        if group is not None:
            var, mean = group.var_mean(data, red)
        else:
            var, mean = torch.var_mean(_stat_input(data), dim=red,
                                       correction=0)
        return mean.to(moving_mean.dtype), var.to(moving_var.dtype)
    return moving_mean.detach(), moving_var.detach()


_STATS = threading.local()


class _StatsGroup:
    """One node's batch statistics shared by its replicas: computed once,
    at the first replica's call, over ``inputs`` (the node's data on
    every local replica) and, with ``over_workers``, every worker's rows;
    each replica takes a copy on its own device. With a mesh ``group``
    every call takes its own statistics over the rows of ``data`` on
    every member of the group."""

    def __init__(self, inputs, over_workers, group=None):
        self.inputs = inputs
        self.over_workers = over_workers
        self.group = group
        self._got = None

    def var_mean(self, data, red):
        if self.group is not None:
            return _replicas_var_mean([_stat_input(data)], red, False,
                                      self.group)
        if self._got is None:
            self._got = _replicas_var_mean(
                [_stat_input(x) for x in self.inputs], red,
                self.over_workers)
        var, mean = self._got
        return var.to(data.device), mean.to(data.device)


@contextlib.contextmanager
def batch_stats_over(inputs=None, over_workers=False, group=None):
    """Within this scope (this thread), training-mode batch statistics
    are taken over the rows of every tensor in ``inputs`` and, with
    ``over_workers``, of every worker process of the job: what the JAX
    package's one program over a mesh computes. With ``group`` (a mesh
    ``AxisGroup``, ``mesh.group("dp")``, or a ``torch.distributed``
    group) they are taken over the rows of every member of the group:
    the mesh-aware op of an ``SPMDTrainer`` ``apply_fn``, whose members
    see their own rows only."""
    prev = getattr(_STATS, "group", None)
    _STATS.group = _StatsGroup(inputs, over_workers, group)
    try:
        yield
    finally:
        _STATS.group = prev


def _replicas_var_mean(xs, red, over_workers, group=None):
    """``(var, mean)`` over ``red`` and the rows of every tensor in
    ``xs`` (and every worker's, with ``over_workers``), on ``xs[0]``'s
    device: each tensor gives its count, mean and sum of squared
    deviations; over workers each puts its tensors' triples in its own
    slot of a ``(workers, len(xs), 3, C)`` tensor and one differentiable
    all-reduce sum fills every slot on every worker. The triples combine
    in rank-major order (Chan et al.'s pairwise update), the same
    arithmetic on every worker and replica. The backward is one
    all-reduce of the slots' gradients."""
    dev = xs[0].device
    mine = []
    for x in xs:
        n_local = 1
        for d in red:
            n_local *= x.shape[d]
        var_l, mean_l = torch.var_mean(x, dim=red, correction=0)
        mine.append(torch.stack([torch.full_like(mean_l, float(n_local)),
                                 mean_l, var_l * n_local]).to(dev))
    every = torch.stack(mine)
    if over_workers or group is not None:
        from ..parallel import collectives as C
        world, me = C.world_size(group), C._member_index(group)
        slots = [every if r == me else torch.zeros_like(every)
                 for r in range(world)]
        every = C.DifferentiableSum.apply(torch.stack(slots),
                                          group).flatten(0, 1)
    n, mean, m2 = every[0, 0], every[0, 1], every[0, 2]
    for r in range(1, every.shape[0]):
        n_r, mean_r, m2_r = every[r, 0], every[r, 1], every[r, 2]
        delta = mean_r - mean
        tot = n + n_r
        mean = mean + delta * (n_r / tot)
        m2 = m2 + m2_r + delta * delta * (n * n_r / tot)
        n = tot
    return m2 / n, mean


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


# ---------------------------------------------------------------------------
# Deconvolution (parity: mxnet_tpu/ops/nn.py:120-147, 173-193)
# ---------------------------------------------------------------------------

_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _deconv_nd(data, weight, bias, kernel, stride, dilate, pad, adj,
               num_group, no_bias):
    """Transposed convolution on channels-first data with the reference's
    (C_in, F/g, *kernel) weight, which is already ``conv_transpose``'s
    layout. The JAX package computes it as an lhs-dilated convolution
    padded ``(k_eff-1-p, k_eff-1-p+adj)``: the same output, of size
    ``(in-1)*s - 2p + k_eff + adj``; PyTorch takes ``adj`` as
    ``output_padding``, which must stay below ``max(stride, dilate)``."""
    ndim = len(kernel)
    stride = stride or (1,) * ndim
    dilate = dilate or (1,) * ndim
    pad = pad or (0,) * ndim
    adj = adj or (0,) * ndim
    for a, s, d in zip(adj, stride, dilate):
        if a >= max(s, d):
            raise MXNetError(
                "Deconvolution: adj %r must be smaller than max(stride, "
                "dilate) in each dim (stride %r, dilate %r)"
                % (tuple(adj), tuple(stride), tuple(dilate)))
    out = _DECONV[ndim](data, weight, stride=stride, padding=pad,
                        output_padding=adj, groups=int(num_group),
                        dilation=dilate)
    if not no_bias and bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * ndim)
    return out


@register("Deconvolution", nin=3, arg_names=["data", "weight", "bias"],
          defaults={"kernel": (), "stride": (), "dilate": (), "pad": (),
                    "adj": (), "target_shape": (), "num_filter": 0,
                    "num_group": 1, "no_bias": True, "workspace": 512,
                    "cudnn_tune": None, "cudnn_off": False, "layout": None})
def deconvolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                  pad=(), adj=(), target_shape=(), num_filter=0, num_group=1,
                  no_bias=True, workspace=512, cudnn_tune=None,
                  cudnn_off=False, layout=None):
    """Transposed convolution (parity: reference deconvolution-inl.h);
    weight (in_channels, num_filter/g, *kernel); channels-first only, as
    in the JAX package. ``target_shape`` raises: the JAX package accepts
    and ignores it (upstream derives pad/adj from it)."""
    kernel = as_tuple(kernel)
    ndim = len(kernel)
    if channels_last(layout, ndim):
        raise MXNetError("Deconvolution supports channels-first layouts "
                         "only")
    target = as_tuple(target_shape)
    if target and any(target):
        raise MXNetError("Deconvolution: target_shape=%r is not supported; "
                         "give pad and adj instead" % (target,))
    return _deconv_nd(data, weight, bias, kernel, as_tuple(stride, ndim),
                      as_tuple(dilate, ndim), as_tuple(pad, ndim),
                      as_tuple(adj, ndim), num_group, no_bias)


# ---------------------------------------------------------------------------
# LeakyReLU, the other normalisations (parity: mxnet_tpu/ops/nn.py:277-500)
# ---------------------------------------------------------------------------

@register("LeakyReLU", nin=2, arg_names=["data", "gamma"],
          defaults={"act_type": "leaky", "slope": 0.25, "lower_bound": 0.125,
                    "upper_bound": 0.334})
def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334, _train=False,
               _rng=None):
    """leaky/prelu/elu/rrelu (parity: reference leaky_relu-inl.h). rrelu
    draws each slope from U(lower, upper) in training, from the device's
    generator, and takes their mean otherwise."""
    if act_type == "leaky":
        return torch.where(data >= 0, data, slope * data)
    if act_type == "elu":
        return torch.where(data >= 0, data, slope * torch.expm1(data))
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.ndim - 2)) \
            if gamma.ndim == 1 else gamma
        return torch.where(data >= 0, data, g * data)
    if act_type == "rrelu":
        if _train and _rng is not None:
            s = torch.empty(data.shape, dtype=data.dtype,
                            device=data.device).uniform_(
                lower_bound, upper_bound, generator=_rng)
        else:
            s = (lower_bound + upper_bound) / 2.0
        return torch.where(data >= 0, data, s * data)
    raise MXNetError("unknown act_type %r" % act_type)


@register("L2Normalization", defaults={"eps": 1e-10, "mode": "instance"})
def l2_normalization(data, eps=1e-10, mode="instance"):
    """(parity: reference l2_normalization-inl.h; instance, channel,
    spatial)"""
    if mode == "instance":
        axes = tuple(range(1, data.ndim))
    elif mode == "channel":
        axes = (1,)
    elif mode == "spatial":
        axes = tuple(range(2, data.ndim))
    else:
        raise MXNetError("unknown mode %r" % mode)
    norm = torch.sqrt(torch.sum(torch.square(data), dim=axes, keepdim=True)
                      + eps)
    return data / norm


def _mean_var(data, axes):
    """``jnp.mean`` and ``jnp.var`` (biased, about the mean) over axes."""
    mean = torch.mean(data, dim=axes, keepdim=True)
    var = torch.mean(torch.square(data - mean), dim=axes, keepdim=True)
    return mean, var


@register("InstanceNorm", nin=3, arg_names=["data", "gamma", "beta"],
          defaults={"eps": 1e-3})
def instance_norm(data, gamma, beta, eps=1e-3):
    """(parity: reference instance_norm-inl.h) per sample and channel
    over the spatial axes."""
    mean, var = _mean_var(data, tuple(range(2, data.ndim)))
    shape = (1, -1) + (1,) * (data.ndim - 2)
    return (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape) \
        + beta.reshape(shape)


@register("LayerNorm", nin=3, arg_names=["data", "gamma", "beta"],
          defaults={"axis": -1, "eps": 1e-5, "output_mean_var": False})
def layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    """Normalisation over one axis (the JAX package's addition)."""
    axis = int(axis) % data.ndim
    mean, var = _mean_var(data, (axis,))
    shape = [1] * data.ndim
    shape[axis] = data.shape[axis]
    return (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape) \
        + beta.reshape(shape)


@register("SoftmaxActivation", defaults={"mode": "instance"})
def softmax_activation(data, mode="instance"):
    """Softmax over the channel axis (``mode="channel"``) or over each
    instance flattened."""
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1) \
        .reshape(data.shape)


@register("softmax_cross_entropy", nin=2, arg_names=["data", "label"])
def softmax_cross_entropy(data, label):
    """(parity: reference loss_binary_op.cc) the summed cross entropy,
    shape (1,)."""
    logp = torch.log_softmax(data, dim=-1)
    picked = torch.gather(logp, -1, label.long()[:, None])
    return -torch.sum(picked).reshape((1,))


# ---------------------------------------------------------------------------
# Loss layers: forward transform, backward a fixed rule that ignores the
# head gradient (parity: mxnet_tpu/ops/nn.py:631-717)
# ---------------------------------------------------------------------------

class _LossLayerFn(torch.autograd.Function):
    """``forward(data, label)`` = ``fwd(data)``; backward
    ``bwd(out, label)`` whatever the head gradient, and zeros for the
    label (the JAX package's ``custom_vjp`` loss layers)."""

    @staticmethod
    def forward(ctx, data, label, fwd, bwd):
        out = fwd(data)
        ctx.save_for_backward(out, label if label is not None
                              else out.new_zeros(()))
        ctx.bwd = bwd
        ctx.has_label = label is not None
        return out

    @staticmethod
    def backward(ctx, _head_grad):
        out, label = ctx.saved_tensors
        grad = ctx.bwd(out, label if ctx.has_label else None)
        dlabel = torch.zeros_like(label) \
            if ctx.has_label and ctx.needs_input_grad[1] else None
        return grad.to(out.dtype), dlabel, None, None


def _loss_layer(data, label, fwd, bwd):
    if data.device.type == "meta":
        return fwd(data)
    return _LossLayerFn.apply(data, label, fwd, bwd)


def _regression_output(transform, grad_fn):
    def op(data, label, grad_scale=1.0):
        """Regression loss layer: forward the transform; backward
        ``grad_fn(out, label) * grad_scale``, not divided by the output
        count (the JAX package's rule)."""
        return _loss_layer(
            data, label, transform,
            lambda out, lab: grad_fn(out, lab.reshape(out.shape))
            * grad_scale)
    return op


register("LinearRegressionOutput", nin=2, arg_names=["data", "label"],
         defaults={"grad_scale": 1.0})(
    _regression_output(lambda d: d, lambda o, l: o - l))
register("MAERegressionOutput", nin=2, arg_names=["data", "label"],
         defaults={"grad_scale": 1.0})(
    _regression_output(lambda d: d, lambda o, l: torch.sign(o - l)))
register("LogisticRegressionOutput", nin=2, arg_names=["data", "label"],
         defaults={"grad_scale": 1.0})(
    _regression_output(torch.sigmoid, lambda o, l: o - l))


@register("MakeLoss", defaults={"grad_scale": 1.0, "valid_thresh": 0.0,
                                "normalization": "null"})
def make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    """(parity: reference make_loss-inl.h) forward identity; backward
    ``grad_scale`` per element, over the batch size with ``batch``, over
    the count of elements above ``valid_thresh`` (at least 1) with
    ``valid``."""
    def bwd(d, _):
        if normalization == "valid":
            valid = torch.clamp_min(
                torch.sum((d > valid_thresh).to(d.dtype)), 1.0)
            return torch.ones_like(d) * grad_scale / valid
        scale = grad_scale / d.shape[0] if normalization == "batch" \
            else grad_scale
        return torch.full_like(d, scale)
    return _loss_layer(data, None, lambda d: d.clone(), bwd)


@register("SVMOutput", nin=2, arg_names=["data", "label"],
          defaults={"margin": 1.0, "regularization_coefficient": 1.0,
                    "use_linear": False})
def svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
               use_linear=False):
    """(parity: reference svm_output-inl.h) forward identity; backward
    the hinge loss's gradient (squared hinge unless ``use_linear``) times
    ``regularization_coefficient``."""
    def bwd(d, lab):
        oh = (lab.long()[..., None] == torch.arange(
            d.shape[-1], device=d.device)).to(d.dtype)
        score_y = torch.sum(d * oh, dim=-1, keepdim=True)
        if use_linear:
            viol = ((d - score_y + margin) > 0).to(d.dtype) * (1 - oh)
            grad = viol - oh * torch.sum(viol, dim=-1, keepdim=True)
        else:
            dist = torch.clamp_min(d - score_y + margin, 0) * (1 - oh)
            grad = 2 * dist - oh * torch.sum(2 * dist, dim=-1, keepdim=True)
        return grad * regularization_coefficient
    return _loss_layer(data, label, lambda d: d.clone(), bwd)


# ---------------------------------------------------------------------------
# UpSampling (parity: mxnet_tpu/ops/nn.py:719-747)
# ---------------------------------------------------------------------------

def _repeat2(x, sy, sx):
    return torch.repeat_interleave(torch.repeat_interleave(x, sy, dim=2),
                                   sx, dim=3)


@register("UpSampling", nin=-1,
          defaults={"scale": 1, "sample_type": "nearest", "num_filter": 0,
                    "multi_input_mode": "concat", "num_args": 1,
                    "workspace": 512})
def upsampling(*args, scale=1, sample_type="nearest", num_filter=0,
               multi_input_mode="concat", num_args=1, workspace=512):
    """(parity: reference upsampling-inl.h) nearest: each input repeated
    ``scale`` times per spatial axis, then brought to the largest height
    and concatenated (or summed); bilinear: the grouped transposed
    convolution with the given (C, 1, k, k) weight, ``k = 2s - s % 2``,
    stride s, pad ``ceil((s-1)/2)``."""
    scale = int(scale)
    if sample_type == "nearest":
        outs = [_repeat2(d, scale, scale) for d in args]
        if len(outs) == 1:
            return outs[0]
        h = max(o.shape[2] for o in outs)
        # the JAX package scales the width by h // W too
        outs = [o if o.shape[2] == h else
                _repeat2(o, h // o.shape[2], h // o.shape[3]) for o in outs]
        if multi_input_mode == "sum":
            return sum(outs[1:], outs[0])
        return torch.cat(outs, dim=1)
    if sample_type == "bilinear":
        data, weight = args
        kernel = 2 * scale - scale % 2
        pad = int(np.ceil((scale - 1) / 2.0))
        return _deconv_nd(data, weight, None, (kernel, kernel),
                          (scale, scale), None, (pad, pad), None,
                          data.shape[1], True)
    raise MXNetError("unknown sample_type %r" % sample_type)


# ---------------------------------------------------------------------------
# Sequence ops (parity: mxnet_tpu/ops/nn.py:755-794)
# ---------------------------------------------------------------------------

@register("SequenceLast", nin=2, arg_names=["data", "sequence_length"],
          defaults={"use_sequence_length": False, "axis": 0})
def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0):
    """The last step of each sequence (the last of all without
    lengths)."""
    axis = int(axis)
    if not use_sequence_length or sequence_length is None:
        return torch.select(data, axis, data.shape[axis] - 1)
    idx = sequence_length.long() - 1
    batch = torch.arange(data.shape[1 - axis], device=data.device)
    return data[idx, batch] if axis == 0 else data[batch, idx]


@register("SequenceMask", nin=2, arg_names=["data", "sequence_length"],
          defaults={"use_sequence_length": False, "value": 0.0, "axis": 0})
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    """Steps at or past each sequence's length set to ``value``."""
    if not use_sequence_length or sequence_length is None:
        return data
    axis = int(axis)
    steps = torch.arange(data.shape[axis], device=data.device)
    mask = steps[:, None] < sequence_length.long()[None, :]     # (T, B)
    if axis == 1:
        mask = mask.t()
    mask = mask.reshape(mask.shape + (1,) * (data.ndim - 2))
    return torch.where(mask, data, torch.full((), float(value),
                                              dtype=data.dtype,
                                              device=data.device))


@register("SequenceReverse", nin=2, arg_names=["data", "sequence_length"],
          defaults={"use_sequence_length": False, "axis": 0})
def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    """Each sequence's first ``length`` steps reversed along axis 0, the
    padding left in place."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, dims=(0,))
    steps = torch.arange(data.shape[0], device=data.device)[:, None]
    lens = sequence_length.long()[None, :]
    src = torch.where(steps < lens, lens - 1 - steps, steps)     # (T, B)
    src = src.reshape(src.shape + (1,) * (data.ndim - 2)).expand(data.shape)
    return torch.gather(data, 0, src)
