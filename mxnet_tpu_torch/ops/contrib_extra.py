"""The rest of the reference's contrib operators: flow, signal,
quantization, legacy BatchNorm, the KL sparsity regulariser, deformable
convolution and RPN proposals.

Counterpart of ``mxnet_tpu/ops/contrib_extra.py`` (reference
``src/operator/correlation.cc``, ``contrib/fft.cc``, ``contrib/ifft.cc``,
``contrib/quantize.cc``, ``contrib/dequantize.cc``,
``batch_norm_v1.cc``, ``identity_attach_KL_sparse_reg.cc``,
``contrib/deformable_convolution.cc``, ``contrib/proposal.cc``). No TPU
kernel backs any of them. ``Proposal``'s greedy NMS, a ``lax.fori_loop``
over up to ``rpn_pre_nms_top_n`` rows in the JAX package, is one
``n x n`` suppression mask built on the device and resolved on a host
copy (``greedy_keep``): no device work per candidate row.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .common import as_tuple
from .contrib import parse_floats
from .registry import register, get_op


# ---------------------------------------------------------------------------
# Correlation (FlowNet)
# ---------------------------------------------------------------------------

@register("Correlation", nin=2, arg_names=["data1", "data2"],
          defaults={"kernel_size": 1, "max_displacement": 1, "stride1": 1,
                    "stride2": 1, "pad_size": 0, "is_multiply": True})
def correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                stride2=1, pad_size=0, is_multiply=True):
    """Patch correlation of two maps: (N, D*D, top_h, top_w), D =
    2*(max_displacement//stride2)+1, each channel the window sum at one
    displacement over ``kernel_size**2 * C``; the output extent rounds up
    and the maps are zero-padded as far as the windows reach."""
    k = int(kernel_size)
    md = int(max_displacement)
    s1, s2, pad = int(stride1), int(stride2), int(pad_size)
    B, C, H, W = data1.shape
    ph, pw = H + 2 * pad, W + 2 * pad
    bs = md + (k - 1) // 2
    th = -((ph - 2 * bs) // -s1)
    tw = -((pw - 2 * bs) // -s1)
    if th <= 0 or tw <= 0:
        raise MXNetError("Correlation output would be empty")
    r = md // s2
    D = 2 * r + 1
    eh = (th - 1) * s1 + k
    ew = (tw - 1) * s1 + k
    xh = max(0, 2 * md + eh - ph)
    xw = max(0, 2 * md + ew - pw)
    t1 = F.pad(data1, (pad, pad + xw, pad, pad + xh))
    t2 = F.pad(data2, (pad, pad + xw, pad, pad + xh))
    a = t1[:, :, md:md + eh, md:md + ew]
    outs = []
    for p in range(D):
        for o in range(D):
            dy = (p - r) * s2
            dx = (o - r) * s2
            b = t2[:, :, md + dy:md + dy + eh, md + dx:md + dx + ew]
            prod = a * b if is_multiply else torch.abs(a - b)
            chan = prod.sum(dim=1, keepdim=True)                 # (B,1,eh,ew)
            outs.append(F.avg_pool2d(chan, k, s1, divisor_override=1)[:, 0])
    return torch.stack(outs, dim=1) / float(k * k * C)


# ---------------------------------------------------------------------------
# fft / ifft: complex values interleaved along the last axis
# ---------------------------------------------------------------------------

@register("_contrib_fft", defaults={"compute_size": 128},
          aliases=("fft", "_contrib_Fft"))
def fft(data, compute_size=128):
    """FFT along the last axis in float32, whatever the input's type; the
    output interleaves (real, imag), so the last axis doubles.
    ``compute_size`` is accepted and ignored."""
    c = torch.fft.fft(data.to(torch.float32), dim=-1)
    out = torch.stack([c.real, c.imag], dim=-1)
    return out.reshape(data.shape[:-1] + (2 * data.shape[-1],)) \
        .to(data.dtype)


@register("_contrib_ifft", defaults={"compute_size": 128},
          aliases=("ifft", "_contrib_Ifft"))
def ifft(data, compute_size=128):
    """Inverse FFT of the interleaved layout, real part, unnormalised
    (n times ``numpy.fft.ifft``), as the reference's cuFFT path."""
    d = data.shape[-1] // 2
    x = data.to(torch.float32).reshape(data.shape[:-1] + (d, 2))
    c = torch.complex(x[..., 0], x[..., 1])
    out = torch.fft.ifft(c, dim=-1).real * d
    return out.to(data.dtype)


# ---------------------------------------------------------------------------
# quantize / dequantize
# ---------------------------------------------------------------------------

@register("_contrib_quantize", nin=3,
          arg_names=["data", "min_range", "max_range"], nout=3,
          defaults={"out_type": "uint8"}, no_grad=True,
          aliases=("quantize",))
def quantize(data, min_range, max_range, out_type="uint8"):
    """uint8 over [min_range, max_range]: ``(x - min) * 255 / (max -
    min) + 0.5``, clipped to [0, 255], truncated. Returns (quantized,
    min_range, max_range)."""
    if out_type != "uint8":
        raise MXNetError("only uint8 quantization is supported (reference "
                         "quantize-inl.h supports the same)")
    lo = min_range.reshape(())
    hi = max_range.reshape(())
    scale = 255.0 / (hi - lo)
    q = torch.clamp((data - lo) * scale + 0.5, 0, 255).to(torch.uint8)
    return q, lo.reshape((1,)), hi.reshape((1,))


@register("_contrib_dequantize", nin=3,
          arg_names=["data", "min_range", "max_range"],
          defaults={"out_type": "float32"}, no_grad=True,
          aliases=("dequantize",))
def dequantize(data, min_range, max_range, out_type="float32"):
    """uint8 back to float32: ``q * (max - min) / 255 + min``."""
    lo = min_range.reshape(())
    hi = max_range.reshape(())
    return (data.to(torch.float32) * ((hi - lo) / 255.0) + lo) \
        .to(torch.float32)


# ---------------------------------------------------------------------------
# BatchNorm_v1: BatchNorm with the channel axis fixed at 1
# ---------------------------------------------------------------------------

@register("BatchNorm_v1", nin=5,
          arg_names=["data", "gamma", "beta", "moving_mean", "moving_var"],
          nout=3,
          defaults={"eps": 1e-3, "momentum": 0.9, "fix_gamma": True,
                    "use_global_stats": False, "output_mean_var": False})
def batch_norm_v1(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                  momentum=0.9, fix_gamma=True, use_global_stats=False,
                  output_mean_var=False, _train=False):
    """The legacy layer: the port's BatchNorm over axis 1."""
    return get_op("BatchNorm").fn(
        data, gamma, beta, moving_mean, moving_var, eps=eps,
        momentum=momentum, fix_gamma=fix_gamma,
        use_global_stats=use_global_stats, output_mean_var=output_mean_var,
        axis=1, _train=_train)


# ---------------------------------------------------------------------------
# IdentityAttachKLSparseReg
# ---------------------------------------------------------------------------

class _KLSparseReg(torch.autograd.Function):
    """Identity forward; the backward adds ``penalty * (-t/rho +
    (1-t)/(1-rho))`` per feature, rho the moving average updated by this
    batch's mean activation (reference
    identity_attach_KL_sparse_reg-inl.h)."""

    @staticmethod
    def forward(ctx, data, moving_avg, t, penalty, momentum):
        ctx.save_for_backward(data)
        # the average as this call read it: a training-mode call writes
        # the updated one into the same tensor afterwards
        ctx.args = (moving_avg.detach().clone(), t, penalty, momentum)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        data, = ctx.saved_tensors
        mov, t, pen, mom = ctx.args
        avg = data.reshape(data.shape[0], -1).mean(dim=0)
        rho = mom * mov + (1 - mom) * avg
        reg = pen * (-t / rho + (1 - t) / (1 - rho))
        grad = g + reg.reshape((1,) + data.shape[1:]).to(data.dtype)
        return grad, torch.zeros_like(mov), None, None, None


@register("IdentityAttachKLSparseReg", nin=2,
          arg_names=["data", "moving_avg"],
          defaults={"sparseness_target": 0.1, "penalty": 0.001,
                    "momentum": 0.9})
def identity_attach_kl_sparse_reg(data, moving_avg, sparseness_target=0.1,
                                  penalty=0.001, momentum=0.9, _train=False):
    """Forward identity; the backward adds the KL sparsity penalty's
    gradient (``_KLSparseReg``)."""
    if data.device.type == "meta":
        return data.clone()
    return _KLSparseReg.apply(data, moving_avg, float(sparseness_target),
                              float(penalty), float(momentum))


def _klreg_stateful(raw_inputs, raw_outputs, params):
    """The moving average's update of a training-mode call, ``m * old +
    (1 - m) * batch mean`` per feature (the reference makes it in
    Backward; the JAX package, and so the port, at the forward)."""
    if not params.get("_train"):
        return {}
    mom = params.get("momentum", 0.9)
    d = raw_inputs[0].detach()
    avg = d.reshape(d.shape[0], -1).mean(dim=0)
    return {1: mom * raw_inputs[1] + (1 - mom) * avg}


def _klreg_shapes(shapes, params):
    return {1: (int(np.prod(shapes[0][1:])),)}


_klreg = get_op("IdentityAttachKLSparseReg")
_klreg.visible_outputs = 1
_klreg.aux_inputs = (1,)
_klreg.stateful_update = _klreg_stateful
_klreg.param_shape_infer = _klreg_shapes


# ---------------------------------------------------------------------------
# DeformableConvolution
# ---------------------------------------------------------------------------

def bilinear_gather(img, ys, xs):
    """img (..., C, H, W) with a leading batch of G; ys/xs (G, *S)
    fractional pixel positions -> (G, C, *S), each corner outside the map
    read as 0 (the JAX package's ``_bilinear_gather``)."""
    G, C, H, W = img.shape
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1 = ys - y0
    wx1 = xs - x0
    flat = img.reshape(G, C, H * W)
    spatial = ys.shape[1:]
    vals = 0.0
    for dy, wy in ((0, 1 - wy1), (1, wy1)):
        for dx, wx in ((0, 1 - wx1), (1, wx1)):
            yy = y0.to(torch.int64) + dy
            xx = x0.to(torch.int64) + dx
            ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)) \
                .reshape(G, 1, -1).expand(G, C, -1)
            v = torch.gather(flat, 2, idx).reshape(G, C, *spatial)
            vals = vals + v * (wy * wx * ok.to(img.dtype))[:, None]
    return vals


@register("_contrib_DeformableConvolution", nin=4,
          arg_names=["data", "offset", "weight", "bias"],
          defaults={"kernel": (), "stride": (), "dilate": (), "pad": (),
                    "num_filter": 0, "num_group": 1,
                    "num_deformable_group": 1, "workspace": 1024,
                    "no_bias": False, "layout": None},
          aliases=("DeformableConvolution",))
def deformable_convolution(data, offset, weight, bias=None, kernel=(),
                           stride=(), dilate=(), pad=(), num_filter=0,
                           num_group=1, num_deformable_group=1,
                           workspace=1024, no_bias=False, layout=None):
    """2-D deformable convolution: each tap samples the input bilinearly
    at its regular position plus a learned offset (``offset`` has
    2*num_deformable_group*kh*kw channels ordered (group, tap, (y, x))),
    then one grouped contraction with the weight."""
    kh, kw = as_tuple(kernel, 2)
    sh, sw = as_tuple(stride, 2) or (1, 1)
    dh, dw = as_tuple(dilate, 2) or (1, 1)
    ph, pw = as_tuple(pad, 2) or (0, 0)
    B, C, H, W = data.shape
    Fn, g, dg = int(num_filter), int(num_group), int(num_deformable_group)
    Ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    if data.device.type == "meta":
        return data.new_empty((B, Fn, Ho, Wo))
    dev, K = data.device, kh * kw
    oy = torch.arange(Ho, device=dev) * sh - ph
    ox = torch.arange(Wo, device=dev) * sw - pw
    ty = (torch.arange(kh, device=dev) * dh).repeat_interleave(kw)
    tx = (torch.arange(kw, device=dev) * dw).repeat(kh)
    base_y = (oy[None, :, None] + ty[:, None, None]).to(data.dtype)
    base_x = (ox[None, None, :] + tx[:, None, None]).to(data.dtype)
    off = offset.reshape(B, dg, K, 2, Ho, Wo)
    ys = base_y + off[:, :, :, 0]                        # (B, dg, K, Ho, Wo)
    xs = base_x + off[:, :, :, 1]
    dpg = C // dg
    cols = bilinear_gather(data.reshape(B * dg, dpg, H, W),
                           ys.reshape(B * dg, K, Ho, Wo),
                           xs.reshape(B * dg, K, Ho, Wo))
    cols = cols.reshape(B, g, C // g, K, Ho, Wo)
    wr = weight.reshape(g, Fn // g, C // g, K)
    out = torch.einsum("bgckhw,gfck->bgfhw", cols, wr).reshape(B, Fn, Ho, Wo)
    if not no_bias and bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


def _deform_conv_shapes(shapes, params):
    data = shapes[0]
    kernel = as_tuple(params.get("kernel")) or ()
    num_filter = int(params.get("num_filter", 0))
    out = {2: (num_filter, data[1] // int(params.get("num_group", 1)))
           + kernel}
    if not params.get("no_bias", False):
        out[3] = (num_filter,)
    return out


get_op("_contrib_DeformableConvolution").param_shape_infer = \
    _deform_conv_shapes


# ---------------------------------------------------------------------------
# Proposal (the RPN's region proposals)
# ---------------------------------------------------------------------------

def generate_anchors(base_size, ratios, scales):
    """Faster R-CNN's anchors, ratio-major and scale-minor (reference
    proposal-inl.h GenerateAnchors)."""
    w = h = float(base_size)
    x_ctr = 0.5 * (w - 1.0)
    y_ctr = 0.5 * (h - 1.0)
    size = w * h
    anchors = []
    for ratio in ratios:
        size_ratio = np.floor(size / ratio)
        new_w = np.floor(np.sqrt(size_ratio) + 0.5)
        new_h = np.floor(new_w * ratio + 0.5)
        for scale in scales:
            sw = new_w * scale
            sh = new_h * scale
            anchors.append([x_ctr - 0.5 * (sw - 1), y_ctr - 0.5 * (sh - 1),
                            x_ctr + 0.5 * (sw - 1), y_ctr + 0.5 * (sh - 1)])
    return np.array(anchors, np.float32)


def greedy_keep(sup, n_post):
    """Greedy NMS on the host: ``sup`` (n, n) bool, row i suppresses the
    rows j > i it marks. Visits the rows in order, keeps each one not
    suppressed by a kept row, until ``n_post`` are kept. Returns the
    kept indices."""
    suppressed = np.zeros(sup.shape[0], bool)
    keep = []
    for i in range(sup.shape[0]):
        if suppressed[i]:
            continue
        keep.append(i)
        if len(keep) == n_post:
            break
        suppressed |= sup[i]
    return keep


@register("_contrib_Proposal", nin=3,
          arg_names=["cls_prob", "bbox_pred", "im_info"], nout=2,
          defaults={"rpn_pre_nms_top_n": 6000, "rpn_post_nms_top_n": 300,
                    "threshold": 0.7, "rpn_min_size": 16,
                    "scales": (4.0, 8.0, 16.0, 32.0),
                    "ratios": (0.5, 1.0, 2.0), "feature_stride": 16,
                    "output_score": False, "iou_loss": False},
          no_grad=True, aliases=("Proposal", "_contrib_proposal"))
def proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4.0, 8.0, 16.0, 32.0), ratios=(0.5, 1.0, 2.0),
             feature_stride=16, output_score=False, iou_loss=False):
    """RPN proposals of image 0: shifted anchors moved by the deltas,
    clipped to the image, small boxes and anchors past the image's
    feature extent scored -1, the top ``rpn_pre_nms_top_n`` by score
    (stable), greedy NMS, ``rpn_post_nms_top_n`` rois [0, x1, y1, x2, y2]
    (the kept list repeated cyclically when short) and their scores."""
    if iou_loss:
        raise MXNetError("iou_loss=True is not supported")
    cls_prob, bbox_pred, im_info = cls_prob.detach(), bbox_pred.detach(), \
        im_info.detach()
    scales = parse_floats(scales)
    ratios = parse_floats(ratios)
    B, A2, Hf, Wf = cls_prob.shape
    A = A2 // 2
    dev, f32 = cls_prob.device, torch.float32
    n_post = int(rpn_post_nms_top_n)
    if dev.type == "meta":
        return (torch.empty((n_post, 5), device=dev),
                torch.empty((n_post, 1), device=dev))
    anchors = torch.from_numpy(generate_anchors(feature_stride, ratios,
                                                scales)).to(dev)
    sx = (torch.arange(Wf, device=dev) * feature_stride)[None, :] \
        .expand(Hf, Wf)
    sy = (torch.arange(Hf, device=dev) * feature_stride)[:, None] \
        .expand(Hf, Wf)
    shifts = torch.stack([sx, sy, sx, sy], dim=-1)                 # (H, W, 4)
    boxes = (anchors[None, None] + shifts[:, :, None, :]).reshape(-1, 4) \
        .to(f32)
    scores = cls_prob[0, A:].permute(1, 2, 0).reshape(-1)
    deltas = bbox_pred[0].reshape(A, 4, Hf, Wf).permute(2, 3, 0, 1) \
        .reshape(-1, 4)
    im_h, im_w, im_scale = im_info[0, 0], im_info[0, 1], im_info[0, 2]
    bw = boxes[:, 2] - boxes[:, 0] + 1.0
    bh = boxes[:, 3] - boxes[:, 1] + 1.0
    cx = boxes[:, 0] + 0.5 * (bw - 1.0)
    cy = boxes[:, 1] + 0.5 * (bh - 1.0)
    pcx = deltas[:, 0] * bw + cx
    pcy = deltas[:, 1] * bh + cy
    pw_ = torch.exp(deltas[:, 2]) * bw
    ph_ = torch.exp(deltas[:, 3]) * bh
    zero = torch.zeros((), dtype=f32, device=dev)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), hi)

    x1 = clip(pcx - 0.5 * (pw_ - 1.0), im_w - 1.0)
    y1 = clip(pcy - 0.5 * (ph_ - 1.0), im_h - 1.0)
    x2 = clip(pcx + 0.5 * (pw_ - 1.0), im_w - 1.0)
    y2 = clip(pcy + 0.5 * (ph_ - 1.0), im_h - 1.0)
    real_h = (im_h / feature_stride).to(torch.int64)
    real_w = (im_w / feature_stride).to(torch.int64)
    i = torch.arange(Hf * Wf * A, device=dev)
    minus1 = torch.full((), -1.0, dtype=scores.dtype, device=dev)
    scores = torch.where(((i // (Wf * A)) >= real_h)
                         | (((i // A) % Wf) >= real_w), minus1, scores)
    min_size = rpn_min_size * im_scale
    small = ((x2 - x1 + 1.0) < min_size) | ((y2 - y1 + 1.0) < min_size)
    x1 = torch.where(small, x1 - min_size / 2, x1)
    y1 = torch.where(small, y1 - min_size / 2, y1)
    x2 = torch.where(small, x2 + min_size / 2, x2)
    y2 = torch.where(small, y2 + min_size / 2, y2)
    scores = torch.where(small, minus1, scores)
    n_pre = min(int(rpn_pre_nms_top_n), scores.shape[0])
    order = torch.sort(-scores, stable=True).indices[:n_pre]
    dx1, dy1, dx2, dy2 = x1[order], y1[order], x2[order], y2[order]
    dsc = scores[order]
    # the whole n_pre x n_pre suppression mask at once (the JAX package's
    # row-by-row IoU, operation for operation)
    areas = (dx2 - dx1 + 1.0) * (dy2 - dy1 + 1.0)
    iw = (torch.minimum(dx2[:, None], dx2) - torch.maximum(dx1[:, None], dx1)
          + 1.0).clamp_min(0.0)
    ih = (torch.minimum(dy2[:, None], dy2) - torch.maximum(dy1[:, None], dy1)
          + 1.0).clamp_min(0.0)
    inter = iw * ih
    iou = inter / (areas[:, None] + areas - inter)
    idx = torch.arange(n_pre, device=dev)
    sup = (iou > threshold) & (idx[None, :] > idx[:, None])
    keep = greedy_keep(sup.cpu().numpy(), n_post)
    keep = np.asarray(keep or [0], np.int64)
    pick = torch.from_numpy(keep[np.arange(n_post) % len(keep)]).to(dev)
    rois = torch.stack([torch.zeros(n_post, dtype=f32, device=dev),
                        dx1[pick], dy1[pick], dx2[pick], dy2[pick]], dim=1)
    return rois, dsc[pick].reshape(-1, 1)


get_op("_contrib_Proposal").visible_outputs = 1

# BatchNorm_v1 shares the modern BatchNorm's executor contracts
from . import nn as _nn  # noqa: E402

_bnv1 = get_op("BatchNorm_v1")
_bnv1.visible_outputs = 1
_bnv1.aux_inputs = (3, 4)
_bnv1.stateful_update = _nn._bn_stateful_update(3, 4)
_bnv1.param_dtype_infer = _nn._bn_param_dtypes(1)
