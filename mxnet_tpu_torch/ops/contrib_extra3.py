"""Position-sensitive ROI pooling, batched proposals, count sketch, the
LQ and symmetric eigen factorizations, the slice-assign internals, the
cross-device copy, and the legacy layers (Crop and the ``_v1``/cuDNN
aliases).

Counterpart of ``mxnet_tpu/ops/contrib_extra3.py`` (reference
``contrib/psroi_pooling.cc``, ``contrib/deformable_psroi_pooling.cc``,
``contrib/multi_proposal.cc``, ``contrib/count_sketch.cc``,
``tensor/la_op.cc``, ``tensor/matrix_op.cc``, ``cross_device_copy.cc``,
``crop.cc``). No TPU kernel backs any of them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from .common import as_tuple
from .registry import register, alias, get_op
from .contrib_extra import bilinear_gather, proposal


# ---------------------------------------------------------------------------
# PSROIPooling (R-FCN)
# ---------------------------------------------------------------------------

def _ps_channel_index(output_dim, pooled, group):
    """The channel of each (ctop, ph, pw) bin: (ctop*G + gh)*G + gw."""
    ph = np.arange(pooled)
    gh = np.clip((ph * group) // pooled, 0, group - 1)
    c = (np.arange(output_dim)[:, None, None] * group +
         gh[None, :, None]) * group + gh[None, None, :]
    return c.astype(np.int64)


def _ps_pick(t, cidx):
    """t (R, C, P, P) -> (R, od, P, P): bin (ph, pw) of output channel
    ctop from its own input channel ``cidx[ctop, ph, pw]``."""
    od, P, _ = cidx.shape
    pi = torch.arange(P, device=t.device)
    c = torch.from_numpy(cidx).to(t.device)
    return t[:, c, pi[None, :, None], pi[None, None, :]]


def _roi_corners(rois, spatial_scale, shift=0.0):
    f32 = torch.float32
    x1 = torch.round(rois[:, 1]).to(f32) * spatial_scale - shift
    y1 = torch.round(rois[:, 2]).to(f32) * spatial_scale - shift
    x2 = (torch.round(rois[:, 3]) + 1.0).to(f32) * spatial_scale - shift
    y2 = (torch.round(rois[:, 4]) + 1.0).to(f32) * spatial_scale - shift
    return x1, y1, x2, y2


@register("_contrib_PSROIPooling", nin=2, arg_names=["data", "rois"],
          defaults={"spatial_scale": 1.0, "output_dim": 0, "pooled_size": 0,
                    "group_size": 0},
          aliases=("_contrib_psroipooling",))
def psroi_pooling(data, rois, spatial_scale=1.0, output_dim=0,
                  pooled_size=0, group_size=0):
    """Position-sensitive ROI average pooling: each output bin averages
    its own channel over the bin's [start, end) extent; coordinates round
    then scale; an empty bin gives 0."""
    P = int(pooled_size)
    G = int(group_size) or P
    od = int(output_dim)
    N, C, H, W = data.shape
    if C != od * G * G:
        raise MXNetError("PSROIPooling: channels %d != output_dim*group^2"
                         % C)
    rois = rois.detach()
    f32, dev = torch.float32, data.device
    x1, y1, x2, y2 = _roi_corners(rois, spatial_scale)
    bin_h = (y2 - y1).clamp_min(0.1) / P
    bin_w = (x2 - x1).clamp_min(0.1) / P
    ph = torch.arange(P, dtype=f32, device=dev)
    hstart = torch.floor(ph * bin_h[:, None] + y1[:, None]).clamp(0, H)
    hend = torch.ceil((ph + 1) * bin_h[:, None] + y1[:, None]).clamp(0, H)
    wstart = torch.floor(ph * bin_w[:, None] + x1[:, None]).clamp(0, W)
    wend = torch.ceil((ph + 1) * bin_w[:, None] + x1[:, None]).clamp(0, W)
    hs = torch.arange(H, dtype=f32, device=dev)
    ws = torch.arange(W, dtype=f32, device=dev)
    mask_h = ((hs >= hstart[..., None]) & (hs < hend[..., None])).to(f32)
    mask_w = ((ws >= wstart[..., None]) & (ws < wend[..., None])).to(f32)
    sel = data[rois[:, 0].to(torch.int64)].to(f32)               # (R,C,H,W)
    t = torch.einsum("rchw,rqw->rchq", sel, mask_w)
    t = torch.einsum("rchq,rph->rcpq", t, mask_h)                 # (R,C,P,P)
    out = _ps_pick(t, _ps_channel_index(od, P, G))
    area = ((hend - hstart)[:, None, :, None]
            * (wend - wstart)[:, None, None, :])
    out = torch.where(area > 0, out / area.clamp_min(1.0),
                      torch.zeros((), dtype=f32, device=dev))
    return out.to(data.dtype)


@register("_contrib_DeformablePSROIPooling", nin=3, nout=2,
          arg_names=["data", "rois", "trans"],
          defaults={"spatial_scale": 1.0, "output_dim": 0, "group_size": 0,
                    "pooled_size": 0, "part_size": 0, "sample_per_part": 1,
                    "trans_std": 0.0, "no_trans": False})
def deformable_psroi_pooling(data, rois, trans, spatial_scale=1.0,
                             output_dim=0, group_size=0, pooled_size=0,
                             part_size=0, sample_per_part=1, trans_std=0.0,
                             no_trans=False):
    """Deformable position-sensitive ROI pooling: each bin averages
    ``sample_per_part**2`` bilinear samples, moved by the
    (``trans_std``-scaled) offset of its part cell. Returns (output,
    sample count)."""
    P = int(pooled_size)
    G = int(group_size) or P
    od = int(output_dim)
    ps = int(part_size) or P
    sp = int(sample_per_part)
    N, C, H, W = data.shape
    f32, dev = torch.float32, data.device
    rois = rois.detach()
    R = rois.shape[0]
    x1, y1, x2, y2 = _roi_corners(rois, spatial_scale, 0.5)
    rw = (x2 - x1).clamp_min(0.1)
    rh = (y2 - y1).clamp_min(0.1)
    bin_h, bin_w = rh / P, rw / P
    sub_h, sub_w = bin_h / sp, bin_w / sp
    part_cell = torch.from_numpy(
        np.floor(np.arange(P) / P * ps).astype(np.int64)).to(dev)
    if no_trans:
        n_cls = 1
        cls_of = np.zeros(od, np.int64)
    else:
        n_cls = int(trans.shape[1]) // 2
        cls_of = np.arange(od) // max(od // n_cls, 1)
        tr = trans.to(f32).reshape(R, n_cls, 2, ps, ps)
        tx = tr[:, :, 0][:, :, part_cell][:, :, :, part_cell] * trans_std
        ty = tr[:, :, 1][:, :, part_cell][:, :, :, part_cell] * trans_std
    ph_f = torch.arange(P, dtype=f32, device=dev)
    ih = torch.arange(sp, dtype=f32, device=dev)
    r1 = (slice(None), None, None, None, None)
    bh = ph_f[None, :, None, None, None] * bin_h[r1] + y1[r1]
    bw = ph_f[None, None, :, None, None] * bin_w[r1] + x1[r1]
    sh = ih[None, None, None, :, None] * sub_h[r1]
    sw = ih[None, None, None, None, :] * sub_w[r1]
    cidx = _ps_channel_index(od, P, G)
    sel = data[rois[:, 0].to(torch.int64)].to(f32)               # (R,C,H,W)
    outs = torch.zeros((R, od, P, P), dtype=f32, device=dev)
    counts = torch.zeros((R, od, P, P), dtype=f32, device=dev)
    for cls in range(n_cls):
        if no_trans:
            oy = ox = torch.zeros((R, 1, 1, 1, 1), dtype=f32, device=dev)
        else:
            oy = (ty[:, cls] * rh[:, None, None])[..., None, None]
            ox = (tx[:, cls] * rw[:, None, None])[..., None, None]
        hh = torch.broadcast_to(bh + oy + sh, (R, P, P, sp, sp))
        ww = torch.broadcast_to(bw + ox + sw, (R, P, P, sp, sp))
        ok = (ww > -0.5) & (ww < W - 0.5) & (hh > -0.5) & (hh < H - 0.5)
        vals = bilinear_gather(sel, hh.clamp(0.0, H - 1.0),
                               ww.clamp(0.0, W - 1.0))    # (R,C,P,P,sp,sp)
        summed = (vals * ok[:, None].to(f32)).sum((-1, -2))
        cnt = ok.to(f32).sum((-1, -2))                            # (R, P, P)
        mask = torch.from_numpy(cls_of == cls).to(dev)[None, :, None, None]
        outs = torch.where(mask, _ps_pick(summed, cidx), outs)
        counts = torch.where(mask, cnt[:, None], counts)
    out = torch.where(counts > 0, outs / counts.clamp_min(1.0),
                      torch.zeros((), dtype=f32, device=dev))
    return out.to(data.dtype), counts.to(data.dtype)


get_op("_contrib_DeformablePSROIPooling").visible_outputs = 1


# ---------------------------------------------------------------------------
# MultiProposal: Proposal per image
# ---------------------------------------------------------------------------

@register("_contrib_MultiProposal", nin=3,
          arg_names=["cls_prob", "bbox_pred", "im_info"], nout=2,
          defaults={"rpn_pre_nms_top_n": 6000, "rpn_post_nms_top_n": 300,
                    "threshold": 0.7, "rpn_min_size": 16,
                    "scales": (4.0, 8.0, 16.0, 32.0),
                    "ratios": (0.5, 1.0, 2.0), "feature_stride": 16,
                    "output_score": False, "iou_loss": False},
          no_grad=True, aliases=("MultiProposal",))
def multi_proposal(cls_prob, bbox_pred, im_info, **params):
    """``Proposal`` of each image, its index in ``rois[:, 0]``:
    (B*post_nms, 5) rois and their scores."""
    rois_all, scores_all = [], []
    for i in range(cls_prob.shape[0]):
        rois, scores = proposal(cls_prob[i:i + 1], bbox_pred[i:i + 1],
                                im_info[i:i + 1], **params)
        rois[:, 0] = float(i)
        rois_all.append(rois)
        scores_all.append(scores)
    return torch.cat(rois_all, 0), torch.cat(scores_all, 0)


get_op("_contrib_MultiProposal").visible_outputs = 1


# ---------------------------------------------------------------------------
# count_sketch
# ---------------------------------------------------------------------------

@register("_contrib_count_sketch", nin=3, arg_names=["data", "h", "s"],
          defaults={"out_dim": 0, "processing_batch_size": 32})
def count_sketch(data, h, s, out_dim=0, processing_batch_size=32):
    """``out[..., h[j]] += s[j] * data[..., j]``: one product with the
    one-hot scatter matrix. ``processing_batch_size`` is ignored."""
    od = int(out_dim)
    in_dim = data.shape[-1]
    scatter = (h.detach().to(torch.int64)[:, None] ==
               torch.arange(od, device=data.device)[None, :]).to(data.dtype)
    scatter = scatter * s.detach().to(data.dtype)[:, None]
    return (data.reshape(-1, in_dim) @ scatter) \
        .reshape(data.shape[:-1] + (od,))


# ---------------------------------------------------------------------------
# linalg: LQ factorization and symmetric eigendecomposition
# ---------------------------------------------------------------------------

@register("_linalg_gelqf", nout=2, arg_names=["A"], aliases=("linalg_gelqf",))
def linalg_gelqf(A):
    """A = L Q with Q's rows orthonormal and L lower triangular, through
    the QR of A's transpose (LAPACK's sign convention on the CPU, as the
    JAX package's). A (..., x, y), x <= y -> (Q (..., x, y),
    L (..., x, x))."""
    q1, r1 = torch.linalg.qr(A.transpose(-1, -2), mode="reduced")
    return q1.transpose(-1, -2), r1.transpose(-1, -2)


@register("_linalg_syevd", nout=2, arg_names=["A"], aliases=("linalg_syevd",))
def linalg_syevd(A):
    """A = U^T diag(L) U for symmetric A: the rows of U are the
    eigenvectors, L ascending. An eigenvector's sign is the solver's
    choice (LAPACK's here and the JAX package's differ on some rows,
    cuSOLVER's may differ again), so each row of U is signed to make its
    entry of largest magnitude (the first of equals) positive."""
    w, v = torch.linalg.eigh(A)
    u = v.transpose(-1, -2)
    top = torch.gather(u, -1, u.abs().argmax(-1, keepdim=True))
    return u * torch.where(top < 0, -1.0, 1.0).to(u.dtype), w


# ---------------------------------------------------------------------------
# The slice-assign internals and the cross-device copy
# ---------------------------------------------------------------------------

def _slice_tuple(begin, end, step):
    from .tensor import _parse_seq
    begin, end = _parse_seq(begin), _parse_seq(end)
    step = _parse_seq(step) or (1,) * len(begin)
    return tuple(slice(b, e, step[d] if d < len(step) and step[d]
                       is not None else 1)
                 for d, (b, e) in enumerate(zip(begin, end)))


@register("_slice_assign", nin=2, arg_names=["lhs", "rhs"],
          defaults={"begin": (), "end": (), "step": ()},
          aliases=("_crop_assign",))
def slice_assign(lhs, rhs, begin=(), end=(), step=()):
    """``lhs`` with ``lhs[begin:end:step] = rhs`` (a new tensor)."""
    out = lhs.clone()
    out[_slice_tuple(begin, end, step)] = rhs
    return out


@register("_slice_assign_scalar", nin=1, arg_names=["data"],
          defaults={"scalar": 0.0, "begin": (), "end": (), "step": ()},
          aliases=("_crop_assign_scalar",))
def slice_assign_scalar(data, scalar=0.0, begin=(), end=(), step=()):
    """``data`` with ``data[begin:end:step] = scalar`` (a new tensor)."""
    out = data.clone()
    out[_slice_tuple(begin, end, step)] = scalar
    return out


@register("_CrossDeviceCopy", aliases=("_copyto",))
def cross_device_copy(data):
    """Identity in the graph: the executor moves values at a context
    group's boundary itself."""
    return data


# ---------------------------------------------------------------------------
# Crop and the legacy aliases
# ---------------------------------------------------------------------------

@register("Crop", nin=-1,
          defaults={"num_args": 1, "offset": (0, 0), "h_w": (0, 0),
                    "center_crop": False})
def crop(*inputs, num_args=1, offset=(0, 0), h_w=(0, 0), center_crop=False):
    """Crop (N, C, H, W) to ``h_w``, or to the spatial shape of a second
    input (whose values are not read: it gets no gradient), at ``offset``
    (y, x) or centred. A window past the input's extent raises."""
    data = inputs[0]
    H, W = data.shape[2], data.shape[3]
    if len(inputs) == 2:
        th, tw = inputs[1].shape[2], inputs[1].shape[3]
    else:
        th, tw = as_tuple(h_w, 2)
    if center_crop:
        oy, ox = (H - th) // 2, (W - tw) // 2
    else:
        oy, ox = as_tuple(offset, 2)
    if oy < 0 or ox < 0 or oy + th > H or ox + tw > W:
        raise MXNetError("Crop: the %dx%d window at (%d, %d) exceeds the "
                         "input's %dx%d" % (th, tw, oy, ox, H, W))
    return data[:, :, oy:oy + th, ox:ox + tw]


alias("Convolution", "Convolution_v1")
alias("Pooling", "Pooling_v1")
alias("BatchNorm", "CuDNNBatchNorm")
