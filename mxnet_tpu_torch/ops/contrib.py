"""Contrib operators: the SSD multibox family and ROIPooling.

Counterpart of ``mxnet_tpu/ops/contrib.py`` (reference
``src/operator/contrib/multibox_prior.cc``, ``multibox_target.cc``,
``multibox_detection.cc`` and ``src/operator/roi_pooling.cc``). No TPU
kernel backs any of them: they run on PyTorch's own operators.

Two of them are sequential in the JAX package and are not here:

- ``MultiBoxDetection``'s greedy NMS is a ``lax.fori_loop`` over every
  score-sorted row. Only the first ``nms_topk`` rows can suppress, so the
  port builds the ``topk x N`` suppression mask on the device in one
  pass, resolves the greedy order among the first ``topk`` rows on a host
  copy of its ``topk x topk`` corner (``greedy_alive``), and derives every
  row's survival in one reduction on the device. No device work is
  launched per candidate row.
- ``ROIPooling`` masks the whole map for every ROI and bin at once in
  the JAX package, an ``(R, C, ph, pw, H, W)`` intermediate. The port takes
  the same maximum separably, over x for each column bin, then over y for
  each row bin, in chunks of ROIs that keep the gathered maps under
  ~256 MB.
"""
from __future__ import annotations

import ast

import numpy as np
import torch

from .common import as_tuple
from .registry import register

# largest element count of one ROI chunk's gathered feature maps
_ROI_CHUNK_ELEMS = 64 * 1024 * 1024
# largest element count of one image chunk's topk x N NMS mask
_NMS_CHUNK_ELEMS = 32 * 1024 * 1024


def parse_floats(v, default=()):
    if v is None:
        return tuple(default)
    if isinstance(v, str):
        v = ast.literal_eval(v)
    if isinstance(v, (int, float)):
        return (float(v),)
    return tuple(float(x) for x in v)


@register("_contrib_MultiBoxPrior", nin=1,
          defaults={"sizes": (1.0,), "ratios": (1.0,), "clip": False,
                    "steps": (-1.0, -1.0), "offsets": (0.5, 0.5)},
          no_grad=True, aliases=("MultiBoxPrior", "_contrib_multibox_prior"))
def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor boxes per feature-map cell: (1, H*W*(S+R-1), 4) corners,
    in the order (sizes[0], ratios[0]), (sizes[i>0], ratios[0]),
    (sizes[0], ratios[j>0]) at each cell."""
    sizes = parse_floats(sizes, (1.0,))
    ratios = parse_floats(ratios, (1.0,))
    offsets = parse_floats(offsets, (0.5, 0.5))
    steps = parse_floats(steps, (-1.0, -1.0))
    H, W = data.shape[2], data.shape[3]
    dev = data.device
    step_y = steps[0] if steps[0] > 0 else 1.0 / H
    step_x = steps[1] if steps[1] > 0 else 1.0 / W
    cy = (torch.arange(H, device=dev, dtype=torch.float32) + offsets[0]) \
        * step_y
    cx = (torch.arange(W, device=dev, dtype=torch.float32) + offsets[1]) \
        * step_x
    cy, cx = torch.meshgrid(cy, cx, indexing="ij")
    whs = [(s * np.sqrt(ratios[0]), s / np.sqrt(ratios[0])) for s in sizes]
    whs += [(sizes[0] * np.sqrt(r), sizes[0] / np.sqrt(r))
            for r in ratios[1:]]
    whs = torch.tensor(np.asarray(whs, np.float32), device=dev)   # (A, 2)
    A = whs.shape[0]
    cxy = torch.stack([cx, cy], dim=-1).reshape(H * W, 1, 2)
    half = whs.reshape(1, A, 2) / 2.0
    out = torch.cat([cxy - half, cxy + half], dim=-1).reshape(1, H * W * A, 4)
    if clip:
        out = out.clamp(0.0, 1.0)
    return out


def box_iou(a, b):
    """Corner boxes ``a`` (..., N, 4) and ``b`` (..., M, 4) -> IoU
    (..., N, M), 0 where the union is empty (the JAX package's ``_iou``,
    operation for operation)."""
    ax1, ay1, ax2, ay2 = a.unbind(-1)
    bx1, by1, bx2, by2 = b.unbind(-1)
    ix1 = torch.maximum(ax1[..., :, None], bx1[..., None, :])
    iy1 = torch.maximum(ay1[..., :, None], by1[..., None, :])
    ix2 = torch.minimum(ax2[..., :, None], bx2[..., None, :])
    iy2 = torch.minimum(ay2[..., :, None], by2[..., None, :])
    inter = (ix2 - ix1).clamp_min(0.0) * (iy2 - iy1).clamp_min(0.0)
    area_a = ((ax2 - ax1) * (ay2 - ay1)).clamp_min(0.0)
    area_b = ((bx2 - bx1) * (by2 - by1)).clamp_min(0.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def _centres(boxes):
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return w, h, (boxes[..., 0] + boxes[..., 2]) / 2, \
        (boxes[..., 1] + boxes[..., 3]) / 2


def _encode_boxes(anchors, gt, variances):
    aw, ah, acx, acy = _centres(anchors)
    gw = (gt[..., 2] - gt[..., 0]).clamp_min(1e-8)
    gh = (gt[..., 3] - gt[..., 1]).clamp_min(1e-8)
    gcx = (gt[..., 0] + gt[..., 2]) / 2
    gcy = (gt[..., 1] + gt[..., 3]) / 2
    tx = (gcx - acx) / aw.clamp_min(1e-8) / variances[0]
    ty = (gcy - acy) / ah.clamp_min(1e-8) / variances[1]
    tw = torch.log(gw / aw.clamp_min(1e-8)) / variances[2]
    th = torch.log(gh / ah.clamp_min(1e-8)) / variances[3]
    return torch.stack([tx, ty, tw, th], dim=-1)


@register("_contrib_MultiBoxTarget", nin=3,
          arg_names=["anchor", "label", "cls_pred"], nout=3,
          defaults={"overlap_threshold": 0.5, "ignore_label": -1.0,
                    "negative_mining_ratio": -1.0,
                    "negative_mining_thresh": 0.5,
                    "minimum_negative_samples": 0,
                    "variances": (0.1, 0.1, 0.2, 0.2)},
          no_grad=True,
          aliases=("MultiBoxTarget", "_contrib_multibox_target"))
def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """Training targets of every anchor, the whole batch at once.

    anchor (1, N, 4); label (B, M, 5) [cls, x1, y1, x2, y2] padded with
    cls -1; cls_pred (B, C, N). Returns (loc_target (B, N*4), loc_mask
    (B, N*4), cls_target (B, N)). Each valid ground truth claims its best
    anchor (the first on ties) whatever the overlap; a padded one claims
    nothing. Hard negatives are the non-matched anchors of least
    background confidence, ranked by a stable sort."""
    variances = parse_floats(variances, (0.1, 0.1, 0.2, 0.2))
    anchor, label, cls_pred = anchor.detach(), label.detach(), \
        cls_pred.detach()
    anchors = anchor.reshape(-1, 4)
    N = anchors.shape[0]
    B = label.shape[0]
    valid = label[:, :, 0] >= 0                                   # (B, M)
    iou = box_iou(anchors, label[:, :, 1:5])                      # (B, N, M)
    iou = torch.where(valid[:, None, :], iou, torch.full_like(iou, -1.0))
    best_iou = iou.amax(dim=2)                                    # (B, N)
    best_gt = iou.argmax(dim=2)                      # the first on ties
    best_anchor = iou.argmax(dim=1)                               # (B, M)
    # a max-scatter: padded ground truths (whose argmax is anchor 0)
    # never clear a real one's forced match
    forced = torch.zeros((B, N), dtype=torch.uint8, device=anchor.device)
    forced.scatter_reduce_(1, best_anchor, valid.to(torch.uint8), "amax")
    pos = forced.bool() | (best_iou >= overlap_threshold)
    matched = torch.gather(label, 1,
                           best_gt[..., None].expand(B, N, label.shape[2]))
    zero = torch.zeros((), dtype=label.dtype, device=label.device)
    cls_t = torch.where(pos, matched[..., 0] + 1.0, zero)
    loc_t = _encode_boxes(anchors, matched[..., 1:5], variances) \
        * pos[..., None]
    mask = pos[..., None].expand(B, N, 4).to(torch.float32)
    if negative_mining_ratio > 0:
        n_pos = pos.sum(dim=1, dtype=torch.int32)
        n_neg = torch.clamp_min(n_pos.to(torch.float32)
                                * float(negative_mining_ratio),
                                float(minimum_negative_samples)) \
            .to(torch.int32)
        neg_cand = ~pos & (best_iou < negative_mining_thresh)
        # ascending background confidence, candidates first, ties in
        # anchor order: jnp.argsort(-hardness) of the JAX package
        key = torch.where(neg_cand, cls_pred[:, 0, :],
                          torch.full_like(best_iou, float("inf")))
        order = torch.sort(key, dim=1, stable=True).indices
        rank = torch.empty_like(order)
        rank.scatter_(1, order, torch.arange(N, device=order.device)
                      .expand(B, N).contiguous())
        keep_neg = neg_cand & (rank < n_neg[:, None])
        cls_t = torch.where(pos, cls_t, torch.where(
            keep_neg, zero, torch.full_like(cls_t, float(ignore_label))))
    return (loc_t.reshape(B, -1), mask.reshape(B, -1),
            cls_t.to(label.dtype))


def _decode_boxes(anchors, deltas, variances):
    aw, ah, acx, acy = _centres(anchors)
    cx = deltas[..., 0] * variances[0] * aw + acx
    cy = deltas[..., 1] * variances[1] * ah + acy
    w = torch.exp(torch.clamp(deltas[..., 2] * variances[2], -10, 10)) * aw
    h = torch.exp(torch.clamp(deltas[..., 3] * variances[3], -10, 10)) * ah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def greedy_alive(sup, can):
    """The greedy order on the host: ``sup`` (B, K, K) bool, row i
    suppresses row j > i; ``can`` (B, K) bool, row i may suppress at all.
    Row i survives unless a surviving earlier row that may suppress
    suppresses it. Returns the survivors that may suppress, (B, K)."""
    alive = np.ones(can.shape, bool)
    for i in range(can.shape[1]):
        cur = alive[:, i] & can[:, i]
        if cur.any():
            alive[cur] &= ~sup[cur, i]
    return alive & can


# the host's part of MultiBoxDetection's NMS: seconds and calls since a
# caller last reset them (the card phase reports them per step)
nms_host_s = {"s": 0.0, "calls": 0}


def _nms_rows(boxes_s, cls_s, topk, nms_threshold, force_suppress):
    """Survival of every score-sorted row (B, N): rows i < topk with
    class >= 0 suppress the rows after them of IoU > threshold (of the
    same class unless ``force_suppress``), greedily in score order."""
    import time
    B, N = cls_s.shape
    K = min(N, topk)
    idx = torch.arange(N, device=cls_s.device)
    later = idx[None, :] > idx[:K, None]                           # (K, N)
    out = []
    per = max(1, _NMS_CHUNK_ELEMS // max(K * N, 1))
    for b0 in range(0, B, per):
        bx, cl = boxes_s[b0:b0 + per], cls_s[b0:b0 + per]
        sup = box_iou(bx[:, :K], bx) > nms_threshold               # (b, K, N)
        if not force_suppress:
            sup &= cl[:, :K, None] == cl[:, None, :]
        sup &= later
        can = cl[:, :K] >= 0
        t0 = time.perf_counter()
        alive_k = greedy_alive(sup[:, :, :K].cpu().numpy(),
                               can.cpu().numpy())
        nms_host_s["s"] += time.perf_counter() - t0
        nms_host_s["calls"] += 1
        alive_k = torch.from_numpy(alive_k).to(sup.device)
        out.append(~(sup & alive_k[:, :, None]).any(dim=1))
    return torch.cat(out, 0)


@register("_contrib_MultiBoxDetection", nin=3,
          arg_names=["cls_prob", "loc_pred", "anchor"],
          defaults={"clip": True, "threshold": 0.01, "background_id": 0,
                    "nms_threshold": 0.5, "force_suppress": False,
                    "variances": (0.1, 0.1, 0.2, 0.2), "nms_topk": -1},
          no_grad=True,
          aliases=("MultiBoxDetection", "_contrib_multibox_detection"))
def multibox_detection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                       background_id=0, nms_threshold=0.5,
                       force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                       nms_topk=-1):
    """Decode and NMS: cls_prob (B, C, N), loc_pred (B, N*4), anchor
    (1, N, 4) -> (B, N, 6) rows [cls_id, score, x1, y1, x2, y2] in
    descending score order (stable), suppressed and sub-threshold rows
    with cls_id -1."""
    variances = parse_floats(variances, (0.1, 0.1, 0.2, 0.2))
    cls_prob, loc_pred, anchor = cls_prob.detach(), loc_pred.detach(), \
        anchor.detach()
    anchors = anchor.reshape(-1, 4)
    B, C, N = cls_prob.shape
    boxes = _decode_boxes(anchors, loc_pred.reshape(B, N, 4), variances)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    fg = torch.cat([cls_prob[:, :background_id],
                    cls_prob[:, background_id + 1:]], dim=1) \
        if C > 1 else cls_prob
    score = fg.amax(dim=1)
    cls_id = fg.argmax(dim=1).to(cls_prob.dtype)
    cls_id = torch.where(score > threshold, cls_id,
                         torch.full_like(cls_id, -1.0))
    order = torch.sort(-score, dim=1, stable=True).indices
    cls_s = torch.gather(cls_id, 1, order)
    score_s = torch.gather(score, 1, order)
    boxes_s = torch.gather(boxes, 1, order[..., None].expand(B, N, 4))
    topk = int(nms_topk) if nms_topk and int(nms_topk) > 0 else N
    if cls_prob.device.type == "meta":
        alive = torch.ones_like(cls_s, dtype=torch.bool)
    else:
        alive = _nms_rows(boxes_s, cls_s, topk, nms_threshold,
                          bool(force_suppress))
    cls_out = torch.where(alive, cls_s, torch.full_like(cls_s, -1.0))
    return torch.cat([cls_out[..., None], score_s[..., None], boxes_s],
                     dim=-1)


def _masked_max(x, mask, dim):
    """Max of ``x`` over ``dim`` where ``mask`` holds, -inf elsewhere."""
    return torch.where(mask, x, torch.full((), float("-inf"),
                                           dtype=x.dtype,
                                           device=x.device)).amax(dim=dim)


@register("ROIPooling", nin=2, arg_names=["data", "rois"],
          defaults={"pooled_size": (), "spatial_scale": 1.0})
def roi_pooling(data, rois, pooled_size=(), spatial_scale=1.0):
    """Max-pool regions of interest: data (B, C, H, W); rois (R, 5)
    [batch_idx, x1, y1, x2, y2] in image coordinates -> (R, C, ph, pw).
    Coordinates round half to even after scaling; bin edges take floor
    and ceil; an empty bin gives 0. The gradient reaches ``data`` only."""
    ph, pw = as_tuple(pooled_size, 2)
    B, C, H, W = data.shape
    rois = rois.detach()
    f32 = torch.float32
    dev = data.device
    b = rois[:, 0].to(torch.int64)
    x1, y1, x2, y2 = (torch.round(rois[:, i].to(f32) * spatial_scale)
                      for i in range(1, 5))
    bin_h = (y2 - y1 + 1).clamp_min(1.0) / ph
    bin_w = (x2 - x1 + 1).clamp_min(1.0) / pw
    iy = torch.arange(ph, dtype=f32, device=dev)
    ix = torch.arange(pw, dtype=f32, device=dev)
    y_lo = torch.floor(y1[:, None] + iy * bin_h[:, None])         # (R, ph)
    y_hi = torch.ceil(y1[:, None] + (iy + 1) * bin_h[:, None])
    x_lo = torch.floor(x1[:, None] + ix * bin_w[:, None])         # (R, pw)
    x_hi = torch.ceil(x1[:, None] + (ix + 1) * bin_w[:, None])
    ys = torch.arange(H, dtype=f32, device=dev)
    xs = torch.arange(W, dtype=f32, device=dev)
    ymask = (ys >= y_lo[..., None]) & (ys < y_hi[..., None])      # (R, ph, H)
    xmask = (xs >= x_lo[..., None]) & (xs < x_hi[..., None])      # (R, pw, W)
    R = rois.shape[0]
    if data.device.type == "meta" or R == 0:
        return data.new_zeros((R, C, ph, pw))
    per = max(1, _ROI_CHUNK_ELEMS // max(C * H * W, 1))
    outs = []
    for r0 in range(0, R, per):
        fmap = data[b[r0:r0 + per]]                       # (r, C, H, W)
        xm = xmask[r0:r0 + per, :, None, None, :]
        ym = ymask[r0:r0 + per, :, None, :, None]
        # over x for each column bin: (r, C, H, pw)
        t = torch.stack([_masked_max(fmap, xm[:, j], -1)
                         for j in range(pw)], dim=-1)
        # over y for each row bin: (r, C, ph, pw)
        out = torch.stack([_masked_max(t, ym[:, i], 2)
                           for i in range(ph)], dim=2)
        outs.append(torch.where(torch.isfinite(out), out,
                                torch.zeros((), dtype=out.dtype,
                                            device=dev)))
    return torch.cat(outs, 0)
