"""Spatial transform operators.

Counterpart of ``mxnet_tpu/ops/spatial.py`` (reference
``src/operator/grid_generator.cc``, ``bilinear_sampler.cc``,
``spatial_transformer.cc``). The sampler is the JAX package's
``_bilinear_sample`` written out: the four corners gathered with their
indices clipped, each corner outside ``[0, W-1] x [0, H-1]`` read as 0,
and corners ``(W-1)/2`` and ``(H-1)/2`` from the grid's ``[-1, 1]``
(``F.grid_sample`` with ``align_corners=True`` is the same rule in
another order of operations).
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .common import as_tuple
from .registry import register


def bilinear_sample(data, grid_x, grid_y):
    """data (B, C, H, W); grid_x/grid_y (B, Ho, Wo) in [-1, 1] ->
    (B, C, Ho, Wo)."""
    B, C, H, W = data.shape
    x = (grid_x + 1) * (W - 1) / 2
    y = (grid_y + 1) * (H - 1) / 2
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1 = x0 + 1
    y1 = y0 + 1
    wx1 = x - x0
    wy1 = y - y0
    wx0 = 1 - wx1
    wy0 = 1 - wy1
    flat = data.reshape(B, C, H * W)

    def gather(yy, xx):
        inb = (xx >= 0) & (xx <= W - 1) & (yy >= 0) & (yy <= H - 1)
        xi = xx.clamp(0, W - 1).to(torch.int64)
        yi = yy.clamp(0, H - 1).to(torch.int64)
        idx = (yi * W + xi).reshape(B, 1, -1).expand(B, C, -1)
        vals = torch.gather(flat, 2, idx).reshape(B, C, *xx.shape[1:])
        zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
        return torch.where(inb[:, None], vals, zero)

    return (gather(y0, x0) * (wy0 * wx0)[:, None]
            + gather(y0, x1) * (wy0 * wx1)[:, None]
            + gather(y1, x0) * (wy1 * wx0)[:, None]
            + gather(y1, x1) * (wy1 * wx1)[:, None])


@register("BilinearSampler", nin=2, arg_names=["data", "grid"])
def bilinear_sampler(data, grid):
    """data (B, C, H, W); grid (B, 2, Ho, Wo) of (x, y) in [-1, 1]."""
    return bilinear_sample(data, grid[:, 0], grid[:, 1])


@register("GridGenerator", defaults={"transform_type": "affine",
                                     "target_shape": ()})
def grid_generator(data, transform_type="affine", target_shape=()):
    """affine: data (B, 6) -> grid (B, 2, H, W); warp: a flow (B, 2, H, W)
    in pixels -> grid."""
    if transform_type == "affine":
        H, W = as_tuple(target_shape, 2)
        dev = data.device
        ys = torch.linspace(-1, 1, H, device=dev, dtype=torch.float32)
        xs = torch.linspace(-1, 1, W, device=dev, dtype=torch.float32)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        base = torch.stack([gx, gy, torch.ones_like(gx)], dim=0) \
            .reshape(3, -1).to(data.dtype)                       # (3, H*W)
        return torch.matmul(data.reshape(-1, 2, 3), base) \
            .reshape(-1, 2, H, W)
    if transform_type == "warp":
        B, _, H, W = data.shape
        ys = torch.arange(H, dtype=data.dtype, device=data.device)
        xs = torch.arange(W, dtype=data.dtype, device=data.device)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        x = (data[:, 0] + gx) * 2 / max(W - 1, 1) - 1
        y = (data[:, 1] + gy) * 2 / max(H - 1, 1) - 1
        return torch.stack([x, y], dim=1)
    raise MXNetError("unknown transform_type %r" % transform_type)


@register("SpatialTransformer", nin=2, arg_names=["data", "loc"],
          defaults={"target_shape": (), "transform_type": "affine",
                    "sampler_type": "bilinear", "cudnn_off": False})
def spatial_transformer(data, loc, target_shape=(), transform_type="affine",
                        sampler_type="bilinear", cudnn_off=False):
    """An affine grid from ``loc`` (B, 6), then the bilinear sampler."""
    grid = grid_generator(loc, transform_type="affine",
                          target_shape=target_shape)
    return bilinear_sampler(data, grid)
