"""2-bit gradient compression with error feedback, and the fp16 wire.

Counterpart of ``mxnet_tpu/gradient_compression.py`` (parity: reference
``src/kvstore/gradient_compression.{h,cc,cu}``): ``grad + residual`` is
quantised to ``+threshold`` (code 1), ``-threshold`` (code 2) or 0
(code 0); the quantisation error stays in a per-key residual added to
the next gradient. Sixteen 2-bit codes pack into one ``uint32`` word
(code ``i`` of a word at bits ``2i, 2i+1``), so a payload of ``n``
values is ``ceil(n / 16)`` words, bit-equal to the JAX package's for the
same input. ``fp16`` is a half-precision cast each way, stateless.

Plain PyTorch: the JAX package's is ``jnp`` too, not a Pallas kernel
(a bandwidth-bound elementwise pass). The codes are built in ``int64``
(torch's ``uint32`` has few operators) and the words come out as
``torch.uint32``; a collective moves them as ``int32`` bits (the dist
store's exchange, ``kvstore.py``, is the counterpart of the JAX
package's ``compressed_psum``).
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["GradientCompression", "quantize_2bit", "dequantize_2bit"]

_CODES_PER_WORD = 16  # 2 bits each in a uint32


def _num_words(size):
    return -(-size // _CODES_PER_WORD)


def _shifts(device):
    return 2 * torch.arange(_CODES_PER_WORD, dtype=torch.int64,
                            device=device)


def quantize_2bit(grad, residual, threshold=0.5):
    """``(packed, new_residual)``: ``grad + residual`` (summed in fp32)
    quantised to 2-bit codes packed into ``ceil(size/16)`` ``uint32``
    words, and the quantisation error in ``grad``'s dtype."""
    g = grad.float() + residual.float()
    pos, neg = g >= threshold, g <= -threshold
    q = torch.where(pos, torch.full_like(g, threshold),
                    torch.where(neg, torch.full_like(g, -threshold),
                                torch.zeros_like(g)))
    new_residual = (g - q).to(grad.dtype)
    codes = torch.where(pos, 1, torch.where(neg, 2, 0)).reshape(-1) \
        .to(torch.int64)
    pad = (-codes.numel()) % _CODES_PER_WORD
    if pad:
        codes = torch.cat([codes, codes.new_zeros(pad)])
    words = codes.reshape(-1, _CODES_PER_WORD) << _shifts(codes.device)
    packed = words.sum(dim=1).to(torch.uint32)   # disjoint bits: sum == or
    return packed, new_residual


def dequantize_2bit(packed, shape, threshold=0.5, dtype=torch.float32):
    """The inverse of :func:`quantize_2bit`: values of ``shape``."""
    size = 1
    for s in shape:
        size *= int(s)
    words = packed.to(torch.int64) & 0xFFFFFFFF
    codes = (words[:, None] >> _shifts(words.device)) & 3
    flat = codes.reshape(-1)[:size]
    one = torch.ones((), dtype=torch.float32, device=flat.device)
    vals = torch.where(flat == 1, one * threshold,
                       torch.where(flat == 2, one * -threshold, one * 0.0))
    return vals.reshape(tuple(shape)).to(dtype)


class GradientCompression:
    """Per-key stateful compressor (parity: reference
    ``GradientCompression`` and ``set_gradient_compression``'s kwargs).
    Types: ``"2bit"`` (threshold quantisation, a residual per key, 16x
    smaller wire) and ``"fp16"`` (a half-precision cast, 2x smaller)."""

    def __init__(self, type="2bit", threshold=0.5):
        if type not in ("2bit", "fp16"):
            raise MXNetError("unsupported compression type %r" % (type,))
        try:
            threshold = float(threshold)  # reference params arrive as strings
        except (TypeError, ValueError):
            raise MXNetError("threshold must be a number, got %r"
                             % (threshold,))
        if not threshold > 0:
            raise MXNetError("threshold must be positive")
        self.type = type
        self.threshold = threshold
        self._residuals = {}

    def compress(self, key, grad):
        """The wire payload of one gradient tensor; 2-bit keeps the
        residual under ``key``."""
        if self.type == "fp16":
            return grad.to(torch.float16)
        res = self._residuals.get(key)
        if res is None:
            res = torch.zeros_like(grad)
        packed, res = quantize_2bit(grad, res, self.threshold)
        self._residuals[key] = res
        return packed

    def decompress(self, packed, shape, dtype=torch.float32):
        if self.type == "fp16":
            return packed.to(dtype).reshape(tuple(shape))
        return dequantize_2bit(packed, shape, self.threshold, dtype)
