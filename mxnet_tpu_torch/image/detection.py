"""Detection image pipeline.

Counterpart of ``mxnet_tpu/image/detection.py`` (the reference's
``python/mxnet/image/detection.py``): augmenters that take and return an
``(image, label)`` pair, label rows ``[class, x1, y1, x2, y2]`` with the
box normalised to [0, 1] (class -1 marks a dropped row), and
``ImageDetIter``, whose labels are ``(batch, max_boxes, 5)`` padded with
``label_pad``. A record's label is its multi-label header (``flag`` rows
of 5 floats); a payload of exactly ``C*H*W`` bytes is a raw uint8 **HWC**
image. The random augmenters draw from Python's ``random`` in the JAX
package's order.
"""
from __future__ import annotations

import random

import numpy as np

from .image import (ImageIter, imresize, imdecode, nd_array, _np, _listed,
                    ResizeAug, CastAug, ColorNormalizeAug)
# the JAX module's namespace holds these too
from ..base import MXNetError  # noqa: F401,E402
from .image import Augmenter, resize_short, color_normalize  # noqa: F401,E402

__all__ = ["DetAugmenter", "DetBorrowAug", "DetRandomCropAug",
           "DetHorizontalFlipAug", "CreateDetAugmenter", "ImageDetIter"]


class DetAugmenter:
    """(parity: detection.DetAugmenter)"""

    def __init__(self, **kwargs):
        self._kwargs = _listed(kwargs)

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """An image-only augmenter applied to the image of the pair."""

    def __init__(self, augmenter):
        super().__init__(augmenter=augmenter.dumps() if hasattr(
            augmenter, "dumps") else str(augmenter))
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetHorizontalFlipAug(DetAugmenter):
    """With probability ``p``, the image and its boxes mirrored."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if random.random() < self.p:
            src = nd_array(_np(src)[:, ::-1])
            label = label.copy()
            tmp = 1.0 - label[:, 3]
            label[:, 3] = 1.0 - label[:, 1]
            label[:, 1] = tmp
        return src, label


class DetRandomCropAug(DetAugmenter):
    """A random crop whose window holds the centre of at least one box;
    boxes whose centre falls outside become class -1 (the JAX package's
    simplified constraint set)."""

    def __init__(self, min_object_covered=0.1, aspect_ratio_range=(0.75, 1.33),
                 area_range=(0.05, 1.0), max_attempts=50):
        super().__init__()
        self.min_object_covered = min_object_covered
        self.area_range = area_range
        self.aspect_ratio_range = aspect_ratio_range
        self.max_attempts = max_attempts

    def __call__(self, src, label):
        arr = _np(src)
        h, w = arr.shape[:2]
        for _ in range(self.max_attempts):
            area = random.uniform(*self.area_range) * h * w
            ratio = random.uniform(*self.aspect_ratio_range)
            cw = int(np.sqrt(area * ratio))
            ch = int(np.sqrt(area / ratio))
            if cw > w or ch > h:
                continue
            x0 = random.randint(0, w - cw)
            y0 = random.randint(0, h - ch)
            crop = (x0 / w, y0 / h, (x0 + cw) / w, (y0 + ch) / h)
            new_label = self._update_labels(label, crop)
            if new_label is not None:
                return nd_array(arr[y0:y0 + ch, x0:x0 + cw]), new_label
        return src, label

    def _update_labels(self, label, crop):
        x1, y1, x2, y2 = crop
        out = label.copy()
        boxes = out[:, 1:5]
        valid = out[:, 0] >= 0
        cx = (boxes[:, 0] + boxes[:, 2]) / 2
        cy = (boxes[:, 1] + boxes[:, 3]) / 2
        keep = valid & (cx > x1) & (cx < x2) & (cy > y1) & (cy < y2)
        if not keep.any():
            return None
        sw, sh = x2 - x1, y2 - y1
        boxes[:, [0, 2]] = np.clip((boxes[:, [0, 2]] - x1) / sw, 0, 1)
        boxes[:, [1, 3]] = np.clip((boxes[:, [1, 3]] - y1) / sh, 0, 1)
        out[:, 1:5] = boxes
        out[:, 0] = np.where(keep, out[:, 0], -1)
        return out


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_mirror=False,
                       mean=None, std=None, **kwargs):
    """The standard detection augmenter list (parity:
    detection.CreateDetAugmenter)."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(ResizeAug(resize)))
    if rand_crop > 0:
        auglist.append(DetRandomCropAug())
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    auglist.append(DetBorrowAug(CastAug()))
    if mean is not None:
        auglist.append(DetBorrowAug(ColorNormalizeAug(
            mean if mean is not True else np.array([123.68, 116.28, 103.53]),
            std if std not in (None, True) else np.array([58.395, 57.12,
                                                          57.375]))))
    return auglist


class ImageDetIter(ImageIter):
    """Detection iterator: ``(B, C, H, W)`` images and ``(B, max_boxes,
    5)`` labels (parity: detection.ImageDetIter)."""

    def __init__(self, batch_size, data_shape, label_pad=-1, max_boxes=16,
                 aug_list=None, **kwargs):
        self.max_boxes = max_boxes
        self.label_pad = label_pad
        if aug_list is None:
            aug_list = CreateDetAugmenter(data_shape)
        super().__init__(batch_size, data_shape, label_width=1,
                         aug_list=[], **kwargs)
        self.det_auglist = aug_list

    @property
    def provide_label(self):
        from ..io import DataDesc
        return [DataDesc("label", (self.batch_size, self.max_boxes, 5))]

    def next(self):
        from ..io import DataBatch
        c, h, w = self.data_shape
        batch_data = np.zeros((self.batch_size, c, h, w), np.float32)
        batch_label = np.full((self.batch_size, self.max_boxes, 5),
                              self.label_pad, np.float32)
        for i in range(self.batch_size):
            label, s = self.next_sample()
            raw = np.frombuffer(s, np.uint8)
            img = nd_array(raw.reshape(h, w, c)) if raw.size == c * h * w \
                else imdecode(s)
            label = np.asarray(label, np.float32).reshape(-1, 5) \
                if np.asarray(label).size % 5 == 0 else \
                np.zeros((0, 5), np.float32)
            for aug in self.det_auglist:
                img, label = aug(img, label)
            arr = img.asnumpy().astype(np.float32)
            if arr.shape[:2] != (h, w):
                arr = imresize(nd_array(arr.astype(np.uint8)), w, h) \
                    .asnumpy().astype(np.float32)
            batch_data[i] = arr.transpose(2, 0, 1)
            n = min(len(label), self.max_boxes)
            batch_label[i, :n] = label[:n]
        return DataBatch([nd_array(batch_data)], [nd_array(batch_label)],
                         pad=0)
