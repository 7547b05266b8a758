"""Image decode, augmentation and ``ImageIter``.

Counterpart of ``mxnet_tpu/image/image.py`` (the reference's
``python/mxnet/image/image.py``): PIL decodes and resizes (Pillow is
imported at first use; without it :func:`imdecode` and :func:`imresize`
raise ``MXNetError`` naming Pillow), numpy does the rest. Images are host
(``cpu()``) NDArrays in HWC layout, as upstream's are, whatever the
default context. The random augmenters draw from Python's ``random``
(crops, flips, jitters, ``ImageIter``'s shuffle) and numpy's global state
(``LightingAug``) in the JAX package's order, so one seed of both gives
both packages the same images.

``ImageIter`` reads a RecordIO file (through its ``.idx`` when there is
one) or an image list. A payload of exactly ``C*H*W`` bytes is a raw
uint8 **HWC** image; anything else is decoded. Batches are assembled in
one reused ``temp_space`` buffer (``resource.Resource``) and copied out
into each batch's NDArray, so an earlier batch never changes.
"""
from __future__ import annotations

import io as _io
import os
import random

import numpy as np

from ..base import MXNetError
from ..context import cpu
from ..io import DataIter, DataBatch, DataDesc
from ..ndarray.ndarray import NDArray, array as _nd_array

__all__ = ["imdecode", "imread", "imresize", "copyMakeBorder",
           "resize_short", "fixed_crop", "random_crop", "scale_down",
           "center_crop", "color_normalize", "random_size_crop",
           "ResizeAug", "RandomCropAug", "RandomSizedCropAug", "CenterCropAug",
           "HorizontalFlipAug", "CastAug", "ColorNormalizeAug",
           "SequentialAug", "ForceResizeAug", "HueJitterAug", "RandomGrayAug",
           "BrightnessJitterAug", "ContrastJitterAug", "SaturationJitterAug",
           "LightingAug", "ColorJitterAug", "RandomOrderAug",
           "CreateAugmenter", "ImageIter", "Augmenter"]


def nd_array(a):
    """A host NDArray (the image pipeline's arrays live on the CPU)."""
    return _nd_array(a, ctx=cpu())


def _np(src):
    return src.asnumpy() if isinstance(src, NDArray) else np.asarray(src)


def _pil():
    try:
        from PIL import Image
    except ImportError:
        raise MXNetError("image decode and resize need Pillow (PIL), which "
                         "is not installed")
    return Image


def imdecode(buf, flag=1, to_rgb=True, out=None):
    """Decode an encoded image buffer to an HWC uint8 NDArray (parity:
    mx.image.imdecode over cv2.imdecode): RGB (or BGR without
    ``to_rgb``) with ``flag`` 1, one channel with 0."""
    Image = _pil()
    img = Image.open(_io.BytesIO(bytes(buf)))
    img = img.convert("RGB" if flag else "L")
    arr = np.asarray(img, np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if not to_rgb and arr.shape[2] == 3:
        arr = arr[:, :, ::-1]
    return nd_array(arr)


def imread(filename, flag=1, to_rgb=True):
    """Read and decode an image file (parity: image.imread)."""
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


def scale_down(src_size, size):
    """Scale ``size`` down to fit in ``src_size``, keeping its aspect
    ratio (parity: image.scale_down)."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def imresize(src, w, h, interp=1):
    """Resize to ``w`` x ``h`` through PIL, bilinear unless ``interp`` is
    0 (nearest) (parity: mx.image.imresize)."""
    Image = _pil()
    img = Image.fromarray(_np(src).astype(np.uint8).squeeze())
    img = img.resize((w, h), Image.BILINEAR if interp else Image.NEAREST)
    out = np.asarray(img, np.uint8)
    if out.ndim == 2:
        out = out[:, :, None]
    return nd_array(out)


def copyMakeBorder(src, top, bot, left, right, type=0, value=0.0,
                   values=None, out=None):
    """Pad an HWC image with a border (parity: mx.image.copyMakeBorder,
    the opencv plugin's ``_cvcopyMakeBorder``). ``type`` takes the cv2
    codes: 0 CONSTANT (``value``, or ``values`` per channel),
    1 REPLICATE, 2 REFLECT, 3 WRAP, 4 REFLECT_101."""
    arr = _np(src)
    pad = ((int(top), int(bot)), (int(left), int(right))) \
        + ((0, 0),) * (arr.ndim - 2)
    btype = int(type)
    if btype == 0:
        if values is not None:
            if arr.ndim < 3:
                raise MXNetError(
                    "copyMakeBorder: per-channel values need an image "
                    "with a channel axis (ndim >= 3); got ndim=%d"
                    % arr.ndim)
            chans = [np.pad(arr[..., c], pad[:-1], mode="constant",
                            constant_values=np.asarray(v, arr.dtype))
                     for c, v in enumerate(
                         np.broadcast_to(np.asarray(values),
                                         (arr.shape[-1],)))]
            padded = np.stack(chans, axis=-1)
        else:
            padded = np.pad(arr, pad, mode="constant",
                            constant_values=np.asarray(value, arr.dtype))
    else:
        mode = {1: "edge", 2: "symmetric", 3: "wrap",
                4: "reflect"}.get(btype)
        if mode is None:
            raise MXNetError("unsupported border type %d" % btype)
        padded = np.pad(arr, pad, mode=mode)
    res = nd_array(padded)
    if out is not None:
        if tuple(out.shape) != tuple(res.shape):
            raise MXNetError(
                "copyMakeBorder: out shape %s != padded shape %s"
                % (tuple(out.shape), tuple(res.shape)))
        out[:] = res
        return out
    return res


def resize_short(src, size, interp=2):
    """Resize so that the shorter side is ``size``."""
    h, w = _np(src).shape[:2]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """The ``w`` x ``h`` crop at ``(x0, y0)``, resized to ``size``."""
    out = _np(src)[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        return imresize(nd_array(out), size[0], size[1], interp)
    return nd_array(out)


def random_crop(src, size, interp=2):
    """A crop of ``size`` at a position from ``random.randint``; returns
    ``(image, (x0, y0, w, h))``."""
    h, w = _np(src).shape[:2]
    new_w, new_h = size
    x0 = random.randint(0, max(w - new_w, 0))
    y0 = random.randint(0, max(h - new_h, 0))
    out = fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    """The centred crop of ``size``; returns ``(image, (x0, y0, w, h))``."""
    h, w = _np(src).shape[:2]
    new_w, new_h = size
    x0 = max((w - new_w) // 2, 0)
    y0 = max((h - new_h) // 2, 0)
    out = fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=2):
    """A crop of random area and aspect ratio (10 tries, then the centred
    crop), resized to ``size``."""
    h, w = _np(src).shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = random.uniform(*area) * src_area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        aspect = np.exp(random.uniform(*log_ratio))
        new_w = int(round(np.sqrt(target_area * aspect)))
        new_h = int(round(np.sqrt(target_area / aspect)))
        if new_w <= w and new_h <= h:
            x0 = random.randint(0, w - new_w)
            y0 = random.randint(0, h - new_h)
            return fixed_crop(src, x0, y0, new_w, new_h, size, interp), \
                (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def color_normalize(src, mean, std=None):
    """``(src - mean) / std`` in float32 (``mean``/``std`` broadcast over
    the channel axis)."""
    arr = _np(src).astype(np.float32) - _np(mean)
    if std is not None:
        arr = arr / _np(std)
    return nd_array(arr)


def _listed(kwargs):
    """Array keywords as lists, as upstream's augmenters keep them, so
    that ``dumps`` serialises them (the JAX package keeps the arrays and
    its ``dumps`` raises ``TypeError``)."""
    for k, v in kwargs.items():
        if isinstance(v, NDArray):
            v = v.asnumpy()
        if isinstance(v, (np.ndarray, np.generic)):
            kwargs[k] = v.tolist()
    return kwargs


class Augmenter:
    """(parity: image.Augmenter)"""

    def __init__(self, **kwargs):
        self._kwargs = _listed(kwargs)

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size = size
        self.area = area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if random.random() < self.p:
            return nd_array(_np(src)[:, ::-1])
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class SequentialAug(Augmenter):
    """Apply a list of augmenters in order."""

    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for t in self.ts:
            src = t(src)
        return src


class ForceResizeAug(Augmenter):
    """Resize to exactly ``size`` = (w, h), whatever the aspect ratio."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class HueJitterAug(Augmenter):
    """A random hue rotation in [-hue, hue] through YIQ space."""

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue
        self.tyiq = np.array([[0.299, 0.587, 0.114],
                              [0.596, -0.274, -0.321],
                              [0.211, -0.523, 0.311]])
        self.ityiq = np.array([[1.0, 0.956, 0.621],
                               [1.0, -0.272, -0.647],
                               [1.0, -1.107, 1.705]])

    def __call__(self, src):
        alpha = random.uniform(-self.hue, self.hue)
        u = np.cos(alpha * np.pi)
        w = np.sin(alpha * np.pi)
        bt = np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]])
        t = np.dot(np.dot(self.ityiq, bt), self.tyiq).T
        return nd_array(np.dot(_np(src).astype(np.float32), t))


class RandomGrayAug(Augmenter):
    """With probability ``p``, three channels of luminance."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p
        self.mat = np.array([[0.21, 0.21, 0.21],
                             [0.72, 0.72, 0.72],
                             [0.07, 0.07, 0.07]], np.float32)

    def __call__(self, src):
        if random.random() < self.p:
            return nd_array(np.dot(_np(src).astype(np.float32), self.mat))
        return src


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = mean
        self.std = std

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + random.uniform(-self.brightness, self.brightness)
        return nd_array(_np(src).astype(np.float32) * alpha)


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast
        self.coef = np.array([[[0.299, 0.587, 0.114]]])

    def __call__(self, src):
        alpha = 1.0 + random.uniform(-self.contrast, self.contrast)
        arr = _np(src).astype(np.float32)
        gray = (arr * self.coef).sum() * (3.0 / arr.size)
        return nd_array(arr * alpha + gray * (1.0 - alpha))


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation
        self.coef = np.array([[[0.299, 0.587, 0.114]]])

    def __call__(self, src):
        alpha = 1.0 + random.uniform(-self.saturation, self.saturation)
        arr = _np(src).astype(np.float32)
        gray = (arr * self.coef).sum(axis=2, keepdims=True)
        return nd_array(arr * alpha + gray * (1.0 - alpha))


class LightingAug(Augmenter):
    """AlexNet's PCA colour noise, drawn from ``np.random``."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval)
        self.eigvec = np.asarray(eigvec)

    def __call__(self, src):
        alpha = np.random.normal(0, self.alphastd, size=(3,))
        rgb = np.dot(self.eigvec * alpha, self.eigval)
        return nd_array(_np(src).astype(np.float32) + rgb)


class ColorJitterAug(Augmenter):
    """Brightness, contrast and saturation jitters in a random order."""

    def __init__(self, brightness, contrast, saturation):
        super().__init__(brightness=brightness, contrast=contrast,
                         saturation=saturation)
        self.augs = []
        if brightness > 0:
            self.augs.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            self.augs.append(ContrastJitterAug(contrast))
        if saturation > 0:
            self.augs.append(SaturationJitterAug(saturation))

    def __call__(self, src):
        random.shuffle(self.augs)
        for aug in self.augs:
            src = aug(src)
        return src


class RandomOrderAug(Augmenter):
    """Apply ``ts`` in a random order (a private permutation: ``ts`` is
    shared by ``ImageIter``'s decode threads)."""

    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for t in random.sample(self.ts, len(self.ts)):
            src = t(src)
        return src


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, pca_noise=0, inter_method=2):
    """The standard augmenter list (parity: image.CreateAugmenter)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        auglist.append(RandomSizedCropAug(crop_size, 0.08,
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None and len(np.atleast_1d(mean)):
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


_AUG_KWARGS = ("resize", "rand_crop", "rand_resize", "rand_mirror", "mean",
               "std", "brightness", "contrast", "saturation", "pca_noise")


class ImageIter(DataIter):
    """Image iterator over RecordIO or an image list (parity:
    mxnet_tpu/image/image.py:478, the reference's image.ImageIter).

    ``preprocess_threads`` > 1 (default ``MXNET_CPU_WORKER_NTHREADS``)
    decodes and augments a batch's samples in a thread pool; the random
    augmenters' draws then interleave across threads. A partial final
    batch is zero-padded and counted in ``pad``."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, data_name="data", label_name="softmax_label",
                 preprocess_threads=None, **kwargs):
        super().__init__(batch_size)
        if preprocess_threads is None:
            from ..base import get_env
            preprocess_threads = get_env("MXNET_CPU_WORKER_NTHREADS", 0, int)
        self._pool = None
        if int(preprocess_threads) > 1:
            import concurrent.futures
            self._pool = concurrent.futures.ThreadPoolExecutor(
                int(preprocess_threads))
        if len(data_shape) != 3 or data_shape[0] not in (1, 3):
            raise MXNetError("data_shape must be (C, H, W)")
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.imgrec = None
        self.imglist = {}
        self.seq = []
        if path_imgrec:
            from .. import recordio
            idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
            if os.path.exists(idx_path):
                self.imgrec = recordio.MXIndexedRecordIO(idx_path,
                                                         path_imgrec, "r")
                self.seq = list(self.imgrec.keys)
            else:
                self.imgrec = recordio.MXRecordIO(path_imgrec, "r")
                self._records = []
                while True:
                    s = self.imgrec.read()
                    if s is None:
                        break
                    self._records.append(s)
                self.seq = list(range(len(self._records)))
        elif path_imglist or imglist is not None:
            if path_imglist:
                with open(path_imglist) as f:
                    for line in f:
                        parts = line.strip().split("\t")
                        label = np.array([float(x) for x in parts[1:-1]],
                                         np.float32)
                        self.imglist[int(parts[0])] = (label, parts[-1])
            else:
                for i, item in enumerate(imglist):
                    self.imglist[i] = (
                        np.array(item[0], np.float32).reshape(-1), item[1])
            self.seq = list(self.imglist.keys())
        else:
            raise MXNetError("need path_imgrec, path_imglist, or imglist")
        self.path_root = path_root
        self.shuffle = shuffle
        if num_parts > 1:
            self.seq = self.seq[part_index::num_parts]
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape, **{k: v for k, v in kwargs.items()
                                           if k in _AUG_KWARGS})
        self.cur = 0
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [DataDesc("softmax_label", shape)]

    def reset(self):
        if self.shuffle:
            random.shuffle(self.seq)
        self.cur = 0

    def next_sample(self):
        """``(label, payload bytes)`` of the next sample."""
        if self.cur >= len(self.seq):
            raise StopIteration
        idx = self.seq[self.cur]
        self.cur += 1
        if self.imgrec is not None:
            from .. import recordio
            s = self.imgrec.read_idx(idx) if hasattr(self.imgrec, "read_idx") \
                and getattr(self.imgrec, "idx", None) else self._records[idx]
            header, img = recordio.unpack(s)
            return header.label, img
        label, fname = self.imglist[idx]
        with open(os.path.join(self.path_root, fname), "rb") as f:
            img = f.read()
        return label, img

    def _raw_or_decoded(self, s):
        """A raw HWC payload of exactly C*H*W bytes as is, else decoded."""
        c, h, w = self.data_shape
        raw = np.frombuffer(s, np.uint8)
        if raw.size == c * h * w:
            return nd_array(raw.reshape(h, w, c))
        return imdecode(s)

    def next(self):
        # the iterator's own temp_space slot: a shared round-robin slot
        # could go to another consumer while a batch is assembled
        if getattr(self, "_batch_space", None) is None:
            from ..resource import Resource
            self._batch_space = Resource("temp_space", cpu())
        data_shape = (self.batch_size,) + self.data_shape
        batch_data = self._batch_space.get_space(data_shape, np.float32)
        lshape = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        batch_label = np.zeros(lshape, np.float32)
        c, h, w = self.data_shape

        def _decode_into(i, label, s):
            img = self._raw_or_decoded(s)
            for aug in self.auglist:
                img = aug(img)
            arr = img.asnumpy()
            if arr.shape[:2] != (h, w):
                arr = imresize(nd_array(arr.astype(np.uint8)), w, h).asnumpy()
            batch_data[i] = arr.transpose(2, 0, 1)
            batch_label[i] = label

        samples = []
        for _ in range(self.batch_size):
            try:
                samples.append(self.next_sample())
            except StopIteration:
                break
        if not samples:
            raise StopIteration
        pad = self.batch_size - len(samples)
        if pad:     # the reused buffer's tail rows hold the last batch's
            batch_data[len(samples):] = 0.0
        if self._pool is not None:
            list(self._pool.map(
                lambda args: _decode_into(args[0], *args[1]),
                enumerate(samples)))
        else:
            for i, (label, s) in enumerate(samples):
                _decode_into(i, label, s)
        return DataBatch([nd_array(batch_data)], [nd_array(batch_label)],
                         pad=pad)
