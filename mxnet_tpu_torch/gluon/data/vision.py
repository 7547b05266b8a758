"""Vision datasets (parity: python/mxnet/gluon/data/vision.py).

Counterpart of ``mxnet_tpu/gluon/data/vision.py``: ``MNIST``,
``FashionMNIST``, ``CIFAR10`` and ``CIFAR100`` read the standard local
files (MNIST idx, plain or gzipped; the CIFAR binary batches) under
``root`` instead of downloading them. An item is ``(image, label)``:
the image a host NDArray (H, W, C) of uint8, the label an int32.
``ImageRecordDataset`` (an indexed RecordIO file) and
``ImageFolderDataset`` (one folder per class) decode their images with
``image.imdecode``.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ...base import MXNetError
from ...context import cpu
from ...ndarray import array as _nd_array
from .dataset import Dataset, RecordFileDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


def nd_array(a):
    return _nd_array(a, ctx=cpu())


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(nd_array(self._data[idx]),
                                   self._label[idx])
        return nd_array(self._data[idx]), self._label[idx]

    def raw_item(self, idx):
        # transforms take NDArrays, which the worker processes do not
        # build: those datasets fall back to threads
        if self._transform is not None:
            return None
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from local idx files (parity: vision.MNIST)."""

    _train_files = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
    _test_files = ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)

    def _read(self, img_path, lbl_path):
        def _open(p):
            if os.path.exists(p):
                return open(p, "rb")
            if os.path.exists(p + ".gz"):
                return gzip.open(p + ".gz", "rb")
            raise MXNetError("dataset file %r not found (the files are "
                             "read locally, never downloaded)" % p)
        with _open(lbl_path) as f:
            struct.unpack(">II", f.read(8))
            label = np.frombuffer(f.read(), dtype=np.uint8).astype(np.int32)
        with _open(img_path) as f:
            _, num, rows, cols = struct.unpack(">IIII", f.read(16))
            data = np.frombuffer(f.read(), dtype=np.uint8)
            data = data.reshape(num, rows, cols, 1)
        return data, label

    def _get_data(self):
        files = self._train_files if self._train else self._test_files
        img = os.path.join(self._root, files[0])
        lbl = os.path.join(self._root, files[1])
        self._data, self._label = self._read(img, lbl)


class FashionMNIST(MNIST):
    """(parity: vision.FashionMNIST — same idx format)"""

    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 from the local binary batches (parity: vision.CIFAR10)."""

    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True,
                 transform=None):
        super().__init__(root, train, transform)

    def _get_data(self):
        if self._train:
            files = ["data_batch_%d.bin" % i for i in range(1, 6)]
        else:
            files = ["test_batch.bin"]
        data_list, label_list = [], []
        for fname in files:
            path = os.path.join(self._root, fname)
            if not os.path.exists(path):
                raise MXNetError("dataset file %r not found (the files "
                                 "are read locally, never downloaded)"
                                 % path)
            with open(path, "rb") as f:
                raw = np.frombuffer(f.read(), dtype=np.uint8)
            raw = raw.reshape(-1, 3073)
            label_list.append(raw[:, 0].astype(np.int32))
            data_list.append(
                raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        self._data = np.concatenate(data_list)
        self._label = np.concatenate(label_list)


class CIFAR100(_DownloadedDataset):
    def __init__(self, root="~/.mxnet/datasets/cifar100", train=True,
                 fine_label=True, transform=None):
        self._fine = fine_label
        super().__init__(root, train, transform)

    def _get_data(self):
        fname = "train.bin" if self._train else "test.bin"
        path = os.path.join(self._root, fname)
        if not os.path.exists(path):
            raise MXNetError("dataset file %r not found" % path)
        with open(path, "rb") as f:
            raw = np.frombuffer(f.read(), dtype=np.uint8)
        raw = raw.reshape(-1, 3074)
        self._label = raw[:, 1 if self._fine else 0].astype(np.int32)
        self._data = raw[:, 2:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)


class ImageRecordDataset(RecordFileDataset):
    """Images packed in an indexed RecordIO file (parity:
    vision.ImageRecordDataset): an item is ``(image, label)``, the image
    decoded by ``image.imdecode`` (host HWC uint8), the label the
    record header's."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from ... import recordio
        from ...image import image as img_mod
        header, payload = recordio.unpack(super().__getitem__(idx))
        image = img_mod.imdecode(payload, flag=self._flag)
        if self._transform is not None:
            return self._transform(image, header.label)
        return image, header.label

    def raw_item(self, idx):
        return None     # items are NDArrays: the DataLoader uses threads


class ImageFolderDataset(Dataset):
    """Images in one folder per class, ``root/<class>/<image>`` with a
    .jpg, .jpeg or .png suffix (parity: vision.ImageFolderDataset): the
    classes in sorted order are ``synsets``, an item is ``(image,
    label)``."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                if os.path.splitext(filename)[1].lower() in self._exts:
                    self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        from ...image import image as img_mod
        img = img_mod.imread(self.items[idx][0], flag=self._flag)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
