"""Data iterators.

Counterpart of ``mxnet_tpu/io.py`` (``DataDesc``, ``DataBatch``,
``DataIter``, ``NDArrayIter``): the same batch order from the same numpy
seed (``shuffle`` draws one permutation with ``np.random.shuffle`` at
construction and at every ``reset``) and the same ``last_batch_handle``
semantics. Batches are host arrays (``cpu()`` NDArrays), as in the
reference; a Module copies each into its bound storage on its device.
The other iterators (``ResizeIter``, ``PrefetchingIter``, ``MNISTIter``,
``CSVIter``, ``LibSVMIter``, ``ImageRecordIter``) are not ported yet.
"""
from __future__ import annotations

from collections import namedtuple

import numpy as np

from .base import MXNetError
from .context import cpu
from .ndarray.ndarray import NDArray, array as _nd_array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """(parity: io.DataDesc) name/shape/dtype/layout of one input."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, tuple(shape))
        ret.dtype = dtype
        ret.layout = layout
        return ret

    @staticmethod
    def get_batch_axis(layout):
        return 0 if layout is None else layout.find("N")


class DataBatch:
    """(parity: io.DataBatch)"""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Base iterator (parity: io.DataIter)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (parity: io.NDArrayIter).

    ``last_batch_handle='pad'`` (the default) fills a short final batch
    by wrapping from the epoch head and reports the wrapped count in
    ``DataBatch.pad``; ``'discard'`` drops the short tail. Every batch
    has ``batch_size`` rows."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", num_parts=1, part_index=0):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        if num_parts > 1:
            self.data = [(k, v[part_index::num_parts]) for k, v in self.data]
            self.label = [(k, v[part_index::num_parts])
                          for k, v in self.label]
        self.num_data = self.data[0][1].shape[0]
        self.cursor = -batch_size
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self._order = np.arange(self.num_data)
        if shuffle:
            np.random.shuffle(self._order)
        if last_batch_handle == "discard":
            self.num_batches = self.num_data // batch_size
        else:
            self.num_batches = (self.num_data + batch_size - 1) // batch_size

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        self.cursor = -self.batch_size
        if self.shuffle:
            np.random.shuffle(self._order)

    def iter_next(self):
        self.cursor += self.batch_size
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _slice(self, arrays):
        out = []
        for _, arr in arrays:
            idx = self._order[self.cursor:self.cursor + self.batch_size]
            part = arr[idx]
            if len(idx) < self.batch_size:
                extra = self._order[:self.batch_size - len(idx)]
                part = np.concatenate([part, arr[extra]], axis=0)
            out.append(_nd_array(part, ctx=cpu()))
        return out

    def getdata(self):
        return self._slice(self.data)

    def getlabel(self):
        return self._slice(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0

    def getindex(self):
        return self._order[self.cursor:self.cursor + self.batch_size]


def _init_data(data, allow_empty, default_name):
    """Normalise input to a list of (name, numpy array) (parity:
    io._init_data)."""
    if data is None:
        if not allow_empty:
            raise MXNetError("data cannot be None")
        return []
    if isinstance(data, (NDArray, np.ndarray)):
        data = [(default_name, data)]
    elif isinstance(data, (list, tuple)):
        data = [("%s_%d" % (default_name, i) if len(data) > 1
                 else default_name, d) for i, d in enumerate(data)]
    elif isinstance(data, dict):
        data = sorted(data.items())
    out = []
    for name, arr in data:
        if isinstance(arr, NDArray):
            arr = arr.asnumpy()
        out.append((name, np.asarray(arr)))
    return out
