"""Gluon datasets (parity: python/mxnet/gluon/data/dataset.py).

Counterpart of ``mxnet_tpu/gluon/data/dataset.py``: ``Dataset`` with
``transform``/``transform_first``, ``SimpleDataset`` and
``ArrayDataset``. ``raw_item`` gives an item as a host-only numpy tree
(or None when the dataset cannot), which is what the DataLoader's
worker processes batch. ``RecordFileDataset`` needs ``recordio`` and
raises until it is ported (ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

import numpy as np

from ...base import MXNetError
from ...ndarray.ndarray import NDArray

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    """(parity: data.Dataset)"""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def raw_item(self, idx):
        """The item as a host-only (numpy/bytes) tree, or None when this
        dataset cannot give one: only such items ride the DataLoader's
        worker processes, which never touch the card."""
        return None

    def _raw_view(self):
        """What the DataLoader sends its worker processes: an object
        whose ``raw_item`` gives this dataset's host items."""
        return self

    def transform(self, fn, lazy=True):
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        return self.transform(_TransformFirstClosure(fn), lazy)


def _is_host_tree(item):
    if isinstance(item, (tuple, list)):
        return all(_is_host_tree(x) for x in item)
    return isinstance(item, (np.ndarray, np.generic, bytes, bytearray,
                             int, float))


class SimpleDataset(Dataset):
    """A dataset over any indexable (parity: data.SimpleDataset)."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]

    def raw_item(self, idx):
        item = self._data[idx]
        return item if _is_host_tree(item) else None


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class ArrayDataset(Dataset):
    """Columns of equal length, item i the tuple of their rows i (parity:
    data.ArrayDataset)."""

    def __init__(self, *args):
        if not args:
            raise MXNetError("ArrayDataset needs at least one array")
        self._length = len(args[0])
        self._data = []
        for data in args:
            if len(data) != self._length:
                raise MXNetError("all arrays must be same length")
            self._data.append(data)
        self._raw_cols = None

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)

    def raw_item(self, idx):
        return self._raw_view().raw_item(idx)

    def _raw_view(self):
        return _RawColumns(self._raw_columns())

    def _raw_columns(self):
        """Host-only views of the columns, made once (the DataLoader
        probes ``raw_item(0)`` before it starts workers)."""
        if self._raw_cols is None:
            self._raw_cols = [np.asarray(d.asnumpy() if isinstance(d, NDArray)
                                         else d) for d in self._data]
        return self._raw_cols

    def __len__(self):
        return self._length


class _RawColumns:
    """The numpy columns of an ArrayDataset, without its NDArrays."""

    def __init__(self, cols):
        self._cols = cols

    def raw_item(self, idx):
        if len(self._cols) == 1:
            return self._cols[0][idx]
        return tuple(c[idx] for c in self._cols)


class RecordFileDataset(Dataset):
    """The records of an indexed RecordIO file, in its ``.idx`` order
    (parity: data.RecordFileDataset); an item is the record's bytes."""

    def __init__(self, filename):
        from ... import recordio
        idx_file = filename[:filename.rfind(".")] + ".idx"
        self._record = recordio.MXIndexedRecordIO(idx_file, filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    raw_item = __getitem__          # record bytes are host-only already

    def __len__(self):
        return len(self._record.keys)
