"""Data iterators.

Counterpart of ``mxnet_tpu/io.py`` (``DataDesc``, ``DataBatch``,
``DataIter``, ``NDArrayIter``): the same batch order from the same numpy
seed (``shuffle`` draws one permutation with ``np.random.shuffle`` at
construction and at every ``reset``) and the same ``last_batch_handle``
semantics. Batches are host arrays (``cpu()`` NDArrays), as in the
reference; a Module copies each into its bound storage on its device.
``ResizeIter`` (a fixed number of batches per epoch), ``PrefetchingIter``
(one background thread ahead of its iterator), ``MNISTIter`` (MNIST
idx files, plain or gzipped) and ``CSVIter`` are ported too;
``LibSVMIter`` (CSR batches) and ``ImageRecordIter`` are not yet
(ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

import gzip
import os
import queue as _queue
import struct
import threading
import time
from collections import namedtuple

import numpy as np

from .base import MXNetError
from .context import cpu
from .ndarray.ndarray import NDArray, array as _nd_array
from . import telemetry
from . import faults

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "MNISTIter", "CSVIter"]


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


def _poison_batch(batch):
    """The ``io_next`` site's ``nan`` payload transform: corrupt the
    batch's DATA arrays (NDArray or numpy) via ``faults.poison``,
    leaving labels intact — a poisoned label would fail loudly in the
    loss layer instead of exercising the numeric-divergence path."""
    data = batch.data
    single = not isinstance(data, (list, tuple))
    items = [data] if single else list(data)
    for i, arr in enumerate(items):
        if isinstance(arr, NDArray):
            arr[:] = faults.poison([arr.asnumpy()])[0]
        elif isinstance(arr, np.ndarray):
            items[i] = faults.poison([arr])[0]
    batch.data = items[0] if single else items


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
        # the io phase of the merged host+device trace: time spent
        # PRODUCING batches. Only the epoch-end StopIteration cancels
        # the sample; the ``io_next`` fault site fires per batch
        with telemetry.span("io_next") as sp:
            try:
                batch = self.next()
            except StopIteration:
                sp.cancel()
                raise
            if faults.active() and faults.fire("io_next") == "nan":
                _poison_batch(batch)
            return batch

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


class ResizeIter(DataIter):
    """``size`` batches per epoch of another iterator, which restarts when
    it runs out (parity: io.ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """One background thread runs ``prefetch_depth`` batches ahead of a
    single backing iterator (parity: io.PrefetchingIter). ``reset`` stops
    the thread before it resets the backing iterator, and raises if the
    thread stays inside the backing ``next()`` longer than
    ``reset_join_timeout`` seconds."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth=2):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        super().__init__(iters[0].batch_size)
        if len(iters) != 1:
            raise MXNetError("PrefetchingIter takes a single backing "
                             "iterator, as in the JAX package")
        self.iter = iters[0]
        self._prefetch_depth = prefetch_depth
        self.reset_join_timeout = 5.0
        self._queue = _queue.Queue(maxsize=prefetch_depth)
        self._stop = threading.Event()
        self._thread = None
        self._start()

    @property
    def provide_data(self):
        return self.iter.provide_data

    @property
    def provide_label(self):
        return self.iter.provide_label

    def _start(self):
        # the worker holds its own stop event and queue, so a reset that
        # swaps them in never races a worker that is still draining
        stop, queue, backing = self._stop, self._queue, self.iter

        def worker():
            while not stop.is_set():
                try:
                    batch = backing.next()
                except StopIteration:
                    queue.put(None)
                    return
                queue.put(batch)
        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def reset(self):
        self._stop.set()
        deadline = time.monotonic() + self.reset_join_timeout
        while self._thread is not None and self._thread.is_alive():
            try:
                while True:     # unblock a worker waiting on a full queue
                    self._queue.get_nowait()
            except _queue.Empty:
                pass
            self._thread.join(timeout=0.05)
            if time.monotonic() > deadline and self._thread.is_alive():
                raise MXNetError(
                    "PrefetchingIter.reset(): the prefetch thread did not "
                    "exit within %.1fs; it is blocked inside the backing "
                    "iterator's next(). Call reset() again once the source "
                    "unblocks." % self.reset_join_timeout)
        self.iter.reset()
        self._stop = threading.Event()
        self._queue = _queue.Queue(maxsize=self._prefetch_depth)
        self._start()

    def next(self):
        batch = self._queue.get()
        if batch is None:
            raise StopIteration
        return batch

    def iter_next(self):
        raise NotImplementedError


def _idx_open(path):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def _read_idx_images(path):
    with _idx_open(path) as f:
        magic, num, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise MXNetError("bad MNIST image file %r" % path)
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(num, rows,
                                                               cols)


def _read_idx_labels(path):
    with _idx_open(path) as f:
        magic, _ = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise MXNetError("bad MNIST label file %r" % path)
        return np.frombuffer(f.read(), dtype=np.uint8)


class MNISTIter(NDArrayIter):
    """MNIST idx files, plain or gzipped, as float32 images in [0, 1]
    (N, 1, 28, 28), or (N, 784) with ``flat`` (parity:
    src/io/iter_mnist.cc as the JAX package reads it). ``shuffle`` draws
    from numpy's global state; ``seed`` is accepted and unused there
    too."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, silent=False, seed=0,
                 input_shape=None, **kwargs):
        for p in (image, label):
            if not os.path.exists(p) and not os.path.exists(p + ".gz"):
                raise MXNetError("MNIST file %r not found" % p)
        image = image if os.path.exists(image) else image + ".gz"
        label = label if os.path.exists(label) else label + ".gz"
        imgs = _read_idx_images(image).astype(np.float32) / 255.0
        lbls = _read_idx_labels(label).astype(np.float32)
        if flat:
            imgs = imgs.reshape(len(imgs), -1)
        else:
            imgs = imgs.reshape(len(imgs), 1, imgs.shape[1], imgs.shape[2])
        super().__init__(imgs, lbls, batch_size=int(batch_size),
                         shuffle=bool(shuffle),
                         num_parts=int(kwargs.get("num_parts", 1)),
                         part_index=int(kwargs.get("part_index", 0)))


class CSVIter(NDArrayIter):
    """Rows of a CSV file as float32 samples of ``data_shape``, with
    labels from ``label_csv`` (a (1,) label flattens to a vector); a
    short last batch pads with ``round_batch``, else it is dropped
    (parity: mxnet_tpu/io.py:446-462, src/io/iter_csv.cc)."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=1, round_batch=True,
                 **kwargs):
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32)
            label = label.reshape((-1,) + tuple(label_shape))
            if label.shape[1:] == (1,):
                label = label[:, 0]
        super().__init__(data, label, batch_size=int(batch_size),
                         last_batch_handle="pad" if round_batch
                         else "discard",
                         num_parts=int(kwargs.get("num_parts", 1)),
                         part_index=int(kwargs.get("part_index", 0)))
