"""Data iterators.

Counterpart of ``mxnet_tpu/io.py`` (``DataDesc``, ``DataBatch``,
``DataIter``, ``NDArrayIter``): the same batch order from the same numpy
seed (``shuffle`` draws one permutation with ``np.random.shuffle`` at
construction and at every ``reset``) and the same ``last_batch_handle``
semantics. Batches are host arrays (``cpu()`` NDArrays), as in the
reference; a Module copies each into its bound storage on its device.
``ResizeIter`` (a fixed number of batches per epoch), ``PrefetchingIter``
(one background thread ahead of its iterator), ``MNISTIter`` (MNIST
idx files, plain or gzipped), ``CSVIter``, ``LibSVMIter`` (csr
batches on the iterator's context, default ``gpu(0)``),
``ImageRecordIter`` (RecordIO images through the native loader or PIL)
and ``MXDataIter`` are ported too.
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
import torch

from .base import MXNetError, registry_create
from .context import cpu, current_context
from .ndarray.ndarray import NDArray, array as _nd_array
from . import telemetry
from . import faults

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "MNISTIter", "CSVIter", "LibSVMIter",
           "ImageRecordIter", "MXDataIter"]


register, _, create_iterator, _ = registry_create("data iterator")


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


@register(name="MNISTIter")
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


@register(name="CSVIter")
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


def _parse_libsvm(path, feature_dim):
    """``(labels, indptr, indices, values)`` of a LibSVM file as the JAX
    package reads it through a dense float32 matrix: a repeated feature
    keeps its last value, a value that is zero in float32 is not stored,
    a row's features come sorted, a negative index counts from the end."""
    labels, indptr, indices, values = [], [0], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            labels.append(float(parts[0]))
            row = {}
            for kv in parts[1:]:
                k, v = kv.split(":")
                k = int(k)
                if k < -feature_dim or k >= feature_dim:
                    raise MXNetError("LibSVMIter: feature %d outside "
                                     "data_shape (%d,)" % (k, feature_dim))
                row[k % feature_dim] = np.float32(v)
            cols = sorted(c for c, v in row.items() if v != 0)
            indices.extend(cols)
            values.extend(row[c] for c in cols)
            indptr.append(len(indices))
    return (np.asarray(labels, np.float32), np.asarray(indptr, np.int64),
            np.asarray(indices, np.int32), np.asarray(values, np.float32))


def _csr_rows(indptr, indices, values, rows):
    """The csr triple of the listed rows, in order."""
    lengths = indptr[rows + 1] - indptr[rows]
    out_ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    take = np.repeat(indptr[rows] - out_ptr[:-1], lengths) \
        + np.arange(out_ptr[-1], dtype=np.int64)
    return out_ptr, indices[take], values[take]


@register(name="LibSVMIter")
class LibSVMIter(DataIter):
    """LibSVM reader yielding csr data batches (parity:
    mxnet_tpu/io.py:465-530, src/io/iter_libsvm.cc): ``num_parts`` and
    ``part_index`` give each worker every ``num_parts``-th row from
    ``part_index`` on; a short last batch pads with rows from the start
    of this part (``getpad`` counts them). The JAX iterator builds a
    dense (rows, feature_dim) array first; this one keeps the parsed
    rows compressed and slices them per batch, with the same batches.
    Batches live on ``ctx`` (default the current context, ``gpu(0)``)."""

    def __init__(self, data_libsvm, data_shape, label_shape=(1,),
                 batch_size=1, num_parts=1, part_index=0, ctx=None,
                 **kwargs):
        super().__init__(int(batch_size))
        self._ctx = ctx or current_context()
        self._dev = self._ctx.torch_device()
        self.feature_dim = int(data_shape[0] if isinstance(
            data_shape, (tuple, list)) else data_shape)
        labels, indptr, indices, values = _parse_libsvm(data_libsvm,
                                                        self.feature_dim)
        rows = np.arange(int(part_index), len(labels), int(num_parts))
        self._labels = labels[rows]
        self._indptr, self._indices, self._values = _csr_rows(
            indptr, indices, values, rows)
        self.num_data = len(rows)
        self.cursor = -self.batch_size

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size, self.feature_dim))]

    @property
    def provide_label(self):
        return [DataDesc("softmax_label", (self.batch_size,))]

    def reset(self):
        self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _batch_rows(self):
        rows = np.arange(self.cursor, min(self.cursor + self.batch_size,
                                          self.num_data))
        pad = min(self.batch_size - len(rows), self.num_data)
        return np.concatenate([rows, np.arange(pad)])

    def getdata(self):
        from .ndarray import sparse as _sp
        rows = self._batch_rows()
        indptr, indices, values = _csr_rows(
            self._indptr, self._indices, self._values, rows)
        dev = self._dev

        def up(a):
            return torch.from_numpy(a).to(dev)
        return [_sp.CSRNDArray(up(values), up(indices),
                               up(indptr.astype(np.int32)),
                               (len(rows), self.feature_dim),
                               self._ctx)]

    def getlabel(self):
        return [_nd_array(self._labels[self._batch_rows()], ctx=self._ctx)]

    def getpad(self):
        return max(self.cursor + self.batch_size - self.num_data, 0)


@register(name="ImageRecordIter")
class ImageRecordIter(DataIter):
    """RecordIO image iterator (parity: mxnet_tpu/io.py:537-733,
    src/io/iter_image_recordio_2.cc).

    Raw payloads are uint8 **CHW** tensors; encoded payloads (JPEG, PNG,
    BMP, GIF: an image magic that PIL opens) decode through PIL, then a
    crop to ``data_shape`` (random with ``rand_crop``, centred otherwise).
    Every value is ``(x * scale - mean) / std`` in float32. Two paths give
    the batches:

    * the native threaded loader (``_native.py``) when no augmentation is
      asked for (no ``rand_crop``/``rand_mirror``), ``label_width`` is 1,
      ``num_parts`` is 1, no payload is encoded, ``round_batch`` has no
      partial tail to wrap, and the file is local. It shuffles with its
      own ``mt19937_64(seed)`` at construction and every ``reset``. If it
      cannot be built or loaded, the constructor raises;
    * otherwise the Python path: ``_decode`` per record, ``rand_mirror``
      from ``np.random``, ``shuffle`` by ``np.random.shuffle`` at
      ``reset`` only (the first epoch is unshuffled), the last partial
      batch wrapped to the epoch head and counted in ``pad`` under
      ``round_batch`` (dropped without it).

    Batches are host (``cpu()``) NDArrays, as ``NDArrayIter``'s are.
    """

    _IMG_MAGIC = (b"\xff\xd8", b"\x89PN", b"BM", b"GIF")

    def __init__(self, path_imgrec, data_shape, batch_size, label_width=1,
                 shuffle=False, rand_crop=False, rand_mirror=False,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0, std_r=1.0, std_g=1.0,
                 std_b=1.0, scale=1.0, preprocess_threads=4, seed=0,
                 num_parts=1, part_index=0, round_batch=True, **kwargs):
        super().__init__(int(batch_size))
        from . import recordio
        from .filesystem import scheme_of
        self.data_shape = tuple(int(x) for x in data_shape)
        self.label_width = int(label_width)
        self.shuffle = shuffle
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        c = int(data_shape[0])
        means = [mean_r, mean_g, mean_b][:c] if c <= 3 else [mean_r] * c
        stds = [std_r, std_g, std_b][:c] if c <= 3 else [std_r] * c
        self.mean = np.array(means, np.float32).reshape(c, 1, 1)
        self.std = np.array(stds, np.float32).reshape(c, 1, 1)
        self.scale = scale
        self.rec = recordio.MXRecordIO(path_imgrec, "r")
        self._records = []
        while True:
            s = self.rec.read()
            if s is None:
                break
            self._records.append(s)
        if num_parts > 1:   # dmlc InputSplit: every num_parts-th record
            self._records = self._records[part_index::num_parts]
        self._round_batch = bool(round_batch)
        self._native = None
        scheme = scheme_of(path_imgrec)
        if not rand_crop and not rand_mirror and self.label_width == 1 \
                and num_parts == 1 and scheme in ("", "file") \
                and not self._records_encoded() \
                and not (self._round_batch
                         and len(self._records) % self.batch_size != 0):
            from ._native import NativeRecordLoader
            path = os.fspath(path_imgrec)
            self._native = NativeRecordLoader(
                path[len("file://"):] if scheme == "file" else path,
                int(batch_size), self.data_shape,
                num_threads=int(preprocess_threads), shuffle=bool(shuffle),
                seed=int(seed), scale=scale, mean=(mean_r, mean_g, mean_b),
                std=(std_r, std_g, std_b))
        self._order = np.arange(len(self._records))
        self.cursor = -self.batch_size

    def _open_encoded(self, img):
        """A loaded PIL image if the payload is an encoded image, else
        None: it starts with an image magic AND PIL opens it (raw pixels
        that merely start with a magic stay raw)."""
        if not (img[:2] in self._IMG_MAGIC or img[:3] in self._IMG_MAGIC):
            return None
        import io as _pyio
        from .image.image import _pil
        try:
            pic = _pil().open(_pyio.BytesIO(img))
            pic.load()
            return pic
        except Exception:
            return None

    def _records_encoded(self):
        from . import recordio
        return any(
            self._open_encoded(recordio.unpack(r)[1]) is not None
            for r in self._records)

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 \
            else (self.batch_size, self.label_width)
        return [DataDesc("softmax_label", shape)]

    def reset(self):
        self.cursor = -self.batch_size
        if self._native is not None:
            self._native.reset()
        if self.shuffle:
            np.random.shuffle(self._order)

    def next(self):
        if self._native is not None:
            data, label = self._native.next()
            return DataBatch([_nd_array(data, ctx=cpu())],
                             [_nd_array(label, ctx=cpu())], pad=0)
        return super().next()

    def iter_next(self):
        self.cursor += self.batch_size
        if self._round_batch:
            return self.cursor < len(self._records)
        return self.cursor + self.batch_size <= len(self._records)

    def _batch_indices(self):
        idx = self._order[self.cursor:self.cursor + self.batch_size]
        while len(idx) < self.batch_size:    # wrap, repeatedly if the
            idx = np.concatenate(            # file holds < one batch
                [idx, self._order[:self.batch_size - len(idx)]])
        return idx

    def _decode(self, s):
        from . import recordio
        header, img = recordio.unpack(s)
        c, h, w = self.data_shape
        pic = self._open_encoded(img)
        if pic is not None:
            if c == 1:
                pic = pic.convert("L")
            elif c == 3:
                if pic.mode != "RGB":
                    pic = pic.convert("RGB")
            else:
                raise MXNetError(
                    "encoded-image decode supports 1 or 3 channels, "
                    "data_shape has %d" % c)
            if pic.width < w or pic.height < h:
                pic = pic.resize((max(w, pic.width), max(h, pic.height)))
            dx, dy = pic.width - w, pic.height - h
            if self.rand_crop:
                x0 = np.random.randint(0, dx + 1)
                y0 = np.random.randint(0, dy + 1)
            else:
                x0, y0 = dx // 2, dy // 2
            pic = pic.crop((x0, y0, x0 + w, y0 + h))
            arr = np.asarray(pic, dtype=np.float32)
            arr = arr[:, :, None] if arr.ndim == 2 else arr
            arr = arr.transpose(2, 0, 1)
        else:
            arr = np.frombuffer(img, dtype=np.uint8)
            if arr.size < c * h * w:
                raise MXNetError("record payload too small for raw decode "
                                 "and not an encoded image")
            arr = arr[:c * h * w].reshape(c, h, w).astype(np.float32)
        if self.rand_mirror and np.random.rand() < 0.5:
            arr = arr[:, :, ::-1]
        return (arr * self.scale - self.mean) / self.std, header.label

    def getdata(self):
        batch = np.stack([self._decode(self._records[i])[0]
                          for i in self._batch_indices()])
        return [_nd_array(batch, ctx=cpu())]

    def getlabel(self):
        from . import recordio
        # labels live in the record header: no image decode needed
        labels = np.array(
            [np.atleast_1d(recordio.unpack(self._records[i])[0].label)
             for i in self._batch_indices()], np.float32)
        if self.label_width == 1:
            labels = labels[:, 0]
        return [_nd_array(labels, ctx=cpu())]

    def getpad(self):
        remain = len(self._records) - self.cursor
        return max(0, self.batch_size - remain) if remain > 0 else 0


class MXDataIter(DataIter):
    """The reference's C-handle iterator face over a created iterator
    (parity: mxnet_tpu/io.py:735): every call goes to the wrapped
    ``DataIter``."""

    def __init__(self, handle, data_name="data", label_name="softmax_label",
                 **_):
        if not isinstance(handle, DataIter):
            raise MXNetError("MXDataIter wraps a created iterator; use "
                             "mx.io.<IterName>(...)")
        self._iter = handle
        super().__init__(self._iter.batch_size)

    def __getattr__(self, name):
        return getattr(self.__dict__["_iter"], name)

    def reset(self):
        self._iter.reset()

    def next(self):
        return self._iter.next()

    def iter_next(self):
        return self._iter.iter_next()

    def getdata(self):
        return self._iter.getdata()

    def getlabel(self):
        return self._iter.getlabel()

    def getindex(self):
        return self._iter.getindex()

    def getpad(self):
        return self._iter.getpad()
