"""``gluon.data`` and the file iterators of the PyTorch port against the
JAX package's (the counterparts of ``tests/test_gluon.py:131-300`` and
the iterator cases of ``tests/test_io.py``).

Datasets, samplers and the DataLoader give the same batches in the same
order as the JAX package's for one ``np.random`` seed (exact:
the batches are the dataset's own rows); ``last_batch`` keep, discard
and rollover; a custom sampler and ``batch_sampler``; thread workers
and process workers (spawned, numpy and shared memory only) equal to
``num_workers=0``; the thread fallback's warning; no shared-memory
segment left after an early ``break``. The vision datasets read MNIST
idx and CIFAR binary files the tests write; ``MNISTIter``,
``ResizeIter`` and ``PrefetchingIter`` give the JAX package's batches.
"""
import glob
import gzip
import os
import struct
import time
import warnings

import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401

CPU = mt.cpu()
gd = {mx: mx.gluon.data, mt: mt.gluon.data}


def _np(b):
    if isinstance(b, (list, tuple)):
        return [_np(x) for x in b]
    return b.asnumpy() if hasattr(b, "asnumpy") else np.asarray(b)


def _epoch(loader):
    return [_np(b) for b in loader]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, list):
            _same(x, y)
        else:
            np.testing.assert_array_equal(x, y)


def _pair(n=10, d=2):
    x = np.arange(n * d, dtype=np.float32).reshape(n, d)
    y = np.arange(n, dtype=np.float32)
    return x, y


def _datasets(x, y):
    return {mx: mx.gluon.data.ArrayDataset(mx.nd.array(x), mx.nd.array(y)),
            mt: mt.gluon.data.ArrayDataset(x, mt.nd.array(y, ctx=CPU))}


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_dataloader_order_and_last_batch_match_jax(shuffle, last_batch):
    x, y = _pair(10)
    ds = _datasets(x, y)
    got = {}
    for pkg in (mx, mt):
        loader = gd[pkg].DataLoader(ds[pkg], batch_size=4, shuffle=shuffle,
                                    last_batch=last_batch)
        np.random.seed(7)
        got[pkg] = [_epoch(loader), _epoch(loader), len(loader)]
    _same(got[mt][0], got[mx][0])
    _same(got[mt][1], got[mx][1])
    assert got[mt][2] == got[mx][2]
    sizes = [b[0].shape[0] for b in got[mt][0]]
    assert sizes == {"keep": [4, 4, 2], "discard": [4, 4],
                     "rollover": [4, 4]}[last_batch]
    if last_batch == "rollover":
        assert [b[0].shape[0] for b in got[mt][1]] == [4, 4, 4]
    assert all(isinstance(b[0], mt.nd.NDArray) and
               b[0].context == CPU for b in mt.gluon.data.DataLoader(
                   ds[mt], batch_size=4))


def test_samplers_match_jax():
    for pkg in (mx, mt):
        assert list(gd[pkg].SequentialSampler(5)) == [0, 1, 2, 3, 4]
    res = {}
    for pkg in (mx, mt):
        np.random.seed(3)
        rnd = [int(i) for i in gd[pkg].RandomSampler(9)]
        bs = gd[pkg].BatchSampler(gd[pkg].SequentialSampler(7), 3,
                                  "rollover")
        res[pkg] = (rnd, list(bs), list(bs), len(bs),
                    list(gd[pkg].BatchSampler(
                        gd[pkg].SequentialSampler(7), 3, "keep")),
                    len(gd[pkg].BatchSampler(
                        gd[pkg].SequentialSampler(7), 3, "discard")))
    assert res[mt] == res[mx]
    with pytest.raises(ValueError):
        list(mt.gluon.data.BatchSampler(mt.gluon.data.SequentialSampler(5),
                                        2, "bogus"))


def test_custom_sampler_and_batch_sampler():
    x, _ = _pair(8, 1)
    order = [7, 6, 5, 4, 3, 2, 1, 0]

    got = {}
    for pkg in (mx, mt):
        class Rev(gd[pkg].Sampler):
            def __iter__(self):
                return iter(order)

            def __len__(self):
                return 8
        ds = gd[pkg].ArrayDataset(x)
        loader = gd[pkg].DataLoader(ds, batch_size=4, sampler=Rev())
        got[pkg] = np.concatenate(_epoch(loader))
        with pytest.raises(Exception):
            gd[pkg].DataLoader(ds, batch_size=4, sampler=Rev(), shuffle=True)
    np.testing.assert_array_equal(got[mt], got[mx])
    np.testing.assert_array_equal(got[mt][:, 0], order)
    bs = mt.gluon.data.BatchSampler(mt.gluon.data.SequentialSampler(8), 3,
                                    "keep")
    loader = mt.gluon.data.DataLoader(mt.gluon.data.ArrayDataset(x),
                                      batch_sampler=bs)
    assert [b.shape[0] for b in loader] == [3, 3, 2]
    with pytest.raises(mt.MXNetError, match="exclusive"):
        mt.gluon.data.DataLoader(mt.gluon.data.ArrayDataset(x),
                                 batch_size=4, batch_sampler=bs)


def test_dataset_transforms_match_jax():
    x, y = _pair(6)
    out = {}
    for pkg in (mx, mt):
        ds = _datasets(x, y)[pkg]
        t = ds.transform(lambda a, b: (a * 2, b + 1))
        tf = ds.transform_first(lambda a: a - 1, lazy=False)
        simple = gd[pkg].SimpleDataset([np.float32(i) for i in range(4)])
        out[pkg] = (_np(list(t[2])), _np(list(tf[3])), len(tf),
                    [float(simple[i]) for i in range(4)])
    _same(out[mt][0], out[mx][0])
    _same(out[mt][1], out[mx][1])
    assert out[mt][2:] == out[mx][2:]
    # a missing record file (RecordFileDataset is ported: no stub error)
    for pkg in (mx, mt):
        with pytest.raises(FileNotFoundError):
            gd[pkg].RecordFileDataset("no-such-dir/x.rec")


@pytest.mark.parametrize("thread_pool", [True, False],
                         ids=["threads", "processes"])
def test_workers_give_the_single_process_batches(thread_pool):
    """num_workers=2 gives num_workers=0's batches, in order, shuffled
    under one seed, epoch after epoch (a fresh pool per epoch)."""
    x = np.random.RandomState(0).randn(26, 3, 4).astype(np.float32)
    y = np.arange(26, dtype=np.float32)
    ds = mt.gluon.data.ArrayDataset(x, y)
    runs = []
    for workers in (0, 2):
        loader = mt.gluon.data.DataLoader(ds, batch_size=5, shuffle=True,
                                          num_workers=workers,
                                          thread_pool=thread_pool)
        np.random.seed(11)
        runs.append([_epoch(loader), _epoch(loader)])
    _same(runs[1][0], runs[0][0])
    _same(runs[1][1], runs[0][1])
    assert len(runs[0][0]) == 6


def test_process_workers_fall_back_to_threads_with_a_warning():
    ds = mt.gluon.data.ArrayDataset(np.arange(10, dtype=np.float32)) \
        .transform(lambda v: v)
    loader = mt.gluon.data.DataLoader(ds, batch_size=2, num_workers=2,
                                      thread_pool=False)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        batches = list(loader)
    assert len(batches) == 5
    assert any("falling back to threads" in str(r.message) for r in rec)


def test_process_workers_leave_no_shared_memory_after_break():
    x = np.arange(80, dtype=np.float32).reshape(40, 2)
    loader = mt.gluon.data.DataLoader(mt.gluon.data.ArrayDataset(x),
                                      batch_size=4, num_workers=2,
                                      thread_pool=False)
    before = set(glob.glob("/dev/shm/*"))
    it = iter(loader)
    first = next(it)
    np.testing.assert_array_equal(first.asnumpy(), x[:4])
    it.close()
    leaked = set()
    for _ in range(20):
        leaked = set(glob.glob("/dev/shm/*")) - before
        if not leaked:
            break
        time.sleep(0.25)
    assert not leaked, leaked


def test_pin_memory_needs_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(mt.MXNetError, match="CUDA"):
        mt.gluon.data.DataLoader(mt.gluon.data.ArrayDataset(np.zeros(4)),
                                 batch_size=2, pin_memory=True)


# ---------------------------------------------------------------------------
# vision datasets and the file iterators, on files the tests write
# ---------------------------------------------------------------------------

def _write_mnist(root, n=23, gz=False, seed=0):
    rs = np.random.RandomState(seed)
    imgs = rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    lbls = rs.randint(0, 10, n).astype(np.uint8)
    os.makedirs(root, exist_ok=True)
    opener = gzip.open if gz else open
    sfx = ".gz" if gz else ""
    for prefix in ("train", "t10k"):
        with opener(os.path.join(root, "%s-images-idx3-ubyte%s"
                                 % (prefix, sfx)), "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
        with opener(os.path.join(root, "%s-labels-idx1-ubyte%s"
                                 % (prefix, sfx)), "wb") as f:
            f.write(struct.pack(">II", 2049, n) + lbls.tobytes())
    return imgs, lbls


def _write_cifar(root, n=7, seed=0, hundred=False):
    rs = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    width = 3074 if hundred else 3073
    names = ["train.bin", "test.bin"] if hundred else \
        ["data_batch_%d.bin" % i for i in range(1, 6)] + ["test_batch.bin"]
    for name in names:
        raw = rs.randint(0, 256, (n, width)).astype(np.uint8)
        raw[:, :2 if hundred else 1] %= 10
        raw.tofile(os.path.join(root, name))


@pytest.mark.parametrize("gz", [False, True])
def test_vision_datasets_match_jax(tmp_path, gz):
    mroot = str(tmp_path / "mnist")
    imgs, lbls = _write_mnist(mroot, gz=gz)
    _write_cifar(str(tmp_path / "c10"))
    _write_cifar(str(tmp_path / "c100"), hundred=True)
    for train in (True, False):
        sets = {}
        for pkg in (mx, mt):
            v = gd[pkg].vision
            sets[pkg] = [v.MNIST(root=mroot, train=train),
                         v.FashionMNIST(root=mroot, train=train),
                         v.CIFAR10(root=str(tmp_path / "c10"), train=train),
                         v.CIFAR100(root=str(tmp_path / "c100"),
                                    train=train),
                         v.CIFAR100(root=str(tmp_path / "c100"),
                                    train=train, fine_label=False)]
        for a, b in zip(sets[mt], sets[mx]):
            assert len(a) == len(b)
            for i in (0, len(b) - 1):
                (ia, la), (ib, lb) = a[i], b[i]
                np.testing.assert_array_equal(ia.asnumpy(), ib.asnumpy())
                assert ia.context == CPU and int(la) == int(lb)
    mn = mt.gluon.data.vision.MNIST(root=mroot)
    np.testing.assert_array_equal(mn[5][0].asnumpy()[:, :, 0], imgs[5])
    assert mn[5][1] == lbls[5]
    # a transform builds NDArrays: no host item for worker processes
    t = mt.gluon.data.vision.MNIST(root=mroot, transform=lambda d, l: (d, l))
    assert t.raw_item(0) is None and mn.raw_item(0) is not None
    with pytest.raises(mt.MXNetError, match="not found"):
        mt.gluon.data.vision.MNIST(root=str(tmp_path / "none"))
    # the image datasets are ported (tests/test_torch_image.py): a folder
    # of data files holds classes and no images; a directory is no
    # record file
    folders = [gd[pkg].vision.ImageFolderDataset(str(tmp_path))
               for pkg in (mx, mt)]
    assert folders[1].synsets == folders[0].synsets == ["c10", "c100",
                                                         "mnist"]
    assert len(folders[1]) == len(folders[0]) == 0
    for pkg in (mx, mt):
        with pytest.raises(IsADirectoryError):
            gd[pkg].vision.ImageRecordDataset(str(tmp_path / "c10"))


def test_mnist_iter_matches_jax(tmp_path):
    root = str(tmp_path)
    _write_mnist(root, n=23, gz=True)
    got = {}
    for pkg in (mx, mt):
        kw = dict(image=os.path.join(root, "train-images-idx3-ubyte"),
                  label=os.path.join(root, "train-labels-idx1-ubyte"),
                  batch_size=5)
        np.random.seed(4)
        it = pkg.io.MNISTIter(shuffle=True, **kw)
        flat = pkg.io.MNISTIter(shuffle=False, flat=True, **kw)
        got[pkg] = ([(_np(b.data), _np(b.label), b.pad) for b in it],
                    [_np(b.data) for b in flat], it.provide_data,
                    flat.provide_data)
    for (a, b) in zip(got[mt][0], got[mx][0]):
        _same(a[:2], b[:2])
        assert a[2] == b[2]
    _same(got[mt][1], got[mx][1])
    assert [tuple(d.shape) for d in got[mt][2]] == [(5, 1, 28, 28)]
    assert [tuple(d.shape) for d in got[mt][3]] == [(5, 784)]
    with pytest.raises(mt.MXNetError, match="not found"):
        mt.io.MNISTIter(image=os.path.join(root, "nope"))


def test_resize_and_prefetching_iters_match_jax():
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    y = np.arange(20, dtype=np.float32)
    got = {}
    for pkg in (mx, mt):
        base = pkg.io.NDArrayIter(x, y, batch_size=6)
        r = pkg.io.ResizeIter(base, 7)
        first = [(_np(b.data), b.pad) for b in r]
        r.reset()
        again = [_np(b.data) for b in r]
        p = pkg.io.PrefetchingIter(pkg.io.NDArrayIter(x, y, batch_size=6),
                                   prefetch_depth=1)
        pre = [_np(b.data) for b in p]
        p.reset()
        pre2 = [_np(b.data) for b in p]
        got[pkg] = (first, again, pre, pre2, r.provide_data,
                    p.provide_label)
    assert len(got[mt][0]) == 7
    for a, b in zip(got[mt][0], got[mx][0]):
        _same(a[0], b[0])
        assert a[1] == b[1]
    for i in (1, 2, 3):
        _same(got[mt][i], got[mx][i])
    assert [d.shape for d in got[mt][4]] == [d.shape for d in got[mx][4]]
    assert [d.shape for d in got[mt][5]] == [d.shape for d in got[mx][5]]
    with pytest.raises(mt.MXNetError, match="single"):
        mt.io.PrefetchingIter([mt.io.NDArrayIter(x), mt.io.NDArrayIter(x)])
