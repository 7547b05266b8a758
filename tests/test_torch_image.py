"""``mx.image`` (decode, the augmenters, ``ImageIter``, ``ImageDetIter``),
``mx.resource`` and the Gluon record and folder datasets of the PyTorch
port against the JAX package (the counterparts of ``tests/test_image.py``
and the resource cases of ``tests/test_storage.py``).

Both packages decode with the same PIL, so decoded, resized, cropped and
flipped pixels are equal; every random augmenter draws from Python's
``random`` (``LightingAug`` from ``np.random``) in the same order, so the
tests seed both before each package and compare: integer-valued images
exactly, jittered float values within 1e-6 of the largest. ``ImageIter``
and ``ImageDetIter`` give the JAX package's batches under the same seeds
(raw HWC payloads, encoded ones, shuffles, padding, labels); an earlier
batch stays as it was after the next ``next()`` although the iterator
reuses one ``temp_space`` buffer. Images are host NDArrays.
"""
import io as _io
import os
import random
import sys

import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401

PIL = pytest.importorskip("PIL.Image")
CPU = mt.cpu()
PKGS = (mx, mt)


def _jpeg_bytes(h=32, w=48, fmt="JPEG"):
    # a smooth gradient: JPEG keeps it close (random noise it would not)
    yy, xx = np.mgrid[0:h, 0:w]
    arr = np.stack([255.0 * yy / h, 255.0 * xx / w,
                    np.full((h, w), 128.0)], axis=2).astype(np.uint8)
    buf = _io.BytesIO()
    PIL.fromarray(arr).save(buf, format=fmt, quality=95)
    return buf.getvalue(), arr


def _noise_png(h, w, seed):
    arr = np.random.RandomState(seed).randint(0, 255, (h, w, 3), np.uint8)
    buf = _io.BytesIO()
    PIL.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue(), arr


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _arr(pkg, x):
    """A host NDArray in either package."""
    return pkg.nd.array(x, ctx=pkg.cpu())


def _want_dumps(jaug):
    """What upstream's ``dumps`` gives for the JAX augmenter ``jaug``:
    array keywords as lists. The JAX package's own ``dumps`` raises
    ``TypeError`` on them (a fault of the reference, ROADMAP Queue 3);
    where it does not, the two are the same string."""
    import json
    kw = {k: v.tolist() if isinstance(v, np.ndarray) else v
          for k, v in jaug._kwargs.items()}
    return json.dumps([jaug.__class__.__name__.lower(), kw])


def _check_dumps(taug, jaug):
    assert taug.dumps() == _want_dumps(jaug)
    try:
        assert jaug.dumps() == taug.dumps()
    except TypeError:
        assert any(isinstance(v, np.ndarray) for v in jaug._kwargs.values())


def _seeded(pkg, fn, seed=7):
    random.seed(seed)
    np.random.seed(seed)
    return fn(pkg)


def _both(fn, seed=7):
    return [_seeded(pkg, fn, seed) for pkg in PKGS]


def _close(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * max(np.abs(want).max(), 1))


# -- tests/test_image.py, each against the JAX package ---------------------

def test_imdecode_matches_jax_and_is_a_host_array():
    data, arr = _jpeg_bytes()
    outs = [pkg.image.imdecode(data) for pkg in PKGS]
    _close(outs[1], outs[0])
    assert outs[1].shape == (32, 48, 3) and outs[1].context == CPU
    assert np.abs(outs[1].asnumpy().astype(np.float32) - arr).mean() < 3
    for kw in (dict(flag=0), dict(to_rgb=False)):
        _close(mt.image.imdecode(data, **kw), mx.image.imdecode(data, **kw))
    _close(mt.nd.imdecode(data), mx.nd.imdecode(data))
    _close(mt.nd.imdecode(data, channels=1), mx.nd.imdecode(data, channels=1))


def test_imread_imresize_resize_short_and_scale_down(tmp_path):
    data, _ = _jpeg_bytes()
    path = tmp_path / "a.jpg"
    path.write_bytes(data)
    imgs = [pkg.image.imread(str(path)) for pkg in PKGS]
    _close(imgs[1], imgs[0])
    for interp in (0, 1, 2):
        _close(mt.image.imresize(imgs[1], 16, 8, interp),
               mx.image.imresize(imgs[0], 16, 8, interp))
    _close(mt.image.resize_short(imgs[1], 24),
           mx.image.resize_short(imgs[0], 24))
    tall = mt.nd.array(np.zeros((40, 20, 3), np.uint8), ctx=CPU)
    assert min(mt.image.resize_short(tall, 10).shape[:2]) == 10
    gray = mt.image.imdecode(data, flag=0)
    assert mt.image.imresize(gray, 5, 7).shape == (7, 5, 1)
    for args in (((100, 50), (60, 40)), ((30, 50), (60, 40)),
                 ((100, 20), (60, 40))):
        assert mt.image.scale_down(*args) == mx.image.scale_down(*args)


def test_crops_match_jax():
    data, _ = _jpeg_bytes()
    jimg, timg = (pkg.image.imdecode(data) for pkg in PKGS)
    _close(mt.image.fixed_crop(timg, 4, 4, 20, 16),
           mx.image.fixed_crop(jimg, 4, 4, 20, 16))
    _close(mt.image.fixed_crop(timg, 4, 4, 20, 16, size=(10, 8)),
           mx.image.fixed_crop(jimg, 4, 4, 20, 16, size=(10, 8)))
    for name, args in (("center_crop", ((20, 16),)),
                       ("random_crop", ((20, 16),)),
                       ("random_crop", ((60, 16),)),
                       ("random_size_crop", ((20, 16), 0.3, (0.75, 1.33))),
                       ("random_size_crop", ((20, 16), (0.99, 1.0),
                                             (9.0, 10.0)))):
        (jout, jbox), (tout, tbox) = _both(
            lambda pkg: getattr(pkg.image, name)(
                jimg if pkg is mx else timg, *args))
        _close(tout, jout)
        assert tuple(tbox) == tuple(jbox)


def test_color_normalize_matches_jax():
    src = np.random.RandomState(0).uniform(0, 255, (4, 5, 3))
    for mean, std in (([128.0, 100.0, 90.0], [2.0, 3.0, 4.0]),
                      (np.array([1.0, 2.0, 3.0]), None)):
        outs = [pkg.image.color_normalize(_arr(pkg, src), _arr(pkg, mean),
                                          None if std is None
                                          else _arr(pkg, std))
                for pkg in PKGS]
        _close(outs[1], outs[0])
    ones = mt.nd.ones((4, 4, 3), ctx=CPU) * 128.0
    out = mt.image.color_normalize(ones, mt.nd.array([128.0] * 3, ctx=CPU),
                                   mt.nd.array([2.0] * 3, ctx=CPU))
    np.testing.assert_allclose(out.asnumpy(), np.zeros((4, 4, 3)), atol=1e-5)


def test_create_augmenter_lists_match_jax():
    data, _ = _jpeg_bytes(64, 64)
    for kw in (dict(resize=26, rand_crop=True, rand_mirror=True, mean=True,
                    std=True),
               dict(rand_resize=True, brightness=0.3, contrast=0.3,
                    saturation=0.3, pca_noise=0.1, mean=np.array([1., 2, 3]))):
        def run(pkg):
            augs = pkg.image.CreateAugmenter(data_shape=(3, 24, 24), **kw)
            img = pkg.image.imdecode(data).astype("float32")
            for aug in augs:
                img = aug(img)
            return augs, img
        (jaugs, jimg), (taugs, timg) = _both(run)
        assert len(taugs) == len(jaugs)
        for t, j in zip(taugs, jaugs):
            _check_dumps(t, j)
        _close(timg, jimg)
        assert timg.shape[:2] == (24, 24)


@pytest.mark.parametrize("threads", [0, 3])
def test_imageiter_over_records_matches_jax(tmp_path, threads):
    """test_image.py's ``ImageIter`` over an indexed .rec of JPEGs (and
    its threaded case: equal to the serial batches for deterministic
    augmenters), against the JAX package."""
    rec_path = str(tmp_path / "data.rec")
    record = mt.recordio.MXIndexedRecordIO(str(tmp_path / "data.idx"),
                                           rec_path, "w")
    for i in range(8):
        data, _ = _noise_png(40, 40, i) if threads else _jpeg_bytes(40, 40)
        record.write_idx(i, mt.recordio.pack(
            mt.recordio.IRHeader(0, float(i % 2), i, 0), data))
    record.close()

    def epoch(pkg, n):
        it = pkg.image.ImageIter(batch_size=4, data_shape=(3, 24, 24),
                                 path_imgrec=rec_path,
                                 preprocess_threads=n)
        return [(b.data[0].asnumpy().copy(), b.label[0].asnumpy().copy(),
                 b.pad) for b in it]
    want, got = (epoch(pkg, threads) for pkg in PKGS)
    assert len(got) == len(want) == 2
    for (d0, l0, p0), (d1, l1, p1) in zip(want, got):
        np.testing.assert_array_equal(d1, d0)
        np.testing.assert_array_equal(l1, l0)
        assert p0 == p1
    if threads:
        for (d0, l0, _), (d1, l1, _) in zip(epoch(mt, 0), got):
            np.testing.assert_array_equal(d1, d0)
            np.testing.assert_array_equal(l1, l0)


def test_copy_make_border_matches_jax():
    a = np.arange(12, dtype=np.uint8).reshape(2, 2, 3)
    cases = [((1, 1, 2, 2), dict(type=0, value=7)),
             ((1, 0, 0, 0), dict(type=1)),
             ((1, 1, 1, 1), dict(type=2)), ((1, 1, 1, 1), dict(type=3)),
             ((1, 1, 1, 1), dict(type=4)),
             ((1, 0, 0, 0), dict(type=0, values=[1, 2, 3]))]
    for pads, kw in cases:
        outs = [pkg.image.copyMakeBorder(_arr(pkg, a), *pads, **kw)
                for pkg in PKGS]
        _close(outs[1], outs[0])
    img = mt.nd.array(a, ctx=CPU)
    got = mt.image.copyMakeBorder(img, 1, 1, 2, 2, type=0, value=7).asnumpy()
    np.testing.assert_array_equal(got[0], np.full((6, 3), 7, np.uint8))
    np.testing.assert_array_equal(got[1:3, 2:4], a)
    with pytest.raises(mt.MXNetError):
        mt.image.copyMakeBorder(img, 1, 1, 1, 1, out=mt.nd.zeros(
            (2, 2, 3), ctx=CPU, dtype="uint8"))
    with pytest.raises(mt.MXNetError):
        mt.image.copyMakeBorder(img, 1, 1, 1, 1, type=9)
    with pytest.raises(mt.MXNetError):
        mt.image.copyMakeBorder(mt.nd.array(a[..., 0], ctx=CPU), 1, 1, 1, 1,
                                values=[1, 2])
    ok = mt.nd.zeros((4, 4, 3), ctx=CPU, dtype="uint8")
    assert mt.image.copyMakeBorder(img, 1, 1, 1, 1, out=ok) is ok
    assert ok.asnumpy()[1, 1, 0] == 0


# -- every augmenter under the same seeds ------------------------------------

_EIG = (np.array([55.46, 4.794, 1.148]),
        np.array([[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
                  [-0.5836, -0.6948, 0.4203]]))


def _augmenters(pkg):
    im = pkg.image
    return [
        im.ResizeAug(20), im.ResizeAug(20, interp=0),
        im.RandomCropAug((16, 12)), im.RandomSizedCropAug((16, 16), 0.2,
                                                          (0.5, 2.0)),
        im.CenterCropAug((16, 12)), im.HorizontalFlipAug(0.5),
        im.CastAug(), im.ForceResizeAug((17, 11)),
        im.HueJitterAug(0.4), im.RandomGrayAug(0.5),
        im.ColorNormalizeAug(np.array([10.0, 20.0, 30.0]),
                             np.array([2.0, 3.0, 4.0])),
        im.BrightnessJitterAug(0.3), im.ContrastJitterAug(0.3),
        im.SaturationJitterAug(0.3), im.LightingAug(0.1, *_EIG),
        im.ColorJitterAug(0.2, 0.2, 0.2),
        im.RandomOrderAug([im.BrightnessJitterAug(0.2),
                           im.HorizontalFlipAug(0.5)]),
        im.SequentialAug([im.CenterCropAug((20, 20)), im.CastAug()]),
    ]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_every_augmenter_matches_jax_under_the_same_seed(seed):
    data, _ = _noise_png(24, 30, seed)

    def run(pkg):
        img = pkg.image.imdecode(data)
        augs = _augmenters(pkg)
        return augs, [_np(aug(img)) for aug in augs]
    (jaugs, want), (taugs, got) = _both(run, seed)
    assert len(got) == len(want) == 18
    for t, j, to, jo in zip(taugs, jaugs, got, want):
        _check_dumps(t, j)
        _close(to, jo)


def test_augmenter_surface():
    with pytest.raises(NotImplementedError):
        mt.image.Augmenter()(None)
    assert mt.image.CastAug("float16").dumps() == \
        mx.image.CastAug("float16").dumps()
    img = mt.nd.array(np.zeros((4, 4, 3), np.uint8), ctx=CPU)
    assert mt.image.CastAug("float16")(img).dtype == np.float16


# -- ImageIter -----------------------------------------------------------

def _raw_hwc_rec(path, n, shape=(10, 12, 3), indexed=False, seed=0):
    rs = np.random.RandomState(seed)
    imgs = [rs.randint(0, 256, shape).astype(np.uint8) for _ in range(n)]
    r = mt.recordio
    w = r.MXIndexedRecordIO(path[:-4] + ".idx", path, "w") if indexed \
        else r.MXRecordIO(path, "w")
    for i, a in enumerate(imgs):
        s = r.pack(r.IRHeader(0, float(i), i, 0), a.tobytes())
        if indexed:
            w.write_idx(i, s)
        else:
            w.write(s)
    w.close()
    return imgs


def _iter_epochs(pkg, make, epochs=2):
    it = make(pkg)
    out = []
    for e in range(epochs):
        if e:
            it.reset()
        out.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                    for b in it])
    return out


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, (list, tuple)):
            _same(x, y)
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("indexed", [False, True])
def test_imageiter_raw_hwc_shuffle_and_pad_match_jax(tmp_path, indexed):
    """Raw HWC payloads (C*H*W bytes), Python's ``random.shuffle`` at
    every reset, a zero-padded last batch, mirrors and crops."""
    path = str(tmp_path / "raw.rec")
    imgs = _raw_hwc_rec(path, 7, indexed=indexed)

    def make(pkg):
        return pkg.image.ImageIter(batch_size=3, data_shape=(3, 10, 12),
                                   path_imgrec=path, shuffle=True,
                                   rand_mirror=True, rand_crop=True)
    want, got = _both(lambda pkg: _iter_epochs(pkg, make))
    _same(got, want)
    assert [p for _, _, p in got[0]] == [0, 0, 2]
    np.testing.assert_array_equal(got[0][2][0][1:], 0.0)

    def plain(pkg):
        return pkg.image.ImageIter(batch_size=7, data_shape=(3, 10, 12),
                                   path_imgrec=path)
    first = _iter_epochs(mt, plain, 1)[0][0]
    np.testing.assert_array_equal(first[0], np.stack(imgs).transpose(
        0, 3, 1, 2).astype(np.float32))
    np.testing.assert_array_equal(first[1], np.arange(7))


def test_imageiter_reuses_its_buffer_but_batches_stay(tmp_path):
    """Batches are assembled in one ``temp_space`` buffer: the buffer is
    the same across ``next()`` calls and an earlier batch keeps its
    values (each batch's NDArray is a copy)."""
    path = str(tmp_path / "raw.rec")
    _raw_hwc_rec(path, 6)
    it = mt.image.ImageIter(batch_size=3, data_shape=(3, 10, 12),
                            path_imgrec=path)
    b0 = it.next()
    kept = b0.data[0].asnumpy().copy()
    buf = it._batch_space._buf
    b1 = it.next()
    assert it._batch_space._buf is buf
    np.testing.assert_array_equal(b0.data[0].asnumpy(), kept)
    assert not np.array_equal(b1.data[0].asnumpy(), kept)
    assert b0.data[0].context == CPU
    with pytest.raises(StopIteration):
        it.next()


def test_imageiter_from_image_lists_matches_jax(tmp_path):
    """``path_imglist`` (index, labels, file per line) and ``imglist``,
    ``path_root``, multi-label rows, ``num_parts``, resizing to the data
    shape, greyscale."""
    root = tmp_path / "imgs"
    root.mkdir()
    lines = []
    for i in range(5):
        data, _ = _noise_png(14 + i, 16, i)
        (root / ("%d.png" % i)).write_bytes(data)
        lines.append("%d\t%d\t%d\t%d.png" % (i, i, 2 * i, i))
    lst = tmp_path / "list.lst"
    lst.write_text("\n".join(lines) + "\n")
    imglist = [[float(i), "%d.png" % i] for i in range(5)]
    cases = [
        lambda pkg: pkg.image.ImageIter(
            batch_size=2, data_shape=(3, 12, 12), label_width=2,
            path_imglist=str(lst), path_root=str(root), rand_crop=True),
        lambda pkg: pkg.image.ImageIter(
            batch_size=2, data_shape=(3, 16, 20), imglist=imglist,
            path_root=str(root), shuffle=True, num_parts=2, part_index=1,
            aug_list=[pkg.image.ForceResizeAug((8, 8))]),
        lambda pkg: pkg.image.ImageIter(
            batch_size=3, data_shape=(1, 12, 12), imglist=imglist,
            path_root=str(root), aug_list=[]),
    ]
    for make in cases:
        if make is cases[2]:
            for pkg in PKGS:    # flag-0 decode of a colour image: 3 != 1
                with pytest.raises(Exception):
                    _iter_epochs(pkg, make, 1)
            continue
        want, got = _both(lambda pkg: _iter_epochs(pkg, make))
        _same(got, want)
    it = cases[0](mt)
    assert it.provide_label[0].shape == (2, 2)
    assert it.provide_data[0].shape == (2, 3, 12, 12)
    for bad in (dict(data_shape=(2, 8, 8), imglist=imglist),
                dict(data_shape=(3, 8, 8))):
        with pytest.raises(mt.MXNetError):
            mt.image.ImageIter(batch_size=2, **bad)


# -- detection -------------------------------------------------------------

def _det_rec(path, n=6, hw=(20, 24), seed=0, encoded=False):
    """Raw HWC (or PNG) images with 1-3 boxes each as multi-label
    headers."""
    rs = np.random.RandomState(seed)
    r = mt.recordio
    w = r.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    for i in range(n):
        img = rs.randint(0, 256, hw + (3,)).astype(np.uint8)
        rows = []
        for _ in range(rs.randint(1, 4)):
            x0, y0 = rs.uniform(0, 0.6, 2)
            rows.append([rs.randint(0, 5), x0, y0, x0 + 0.3, y0 + 0.35])
        if encoded:
            buf = _io.BytesIO()
            PIL.fromarray(img).save(buf, format="PNG")
            payload = buf.getvalue()
        else:
            payload = img.tobytes()
        w.write_idx(i, r.pack(r.IRHeader(0, np.array(rows, np.float32)
                                         .ravel(), i, 0), payload))
    w.close()


def _det_augs(pkg):
    d, im = pkg.image.detection, pkg.image
    return [d.DetRandomCropAug(), d.DetHorizontalFlipAug(0.5),
            d.DetBorrowAug(im.BrightnessJitterAug(0.2)),
            d.DetBorrowAug(im.CastAug()),
            d.DetBorrowAug(im.ColorNormalizeAug([1.0, 2.0, 3.0],
                                                [4.0, 5.0, 6.0]))]


@pytest.mark.parametrize("encoded", [False, True])
def test_image_det_iter_matches_jax(tmp_path, encoded):
    """``(B, C, H, W)`` data and ``(B, max_boxes, 5)`` labels padded with
    ``label_pad``; random crops drop boxes (class -1) and flips mirror
    them; the resize back to the data shape; a shuffled second epoch."""
    path = str(tmp_path / "det.rec")
    _det_rec(path, encoded=encoded)
    for augs in (_det_augs, None):
        def make(pkg):
            return pkg.image.detection.ImageDetIter(
                batch_size=3, data_shape=(3, 20, 24), max_boxes=4,
                label_pad=-2, path_imgrec=path, shuffle=True,
                aug_list=None if augs is None else augs(pkg))
        want, got = _both(lambda pkg: _iter_epochs(pkg, make))
        _same(got, want)
        assert got[0][0][1].shape == (3, 4, 5)
        assert (got[0][0][1] == -2).any()
    it = make(mt)
    assert it.provide_label[0].name == "label"
    assert it.provide_label[0].shape == (3, 4, 5)
    assert mt.image.ImageDetIter is mt.image.detection.ImageDetIter


def test_det_augmenters_match_jax():
    rs = np.random.RandomState(0)
    img = rs.randint(0, 256, (30, 40, 3)).astype(np.uint8)
    label = np.array([[1, 0.1, 0.1, 0.4, 0.5], [2, 0.5, 0.4, 0.9, 0.9],
                      [-1, 0, 0, 0, 0]], np.float32)
    for seed in range(4):
        def run(pkg):
            d = pkg.image.detection
            augs = d.CreateDetAugmenter((3, 20, 20), resize=25, rand_crop=1,
                                        rand_mirror=True)
            augs += [d.DetBorrowAug(pkg.image.ColorNormalizeAug(
                [123.68, 116.28, 103.53], [58.395, 57.12, 57.375]))]
            augs += [d.DetRandomCropAug(area_range=(0.9, 1.0),
                                        max_attempts=3)]
            src, lab = _arr(pkg, img), label
            out = []
            for aug in augs:
                src, lab = aug(src, lab)
                out.append((_np(src), lab))
            return out
        want, got = _both(run, seed)
        for (ji, jl), (ti, tl) in zip(want, got):
            _close(ti, ji)
            np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-6)
    with pytest.raises(NotImplementedError):
        mt.image.detection.DetAugmenter()(None, None)
    crop = mt.image.detection.DetRandomCropAug()
    assert crop._update_labels(label, (0.95, 0.95, 1.0, 1.0)) is None


def test_array_keywords_serialise_as_lists_as_upstream():
    """Upstream's ``Augmenter``/``DetAugmenter`` keep array keywords as
    lists, so ``dumps()`` works and ``DetBorrowAug`` (which serialises
    its augmenter) takes a colour normalise with array means: the port
    does; the JAX package raises ``TypeError`` (ROADMAP Queue 3)."""
    aug = mt.image.ColorNormalizeAug(np.array([1.0, 2.0]),
                                     mt.nd.array([3.0, 4.0], ctx=CPU))
    assert aug.dumps() == '["colornormalizeaug", {"mean": [1.0, 2.0], ' \
        '"std": [3.0, 4.0]}]'
    with pytest.raises(TypeError):
        mx.image.ColorNormalizeAug(np.array([1.0, 2.0]), None).dumps()
    d = mt.image.detection
    augs = d.CreateDetAugmenter((3, 8, 8), mean=True, std=True)
    assert '"mean": [123.68, 116.28, 103.53]' in augs[-1]._kwargs["augmenter"]
    with pytest.raises(TypeError):
        mx.image.detection.CreateDetAugmenter((3, 8, 8), mean=True, std=True)
    img = mt.nd.array(np.full((8, 8, 3), 200, np.uint8), ctx=CPU)
    out, _ = augs[-1](img, np.zeros((0, 5), np.float32))
    np.testing.assert_allclose(out.asnumpy()[0, 0],
                               (200 - np.array([123.68, 116.28, 103.53]))
                               / np.array([58.395, 57.12, 57.375]),
                               rtol=1e-6)
    assert d.DetHorizontalFlipAug(np.float64(0.5))._kwargs == {"p": 0.5}


# -- Gluon datasets ----------------------------------------------------------

def test_image_record_dataset_through_the_dataloader(tmp_path):
    path = str(tmp_path / "ds.rec")
    w = mt.recordio.MXIndexedRecordIO(str(tmp_path / "ds.idx"), path, "w")
    for i in range(6):
        data, _ = _noise_png(8, 10, i)
        w.write_idx(i, mt.recordio.pack(
            mt.recordio.IRHeader(0, float(i), i, 0), data))
    w.close()
    dsets = [pkg.gluon.data.vision.ImageRecordDataset(path) for pkg in PKGS]
    assert len(dsets[1]) == len(dsets[0]) == 6
    for i in range(6):
        (jimg, jlab), (timg, tlab) = dsets[0][i], dsets[1][i]
        _close(timg, jimg)
        assert tlab == jlab
    raw = mt.gluon.data.RecordFileDataset(path)
    assert bytes(raw[2]) == bytes(mx.gluon.data.RecordFileDataset(path)[2])
    assert raw.raw_item(2) == raw[2] and len(raw) == 6

    def trans(img, label):
        return img.astype("float32") / 255.0, label
    for workers in (0, 2):
        loaders = [pkg.gluon.data.DataLoader(
            pkg.gluon.data.vision.ImageRecordDataset(path, transform=trans),
            batch_size=4, num_workers=workers) for pkg in PKGS]
        want, got = ([[_np(x) for x in b] for b in ld] for ld in loaders)
        _same(got, want)
    gray = mt.gluon.data.vision.ImageRecordDataset(path, flag=0)
    assert gray[0][0].shape == (8, 10, 1)


def test_image_folder_dataset_through_the_dataloader(tmp_path):
    for ci, cls in enumerate(("cat", "dog")):
        (tmp_path / cls).mkdir()
        for i in range(3):
            data, _ = _noise_png(8, 8, 10 * ci + i)
            (tmp_path / cls / ("%d.png" % i)).write_bytes(data)
    (tmp_path / "dog" / "notes.txt").write_text("not an image")
    (tmp_path / "readme.txt").write_text("not a class")
    dsets = [pkg.gluon.data.vision.ImageFolderDataset(str(tmp_path))
             for pkg in PKGS]
    assert dsets[1].synsets == dsets[0].synsets == ["cat", "dog"]
    assert [os.path.relpath(p, str(tmp_path)) for p, _ in dsets[1].items] \
        == [os.path.relpath(p, str(tmp_path)) for p, _ in dsets[0].items]
    loaders = [pkg.gluon.data.DataLoader(ds, batch_size=4) for pkg, ds in
               zip(PKGS, dsets)]
    want, got = ([[_np(x) for x in b] for b in ld] for ld in loaders)
    _same(got, want)
    tds = mt.gluon.data.vision.ImageFolderDataset(
        str(tmp_path), flag=0, transform=lambda img, lab: (img, lab + 10))
    img, lab = tds[4]
    assert img.shape == (8, 8, 1) and lab == 11


# -- resource and Pillow -----------------------------------------------------

def test_resource_temp_space_and_random_generator():
    r1 = mt.resource.request(CPU, "temp_space")
    a = r1.get_space((8, 8))
    a[:] = 1.0
    r2 = mt.resource.request(CPU, "temp_space")
    b = r2.get_space((8, 8))
    assert a.ctypes.data == b.ctypes.data and (b == 1.0).all()
    grown = r2.get_space((64, 64), np.float64)
    assert grown.shape == (64, 64) and grown.dtype == np.float64
    assert (a == 1.0).all()             # the outgrown buffer is kept
    with pytest.raises(mt.MXNetError):
        r1.get_generator()
    gen = mt.resource.request(CPU, "random").get_generator()
    assert gen is mt.random.generator(CPU.torch_device())
    with pytest.raises(mt.MXNetError):
        mt.resource.Resource("random", CPU).get_space((2,))
    with pytest.raises(mt.MXNetError):
        mt.resource.request(CPU, "scratch")
    r1.release()
    assert r1._buf is None


def test_missing_pillow_raises_naming_it(monkeypatch):
    data, _ = _jpeg_bytes()
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(mt.MXNetError, match="Pillow"):
        mt.image.imdecode(data)
    with pytest.raises(mt.MXNetError, match="Pillow"):
        mt.image.imresize(mt.nd.zeros((4, 4, 3), ctx=CPU), 2, 2)
