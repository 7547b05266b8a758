"""RecordIO, the native record loader, ``ImageRecordIter``/``MXDataIter``,
``mx.filesystem`` and ``Module.fit`` from records: the PyTorch port
against the JAX package on the same numpy inputs (the counterparts of
``tests/test_io.py:122-441`` and ``tests/test_filesystem.py``).

Record files are byte-equal whichever package writes them (single and
multi-label headers, ``.idx`` sidecars) and each reads the other's. The
port's native loader (``kernels/csrc/recordio.cc``, built with the host
C++ compiler at first use), its Python path and the JAX package's Python
path give bit-equal batches on unshuffled records; encoded (JPEG/PNG)
records decode through PIL with the same crops and mirrors from one
``np.random`` seed. A loader that cannot be built raises; several
processes building at once all load a whole library. Records packed by
``src/im2rec.cc`` read in both packages, and ``NDArrayIter`` shards as
the JAX package's does (``tools/feed_probe.py``'s two probes of
``tests/test_io.py`` time the JAX package's decode and are not ported).
Two ``Module.fit``
batches of a narrow conv+BN net on 3x32x32 records: the loss within
1e-5 and each parameter within 1e-5 of its tensor's largest value.
"""
import io as _pyio
import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401
from mxnet_tpu_torch import _native
from mxnet_tpu_torch.kernels import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = mt.cpu()
PKGS = {"jax": mx, "port": mt}


def _write(pkg, path, payloads, labels, indexed=False):
    r = pkg.recordio
    w = r.MXIndexedRecordIO(path[:-4] + ".idx", path, "w") if indexed \
        else r.MXRecordIO(path, "w")
    for i, (p, lab) in enumerate(zip(payloads, labels)):
        s = r.pack(r.IRHeader(0, lab, i, 0), p)
        if indexed:
            w.write_idx(i, s)
        else:
            w.write(s)
    w.close()


def _read_all(pkg, path):
    rec = pkg.recordio.MXRecordIO(path, "r")
    out = []
    while True:
        s = rec.read()
        if s is None:
            return out
        out.append(bytes(s))


def _raw_images(n, shape=(3, 8, 8), seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, shape).astype(np.uint8) for _ in range(n)]


def _raw_rec(path, n=8, shape=(3, 8, 8), seed=0, classes=4):
    imgs = _raw_images(n, shape, seed)
    _write(mt, path, [a.tobytes() for a in imgs],
           [float(i % classes) for i in range(n)])
    return imgs


def _jpeg_rec(path, n=7, size=(12, 12), gray=False, fmt="JPEG", seed=1):
    from PIL import Image
    rs = np.random.RandomState(seed)
    blobs = []
    for _ in range(n):
        arr = rs.randint(0, 255, size + ((1,) if gray else (3,)),
                         dtype=np.uint8)
        buf = _pyio.BytesIO()
        Image.fromarray(arr[:, :, 0] if gray else arr).save(buf, format=fmt)
        blobs.append(buf.getvalue())
    _write(mt, path, blobs, [float(i) for i in range(n)])


def _epoch(it):
    return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]


def _same_epochs(a, b):
    assert len(a) == len(b)
    for (d0, l0, p0), (d1, l1, p1) in zip(a, b):
        np.testing.assert_array_equal(d0, d1)
        np.testing.assert_array_equal(l0, l1)
        assert p0 == p1


# -- the file format ------------------------------------------------------

@pytest.mark.parametrize("indexed", [False, True])
def test_record_files_byte_equal_both_ways(tmp_path, indexed):
    """Single and multi-label headers, odd payload lengths (padding), the
    ``.idx`` sidecar: the same bytes from either writer, and each package
    reads the other's records back, labels and payloads equal."""
    payloads = [b"x" * n for n in (0, 1, 5, 8, 13)]
    labels = [1.5, [1.0, 2.0, 3.0], 0.0, np.arange(5, dtype=np.float32),
              7.0]
    paths = {}
    for name, pkg in PKGS.items():
        paths[name] = str(tmp_path / ("%s.rec" % name))
        _write(pkg, paths[name], payloads, labels, indexed)
    assert open(paths["jax"], "rb").read() == open(paths["port"], "rb").read()
    if indexed:
        assert open(paths["jax"][:-4] + ".idx").read() == \
            open(paths["port"][:-4] + ".idx").read()
    for reader, writer in (("jax", "port"), ("port", "jax")):
        pkg = PKGS[reader]
        for s, p, lab in zip(_read_all(pkg, paths[writer]), payloads,
                             labels):
            h, payload = pkg.recordio.unpack(s)
            assert bytes(payload) == p
            np.testing.assert_array_equal(np.asarray(h.label, np.float32),
                                          np.asarray(lab, np.float32))
        if indexed:
            r = pkg.recordio.MXIndexedRecordIO(paths[writer][:-4] + ".idx",
                                               paths[writer], "r")
            assert r.keys == list(range(5))
            assert bytes(pkg.recordio.unpack(r.read_idx(3))[1]) == payloads[3]
            assert bytes(pkg.recordio.unpack(r.read_idx(1))[1]) == payloads[1]


def test_recordio_roundtrip_and_pack_unpack_match_jax(tmp_path):
    """test_io.py's roundtrip, indexed and pack/unpack cases in both
    packages; ``pack_img``/``unpack_img`` give the same bytes."""
    payloads = [b"hello", b"world!!", b"x" * 100]
    for name, pkg in PKGS.items():
        path = str(tmp_path / ("%s.rec" % name))
        w = pkg.recordio.MXRecordIO(path, "w")
        for p in payloads:
            w.write(p)
        w.close()
        assert _read_all(pkg, path) == payloads
        rec = pkg.recordio.MXRecordIO(path, "r")
        rec.read()
        pos = rec.tell()
        rec.reset()
        rec.seek(pos)
        assert bytes(rec.read()) == payloads[1]
    hdr = (0, 2.5, 7, 3)
    assert mt.recordio.pack(hdr, b"payload") == mx.recordio.pack(hdr,
                                                                 b"payload")
    h2, payload = mt.recordio.unpack(mx.recordio.pack(hdr, b"payload"))
    assert (h2.flag, h2.label, h2.id, h2.id2) == (0, 2.5, 7, 3)
    assert payload == b"payload"
    img = np.arange(24, dtype=np.uint8).reshape(2, 4, 3)
    s = mt.recordio.pack_img(mt.recordio.IRHeader(0, 1.0, 0, 0), img)
    assert s == mx.recordio.pack_img(mx.recordio.IRHeader(0, 1.0, 0, 0), img)
    for pkg in PKGS.values():
        h, flat = pkg.recordio.unpack_img(s)
        np.testing.assert_array_equal(flat, img.ravel())
    with pytest.raises(mt.MXNetError):
        mt.recordio.MXRecordIO(str(tmp_path / "x.rec"), "a")
    bad = tmp_path / "bad.rec"
    bad.write_bytes(b"\x00" * 12)
    with pytest.raises(mt.MXNetError, match="magic"):
        mt.recordio.MXRecordIO(str(bad), "r").read()


def test_recordio_pickles_and_reopens(tmp_path):
    import pickle
    path = str(tmp_path / "p.rec")
    _write(mt, path, [b"a", b"bb"], [0.0, 1.0], indexed=True)
    r = mt.recordio.MXIndexedRecordIO(path[:-4] + ".idx", path, "r")
    r2 = pickle.loads(pickle.dumps(r))
    assert mt.recordio.unpack(r2.read_idx(1))[1] == b"bb"


# -- mx.filesystem (tests/test_filesystem.py against the port) -------------

def test_file_uris_for_save_load_symbols_and_records(tmp_path):
    arrs = {"w": mt.nd.array(np.arange(6).reshape(2, 3), ctx=CPU)}
    uri = "file://" + str(tmp_path / "x.params")
    mt.nd.save(uri, arrs)
    np.testing.assert_array_equal(mt.nd.load(uri, ctx=CPU)["w"].asnumpy(),
                                  arrs["w"].asnumpy())
    np.testing.assert_array_equal(mx.nd.load(uri)["w"].asnumpy(),
                                  arrs["w"].asnumpy())
    net = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=3,
                                name="fc")
    suri = "file://" + str(tmp_path / "net.json")
    net.save(suri)
    assert mt.sym.load(suri).list_arguments() == net.list_arguments()
    assert mx.sym.load(suri).list_arguments() == net.list_arguments()
    ruri = "file://" + str(tmp_path / "t.rec")
    iuri = "file://" + str(tmp_path / "t.idx")
    w = mt.recordio.MXIndexedRecordIO(iuri, ruri, "w")
    w.write_idx(7, b"seven")
    w.write_idx(9, b"nine")
    w.close()
    r = mt.recordio.MXIndexedRecordIO(iuri, ruri, "r")
    assert r.read_idx(9) == b"nine" and r.read_idx(7) == b"seven"
    assert _read_all(mt, ruri) == _read_all(mx, ruri) == [b"seven", b"nine"]


def test_registered_scheme_roundtrip_and_unknown_scheme():
    blobs = {}

    class _MemFile(_pyio.BytesIO):
        def __init__(self, uri):
            super().__init__()
            self._uri = uri

        def close(self):
            blobs[self._uri] = self.getvalue()
            super().close()

    class _Stream(_pyio.BytesIO):
        def seekable(self):         # a remote stream: np.load may not seek
            return False

    def opener(uri, mode):
        if "w" in mode:
            return _MemFile(uri)
        if uri not in blobs:
            raise FileNotFoundError(uri)
        return _Stream(blobs[uri])

    mt.filesystem.register_scheme("MEM", opener)
    try:
        mt.nd.save("mem://bucket/a", [mt.nd.ones((2, 2), ctx=CPU)])
        back = mt.nd.load("mem://bucket/a", ctx=CPU)
        np.testing.assert_array_equal(back[0].asnumpy(), np.ones((2, 2)))
        with pytest.raises(mt.MXNetError, match="no such file"):
            mt.nd.load("mem://bucket/missing", ctx=CPU)
    finally:
        mt.filesystem._OPENERS.pop("mem", None)
    with pytest.raises(mt.MXNetError, match="register_scheme"):
        mt.filesystem.open_uri("s3://bucket/key", "rb")
    with pytest.raises(mt.MXNetError):
        mt.filesystem.register_scheme("s3://", opener)
    for uri in ("/a/b.params", "C://odd", "file:///x", "s3://b/k", 3):
        assert mt.filesystem.scheme_of(uri) == mx.filesystem.scheme_of(uri)


# -- ImageRecordIter: the native loader and the Python path ---------------

_NORM = dict(mean_r=10.0, mean_g=20.0, mean_b=30.0, std_r=2.0, std_g=3.0,
             std_b=4.0, scale=0.5)


def test_native_python_and_jax_paths_bit_equal(tmp_path):
    """Unshuffled raw CHW records, normalised: the port's native loader,
    the port's Python path and the JAX package's Python path (its native
    library is not built here) give the same bits, epoch after epoch."""
    path = str(tmp_path / "imgs.rec")
    imgs = _raw_rec(path, n=12)
    kw = dict(path_imgrec=path, data_shape=(3, 8, 8), batch_size=4, **_NORM)
    native = mt.io.ImageRecordIter(preprocess_threads=3, **kw)
    assert native._native is not None
    python = mt.io.ImageRecordIter(**kw)
    python._native = None
    jax_it = mx.io.ImageRecordIter(**kw)
    assert jax_it._native is None
    want = _epoch(jax_it)
    mean = np.array([10, 20, 30], np.float32).reshape(3, 1, 1)
    std = np.array([2, 3, 4], np.float32).reshape(3, 1, 1)
    ref = (np.stack(imgs[:4]).astype(np.float32) * np.float32(0.5)
           - mean) / std
    np.testing.assert_array_equal(want[0][0], ref)
    for it in (native, python):
        _same_epochs(_epoch(it), want)
        it.reset()
        _same_epochs(_epoch(it), want)
    assert native.provide_data == jax_it.provide_data
    assert native.provide_label == jax_it.provide_label


def test_image_record_iter_cases_match_jax(tmp_path):
    """test_io.py's plain and normalised cases, and ``num_parts`` (the
    Python path), against the JAX package."""
    path = str(tmp_path / "imgs.rec")
    imgs = _raw_rec(path, n=8)
    for kw in (dict(batch_size=4), dict(batch_size=2, mean_r=10.0,
                                        mean_g=20.0, mean_b=30.0, std_r=2.0,
                                        std_g=2.0, std_b=2.0),
               dict(batch_size=2, num_parts=3, part_index=1),
               dict(batch_size=3, round_batch=False)):
        its = [pkg.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 8, 8),
                                      **kw) for pkg in (mx, mt)]
        _same_epochs(_epoch(its[1]), _epoch(its[0]))
    b = mt.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 8, 8),
                              batch_size=4).next()
    np.testing.assert_array_equal(b.data[0].asnumpy()[0],
                                  imgs[0].astype(np.float32))
    np.testing.assert_array_equal(b.label[0].asnumpy(), [0, 1, 2, 3])
    assert b.data[0].context == CPU


def test_native_loader_shuffles_with_its_own_seed(tmp_path):
    """``shuffle`` on the native path: its own ``mt19937_64(seed)`` at
    construction and at every reset; each epoch a permutation of the
    records, each row's label its image's; the same seed, the same
    order."""
    path = str(tmp_path / "imgs.rec")
    n = 16
    imgs = _raw_rec(path, n=n, classes=n)

    def epochs(seed, count=2):
        it = mt.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 8, 8),
                                   batch_size=4, shuffle=True, seed=seed)
        assert it._native is not None
        out = []
        for e in range(count):
            if e:
                it.reset()
            ep = _epoch(it)
            labels = np.concatenate([l for _, l, _ in ep]).astype(int)
            data = np.concatenate([d for d, _, _ in ep])
            assert sorted(labels) == list(range(n))
            for row, lab in zip(data, labels):
                np.testing.assert_array_equal(row, imgs[lab])
            out.append(labels.tolist())
        return out

    a = epochs(3)
    assert a == epochs(3)
    assert a[0] != list(range(n)) and a[0] != a[1]
    assert epochs(4, 1)[0] != a[0]


def test_python_path_shuffles_at_reset_only(tmp_path):
    """The Python path (here ``rand_mirror`` makes it so) keeps the first
    epoch in file order and draws a ``np.random.shuffle`` at reset, as
    the JAX package does; mirrors come from the same draws."""
    path = str(tmp_path / "imgs.rec")
    _raw_rec(path, n=8)
    kw = dict(path_imgrec=path, data_shape=(3, 8, 8), batch_size=4,
              shuffle=True, rand_mirror=True)
    eps = []
    for pkg in (mx, mt):
        np.random.seed(11)
        it = pkg.io.ImageRecordIter(**kw)
        assert it._native is None
        first = _epoch(it)
        it.reset()
        eps.append(first + _epoch(it))
    _same_epochs(eps[1], eps[0])
    np.testing.assert_array_equal(eps[1][0][1], [0, 1, 2, 3])


def test_jpeg_decode_crop_mirror_and_round_batch_match_jax(tmp_path):
    """Encoded records through PIL: random crops and mirrors from one
    ``np.random`` seed, ``round_batch`` wrapping with ``pad``, the
    dropped tail without it, a file smaller than a batch, greyscale,
    PNG, and a raw record that only starts with a JPEG magic."""
    jpeg = str(tmp_path / "jpeg.rec")
    _jpeg_rec(jpeg, n=7)
    gray = str(tmp_path / "gray.rec")
    _jpeg_rec(gray, n=4, gray=True)
    png = str(tmp_path / "png.rec")
    _jpeg_rec(png, n=4, size=(6, 10), fmt="PNG")
    trap = str(tmp_path / "trap.rec")
    arr = _raw_images(1)[0]
    arr.flat[0], arr.flat[1] = 0xFF, 0xD8
    _write(mt, trap, [arr.tobytes()], [5.0])
    cases = [
        dict(path_imgrec=jpeg, data_shape=(3, 8, 8), batch_size=4,
             rand_crop=True, rand_mirror=True),
        dict(path_imgrec=jpeg, data_shape=(3, 8, 8), batch_size=4,
             rand_crop=True, round_batch=False),
        dict(path_imgrec=jpeg, data_shape=(3, 8, 8), batch_size=16,
             rand_crop=True),
        dict(path_imgrec=jpeg, data_shape=(3, 8, 8), batch_size=4),
        dict(path_imgrec=gray, data_shape=(1, 8, 8), batch_size=4,
             mean_r=1.0, std_r=2.0),
        dict(path_imgrec=png, data_shape=(3, 8, 8), batch_size=2,
             rand_crop=True),
        dict(path_imgrec=trap, data_shape=(3, 8, 8), batch_size=1),
    ]
    for kw in cases:
        eps = []
        for pkg in (mx, mt):
            np.random.seed(5)
            it = pkg.io.ImageRecordIter(**kw)
            eps.append(_epoch(it))
        _same_epochs(eps[1], eps[0])
    it = mt.io.ImageRecordIter(**cases[0])
    assert it._native is None
    pads = [p for _, _, p in _epoch(it)]
    assert pads == [0, 1]
    assert [p for _, _, p in _epoch(mt.io.ImageRecordIter(**cases[2]))] == [9]
    assert len(_epoch(mt.io.ImageRecordIter(**cases[1]))) == 1
    np.testing.assert_array_equal(
        _epoch(mt.io.ImageRecordIter(**cases[6]))[0][0][0],
        arr.astype(np.float32))
    # encoded records never reach the native raw-pixel loader
    assert mt.io.ImageRecordIter(**cases[3])._native is None


def test_native_eligibility_follows_the_jax_rules(tmp_path):
    """The native loader takes exactly the unaugmented, single-label,
    unsharded, raw, whole-batch case on a local file (``file://`` too)."""
    path = str(tmp_path / "imgs.rec")
    _raw_rec(path, n=8)
    base = dict(path_imgrec=path, data_shape=(3, 8, 8), batch_size=4)
    assert mt.io.ImageRecordIter(**base)._native is not None
    assert mt.io.ImageRecordIter(**dict(
        base, path_imgrec="file://" + path))._native is not None
    for extra in (dict(rand_mirror=True), dict(rand_crop=True),
                  dict(label_width=2), dict(num_parts=2),
                  dict(batch_size=3), dict(batch_size=3, round_batch=True)):
        assert mt.io.ImageRecordIter(**dict(base, **extra))._native is None
    # a partial tail without round_batch: the native loader drops it, as
    # the Python path does
    it = mt.io.ImageRecordIter(**dict(base, batch_size=3, round_batch=False))
    assert it._native is not None and len(_epoch(it)) == 2


def test_multi_label_records_through_the_python_path(tmp_path):
    path = str(tmp_path / "ml.rec")
    imgs = _raw_images(5)
    _write(mt, path, [a.tobytes() for a in imgs],
           [[float(i), float(i) + 0.5] for i in range(5)])
    eps = [_epoch(pkg.io.ImageRecordIter(path_imgrec=path,
                                         data_shape=(3, 8, 8), batch_size=2,
                                         label_width=2)) for pkg in (mx, mt)]
    _same_epochs(eps[1], eps[0])
    assert eps[1][0][1].shape == (2, 2)


def test_mx_data_iter_wraps_an_iterator(tmp_path):
    path = str(tmp_path / "imgs.rec")
    _raw_rec(path, n=8)
    inner = mt.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 8, 8),
                                  batch_size=4)
    it = mt.io.MXDataIter(inner)
    assert it.batch_size == 4 and it.data_shape == (3, 8, 8)
    want = _epoch(mx.io.MXDataIter(mx.io.ImageRecordIter(
        path_imgrec=path, data_shape=(3, 8, 8), batch_size=4)))
    _same_epochs(_epoch(it), want)
    it.reset()
    _same_epochs(_epoch(it), want)
    with pytest.raises(mt.MXNetError):
        mt.io.MXDataIter("handle")


# -- the native build ------------------------------------------------------

@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """The loader built into an empty directory, the loaded library
    forgotten (and restored afterwards)."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_native, "_LIB", None)
    return tmp_path


def test_native_build_failure_raises_with_the_compiler_output(fresh_build,
                                                              monkeypatch):
    """No silent fallback: a loader that cannot be built makes the
    eligible iterator raise, naming the compiler or quoting it."""
    path = str(fresh_build / "imgs.rec")
    _raw_rec(path, n=4)
    monkeypatch.setenv("CXX", "no-such-compiler-xyz")
    with pytest.raises(mt.MXNetError, match="no-such-compiler-xyz"):
        mt.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 8, 8),
                              batch_size=4)
    monkeypatch.delenv("CXX")
    src = fresh_build / "csrc"
    src.mkdir()
    (src / "recordio.cc").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "SRC_DIR", str(src))
    with pytest.raises(mt.MXNetError, match="this is not C"):
        mt.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 8, 8),
                              batch_size=4)
    assert not [f for f in os.listdir(_build.BUILD_DIR) if "tmp" in f]
    # an ineligible iterator never needs the library
    it = mt.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 8, 8),
                               batch_size=4, rand_mirror=True)
    assert it._native is None and len(_epoch(it)) == 1


def test_concurrent_builds_load_a_whole_library(fresh_build):
    """Three processes build the loader into one empty directory at once
    (as pytest-xdist workers do); each loads it and reads records, and the
    source newer than the library triggers a rebuild."""
    path = str(fresh_build / "imgs.rec")
    _raw_rec(path, n=4)
    code = (
        "import sys\n"
        "from mxnet_tpu_torch.kernels import _build\n"
        "_build.BUILD_DIR = sys.argv[1]\n"
        "import mxnet_tpu_torch as mt\n"
        "it = mt.io.ImageRecordIter(path_imgrec=sys.argv[2],\n"
        "                           data_shape=(3, 8, 8), batch_size=4)\n"
        "assert it._native is not None\n"
        "print(float(it.next().label[0].asnumpy().sum()))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code, _build.BUILD_DIR,
                               path], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for _ in range(3)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        assert out.strip() == "6.0"
    assert os.listdir(_build.BUILD_DIR) == ["librecordio.so"]
    lib = os.path.join(_build.BUILD_DIR, "librecordio.so")
    assert not _build._stale("recordio")
    os.utime(lib, (0, 0))
    assert _build._stale("recordio")


# -- Module.fit from records ----------------------------------------------

def _conv_bn_symbol(pkg):
    with pkg.name.NameManager():
        s = pkg.sym
        net = s.Convolution(s.Variable("data"), kernel=(3, 3), pad=(1, 1),
                            num_filter=4, no_bias=True, name="conv0")
        net = s.BatchNorm(net, fix_gamma=False, name="bn0")
        net = s.Activation(net, act_type="relu", name="relu0")
        net = s.Pooling(net, pool_type="avg", global_pool=True,
                        kernel=(1, 1), name="pool0")
        net = s.FullyConnected(s.Flatten(net), num_hidden=5, name="fc0")
        return s.SoftmaxOutput(net, s.Variable("softmax_label"),
                               name="softmax")


def test_module_fit_from_records_matches_jax(tmp_path):
    """Two ``Module.fit`` batches of a narrow conv+BN net on 3x32x32
    records through ``ImageRecordIter`` (the port's native loader, the
    JAX package's Python path) from the same weights: the loss within
    1e-5 of the JAX package's fp32 fit, every parameter and statistic
    within 1e-5 of its tensor's largest value of the JAX package's fp64
    fit (under ``jax.enable_x64``; JAX keeps BN's gamma and beta fp32
    there). The fp32 JAX fit is no arbiter for the BN shift: its beta is
    2.1e-5 of the largest off its own fp64 fit, the port's 7e-8."""
    import jax
    path = str(tmp_path / "imgs.rec")
    _raw_rec(path, n=8, shape=(3, 32, 32), classes=5)
    norm = dict(mean_r=123.68, mean_g=116.779, mean_b=103.939,
                std_r=58.393, std_g=57.12, std_b=57.375)
    opt = {"learning_rate": 0.1, "momentum": 0.9, "rescale_grad": 0.25}

    def fit(pkg, dtype="float32", arg=None, aux=None):
        mod = pkg.mod.Module(_conv_bn_symbol(pkg), context=pkg.cpu())
        mod.bind([pkg.io.DataDesc("data", (4, 3, 32, 32), dtype)],
                 [pkg.io.DataDesc("softmax_label", (4,), dtype)])
        if arg is None:
            np.random.seed(3)
            mod.init_params(mx.initializer.Xavier())
        elif pkg is mt:
            mt.weights.load_into_module(mod, arg, aux)
        else:
            mod.init_params(
                arg_params={k: mx.nd.array(v, dtype=dtype)
                            for k, v in arg.items()},
                aux_params={k: mx.nd.array(v, dtype=dtype)
                            for k, v in aux.items()})
        arg0 = [{k: v.asnumpy() for k, v in d.items()}
                for d in mod.get_params()]
        it = pkg.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 32, 32),
                                    batch_size=4, **norm)
        assert (it._native is not None) == (pkg is mt)
        metric = pkg.metric.create("ce")
        mod.fit(it, eval_metric=metric, optimizer="sgd",
                optimizer_params=opt, num_epoch=1)
        return arg0, metric.get()[1], [{k: v.asnumpy() for k, v in d.items()}
                                       for d in mod.get_params()]

    (arg0, aux0), jloss, _ = fit(mx)
    _, tloss, tparams = fit(mt, arg=arg0, aux=aux0)
    with jax.enable_x64(True):
        _, loss64, want = fit(mx, "float64", arg0, aux0)
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss), (tloss, jloss)
    assert abs(tloss - loss64) <= 1e-5 * abs(loss64), (tloss, loss64)
    for got, ref in zip(tparams, want):
        assert sorted(got) == sorted(ref)
        for k, w in ref.items():
            assert got[k].dtype == np.float32
            np.testing.assert_allclose(got[k], w, rtol=0,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=k)


def test_native_im2rec_records_read_in_both_packages(tmp_path):
    """test_io.py's im2rec case: ``src/im2rec.cc`` (the repo's C++ packer,
    built here with the host compiler) packs a .lst of files, single- and
    multi-label rows and ``num_parts`` shards; the port reads every record
    as the JAX package does."""
    exe = str(tmp_path / "im2rec")
    subprocess.run([_build.cxx_path(), "-O2", "-std=c++17", "-o", exe,
                    os.path.join(ROOT, "src", "im2rec.cc")], check=True,
                   timeout=120)
    blobs = [bytes(np.random.RandomState(i).randint(0, 256, 100 + 13 * i,
                                                    dtype=np.uint8))
             for i in range(3)]
    for i, b in enumerate(blobs):
        (tmp_path / ("img%d.jpg" % i)).write_bytes(b)
    lst = tmp_path / "train.lst"
    lst.write_text("0\t1.0\timg0.jpg\n1\t2.0\t3.0\timg1.jpg\n"
                   "2\t0.0\timg2.jpg\n")
    out = str(tmp_path / "train")
    subprocess.run([exe, str(lst), str(tmp_path), out], check=True,
                   timeout=120)
    for pkg in (mx, mt):
        rec = pkg.recordio.MXIndexedRecordIO(out + ".idx", out + ".rec", "r")
        got = [pkg.recordio.unpack(rec.read_idx(i)) for i in range(3)]
        assert [bytes(p) for _, p in got] == blobs
        assert got[0][0].label == 1.0 and got[2][0].label == 0.0
        assert list(got[1][0].label) == [2.0, 3.0]
    ids = []
    for part in (0, 1):
        shard = str(tmp_path / ("shard%d" % part))
        subprocess.run([exe, str(lst), str(tmp_path), shard, "2",
                        str(part)], check=True, timeout=120)
        ids += [mt.recordio.unpack(r)[0].id
                for r in _read_all(mt, shard + ".rec")]
    assert sorted(ids) == [0, 1, 2]


def test_ndarray_iter_num_parts_shards_like_jax():
    """test_io.py's sharding case: ``num_parts``/``part_index`` give each
    worker every ``num_parts``-th row, in both packages."""
    x = np.arange(24, dtype=np.float32).reshape(12, 2)
    y = np.arange(12, dtype=np.float32)
    seen = {}
    for pkg in (mx, mt):
        parts = [pkg.io.NDArrayIter(x, y, batch_size=2, num_parts=3,
                                    part_index=i) for i in (0, 1)]
        assert parts[0].num_data == parts[1].num_data == 4
        seen[pkg] = [b.label[0].asnumpy().tolist() for it in parts
                     for b in it]
    assert seen[mt] == seen[mx]
    assert sorted(v for b in seen[mt] for v in b) == [0, 1, 3, 4, 6, 7, 9,
                                                      10]
