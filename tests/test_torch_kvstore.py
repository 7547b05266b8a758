"""``mx.kvstore`` of the PyTorch port against the JAX package's, and the
store under ``Module.fit``, ``fit.py``'s resume and ``gluon.Trainer``.

The store: ``init``/``push``/``pull`` with single keys, key lists,
grouped shard lists and string keys hold the same values as the JAX
store: 0.0 in fp32 for the sums; with an optimizer within 2 fp32 ulps
(4.8e-7 relative), because the JAX store's updater runs one jitted
program whose multiply-adds XLA contracts into FMAs (eager JAX and the
port agree bit for bit on ``sgd_mom_update``);
optimizer states round-trip between the two packages' files;
``row_sparse_pull`` gives the JAX package's rows (the ``dist*`` types,
gradient compression and sparse storage have their own files,
``test_torch_dist.py``, ``test_torch_gradient_compression.py`` and
``test_torch_sparse*.py``).

``Module.fit``: LeNet (``examples/image-classification/symbols/
lenet.py``, the copy in ``chip_smoke.py`` for the port) at batch 8 on
28x28x1 trains 4 batches with ``kvstore=mx.kvstore.create("device")``
from the same weights as the JAX Module: parameters within 1.2e-6. In
the port, kvstore store or None, fused or phase-split are all bit-equal,
and a switch from fused to phase-split in the middle of ``fit``
continues from the same weights. Resume (``examples/image-classification/
common/fit.py``): two epochs under ``MultiFactorScheduler``, then a fresh
Module from epoch 1's checkpoint, parameters only (the rate at every
update equal to the uninterrupted run's) and with the optimizer's states
(rate and parameters bit-equal). ``gluon.Trainer`` with a store: the
port's batched push bit-equal to a push key by key and to no store, and
within 1e-6 of the JAX Trainer's.
"""
import importlib.util
import os
import pickle
import sys

import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = mt.cpu()
B, NB = 8, 4


def _load(name, path, package_dir=None):
    """A module from a file of the repo that is not on the path: the
    script ``chip_smoke.py`` or the examples' symbol package."""
    if name in sys.modules:
        return sys.modules[name]
    kw = {"submodule_search_locations": [package_dir]} if package_dir else {}
    spec = importlib.util.spec_from_file_location(name, path, **kw)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _load("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
_SYM_DIR = os.path.join(ROOT, "examples", "image-classification", "symbols")
jsymbols = _load("ic_symbols_jax", os.path.join(_SYM_DIR, "__init__.py"),
                 _SYM_DIR)


def _nd(pkg, x):
    return pkg.nd.array(x, ctx=CPU) if pkg is mt else pkg.nd.array(x)


# ---------------------------------------------------------------------------
# the store itself
# ---------------------------------------------------------------------------

def _store_run(pkg, with_opt):
    rs = np.random.RandomState(0)

    def r(*shape):
        return rs.randn(*shape).astype(np.float32)
    kv = pkg.kvstore.create("device")
    assert (kv.rank, kv.num_workers, kv.type) == (0, 1, "device")
    kv.init(3, _nd(pkg, r(3, 4)))
    kv.init([5, 7], [_nd(pkg, r(2, 5)), _nd(pkg, r(6))])
    kv.init("w", _nd(pkg, r(4, 2)))
    if with_opt:
        kv.set_optimizer(pkg.optimizer.create(
            "sgd", learning_rate=0.1, momentum=0.9, wd=1e-4,
            rescale_grad=0.5))
    out = {}
    for step in range(2):
        kv.push(3, _nd(pkg, r(3, 4)))
        kv.push([5, 7], [_nd(pkg, r(2, 5)), _nd(pkg, r(6))])
        # grouped: two shards per key, summed
        kv.push([5, 7], [_nd(pkg, r(2, 5)), _nd(pkg, r(2, 5)),
                         _nd(pkg, r(6)), _nd(pkg, r(6))])
        kv.push("w", [_nd(pkg, r(4, 2)), _nd(pkg, r(4, 2)),
                      _nd(pkg, r(4, 2))])
        o3 = _nd(pkg, np.zeros((3, 4), np.float32))
        kv.pull(3, out=o3)
        o5a, o5b = (_nd(pkg, np.zeros((2, 5), np.float32)) for _ in "ab")
        o7a, o7b = (_nd(pkg, np.zeros(6, np.float32)) for _ in "ab")
        kv.pull([5, 7], out=[o5a, o5b, o7a, o7b])
        ow = _nd(pkg, np.zeros((4, 2), np.float32))
        kv.pull("w", out=ow)
        np.testing.assert_array_equal(o5a.asnumpy(), o5b.asnumpy())
        np.testing.assert_array_equal(o7a.asnumpy(), o7b.asnumpy())
        out.update({("3", step): o3.asnumpy(), ("5", step): o5a.asnumpy(),
                    ("7", step): o7a.asnumpy(), ("w", step): ow.asnumpy()})
    return out, kv


@pytest.mark.parametrize("with_opt", [False, True],
                         ids=["sum", "optimizer"])
def test_store_push_pull_matches_jax(with_opt):
    want, _ = _store_run(mx, with_opt)
    got, _ = _store_run(mt, with_opt)
    assert sorted(got) == sorted(want)
    for k in want:
        if with_opt:
            np.testing.assert_allclose(got[k], want[k], rtol=4.8e-7, atol=0,
                                       err_msg=str(k))
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_store_optimizer_states_both_ways(tmp_path, writer):
    """States saved by one package's store load into the other's, and
    the next push gives the same values in both."""
    pkgs = {"port": mt, "jax": mx}
    src_pkg = pkgs[writer]
    dst_pkg = pkgs["jax" if writer == "port" else "port"]
    _, src = _store_run(src_pkg, True)
    fname = str(tmp_path / "kv.states")
    src.save_optimizer_states(fname)
    _, dst = _store_run(dst_pkg, True)
    dst.load_optimizer_states(fname)
    # the destination's weights take the source's, then both push alike
    for k in (3, 5, 7, "w"):
        dst._store[k][:] = _nd(dst_pkg, src._store[k].asnumpy())
    g = np.random.RandomState(9).randn(3, 4).astype(np.float32)
    src.push(3, _nd(src_pkg, g))
    dst.push(3, _nd(dst_pkg, g))
    np.testing.assert_array_equal(dst._store[3].asnumpy(),
                                  src._store[3].asnumpy())
    a = pickle.loads(open(fname, "rb").read())
    assert sorted(map(str, a)) == ["3", "5", "7", "w"]


def test_store_refuses_what_is_not_ported():
    """The dist types and gradient compression are ported (one process
    here: rank 0 of 1, as the JAX package's stores report outside a
    launched job), and so is ``row_sparse_pull``: the rows it gives equal
    the JAX package's (values bit-equal, ids exact). An unknown type and
    a pull of a key never stored are still refused."""
    for name in ("dist_sync", "dist_async", "dist_device_sync"):
        kv, jkv = mt.kvstore.create(name), mx.kvstore.create(name)
        assert (kv.rank, kv.num_workers) == (jkv.rank, jkv.num_workers) \
            == (0, 1)
        assert kv.fused_dist_step == jkv.fused_dist_step
        assert kv.fused_step_subsumable == jkv.fused_step_subsumable
    with pytest.raises(mt.MXNetError, match="unknown kvstore type"):
        mt.kvstore.create("bogus")
    kv = mt.kv.create("local")
    assert isinstance(kv, mt.KVStore) and kv.fused_step_subsumable
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    assert not kv.fused_step_subsumable
    kv, jkv = mt.kv.create("local"), mx.kv.create("local")
    w = np.arange(12, dtype=np.float32).reshape(6, 2) - 4.0
    w[3] = 0.0
    for pkg, store in ((mt, kv), (mx, jkv)):
        store.init(0, _nd(pkg, w))
    got = mt.nd.sparse.zeros("row_sparse", (6, 2), ctx=CPU)
    want = mx.nd.sparse.zeros("row_sparse", (6, 2))
    kv.row_sparse_pull(0, out=got, row_ids=_nd(mt, [5, 1, 3, 1]))
    jkv.row_sparse_pull(0, out=want, row_ids=mx.nd.array([5, 1, 3, 1]))
    np.testing.assert_array_equal(got.indices.asnumpy(),
                                  want.indices.asnumpy())
    np.testing.assert_array_equal(got.data.asnumpy(), want.data.asnumpy())
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    with pytest.raises(mt.MXNetError, match="not init"):
        kv.pull(1, out=_nd(mt, np.zeros(2)))
    kv.barrier()


class _P:
    def __init__(self, *shape):
        self.shape = shape


@pytest.mark.parametrize("spec", [
    (None, 1, None), ("local", 1, None), ("device", 1, None),
    ("local", 2, True), ("device", 2, True), ("local", 2, False),
    ("store", 1, True)])
def test_create_kvstore_rules_match_jax(spec):
    """model._create_kvstore: a type name on one device means no store;
    a created ``local`` store leaves the update to the caller above 16M
    elements in one parameter; a store object updates."""
    kvstore, ndev, small = spec
    params = {"w": _P(4096, 4097 if small is False else 4)}
    res = {}
    for pkg in (mx, mt):
        kv = pkg.kvstore.create("device") if kvstore == "store" else kvstore
        got, upd = pkg.model._create_kvstore(kv, ndev, params)
        res[pkg.__name__] = (None if got is None else got.type, upd)
    assert res["mxnet_tpu"] == res["mxnet_tpu_torch"], res


# ---------------------------------------------------------------------------
# Module.fit with a store
# ---------------------------------------------------------------------------

def _lenet(pkg):
    with pkg.name.NameManager():
        if pkg is mx:
            return jsymbols.get_symbol("lenet", 10)
        return chip_smoke.ic_symbol(mt, "lenet", 10)


def _data(n=NB * B, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.uniform(0, 1, (n, 1, 28, 28)).astype(np.float32),
            rs.randint(0, 10, n).astype(np.float32))


def _init_numpy():
    """Xavier weights of the JAX LeNet, as numpy."""
    mod = mx.mod.Module(_lenet(mx), context=mx.cpu())
    mod.bind([("data", (B, 1, 28, 28))], [("softmax_label", (B,))])
    np.random.seed(3)
    mod.init_params(mx.initializer.Xavier(magnitude=2.0))
    arg, aux = mod.get_params()
    return ({k: v.asnumpy() for k, v in arg.items()},
            {k: v.asnumpy() for k, v in aux.items()})


OPT = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4,
       "rescale_grad": 1.0 / B}


def _fit(pkg, arg, aux, kv, fused=True, num_epoch=1, x=None, y=None,
         monkeypatch=None, **kw):
    if monkeypatch is not None:
        monkeypatch.setenv("MXNET_MODULE_FUSED_STEP", "1" if fused else "0")
    if x is None:
        x, y = _data()
    ctx = CPU if pkg is mt else mx.cpu()
    mod = pkg.mod.Module(_lenet(pkg), context=ctx)
    it = pkg.io.NDArrayIter(x, y, batch_size=B)
    mod.fit(it, kvstore=kv, optimizer="sgd", optimizer_params=dict(OPT),
            arg_params={k: _nd(pkg, v) for k, v in arg.items()},
            aux_params={k: _nd(pkg, v) for k, v in aux.items()},
            num_epoch=num_epoch, eval_metric="acc", **kw)
    return mod


def _params(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_module_fit_with_store_matches_jax_and_every_route(monkeypatch):
    arg, aux = _init_numpy()
    jmod = _fit(mx, arg, aux, mx.kvstore.create("device"))
    assert jmod._update_on_kvstore
    want = _params(jmod)
    runs = {}
    for kv in ("store", None):
        for fused in (True, False):
            store = mt.kvstore.create("device") if kv else None
            mod = _fit(mt, arg, aux, store, fused, monkeypatch=monkeypatch)
            assert mod._update_on_kvstore == bool(kv)
            assert (mod._fused_fallback_reason is None) == fused
            runs[(kv, fused)] = _params(mod)
            if kv:      # the store's copies are the module's weights
                for i, n in enumerate(mod._param_names):
                    np.testing.assert_array_equal(
                        store._store[i].asnumpy(), runs[(kv, fused)][n])
    base = runs[("store", True)]
    for key, got in runs.items():
        for k in base:
            np.testing.assert_array_equal(got[k], base[k],
                                          err_msg="%s %s" % (key, k))
    for k in want:
        np.testing.assert_allclose(base[k], want[k], rtol=0, atol=1.2e-6,
                                   err_msg=k)


def test_fused_to_phase_split_switch_mid_fit(monkeypatch):
    """Two batches fused, then phase-split: the store's copies carry the
    fused step's weights, so the result equals an all-fused run."""
    arg, aux = _init_numpy()
    monkeypatch.setenv("MXNET_MODULE_FUSED_STEP", "1")
    whole = _params(_fit(mt, arg, aux, mt.kvstore.create("device")))

    def switch(param):
        if param.nbatch == 1:
            monkeypatch.setenv("MXNET_MODULE_FUSED_STEP", "0")
    mod = _fit(mt, arg, aux, mt.kvstore.create("device"),
               batch_end_callback=switch)
    assert mod._fused_fallback_reason.code == "env_pin"
    got = _params(mod)
    for k in whole:
        np.testing.assert_array_equal(got[k], whole[k], err_msg=k)


def _resume_run(pkg, tmp_path, arg, aux, route=None):
    """fit.py's loop on LeNet: 2 epochs of 4 batches from ``arg``/``aux``
    with the rate stepping after epoch 1 (``--lr-step-epochs 1``), or,
    with ``route``, epoch 2 alone resumed from the uninterrupted run's
    epoch-1 checkpoint. Returns (module, rate at each update)."""
    x, y = _data()
    ctx = CPU if pkg is mt else mx.cpu()
    load_epoch = None if route is None else 1
    lr, sched = chip_smoke._fitpy_lr(0.05, 0.1, [1], load_epoch, NB, pkg)
    opt = {"learning_rate": lr, "momentum": 0.9, "wd": 1e-4,
           "rescale_grad": 1.0 / B}
    if sched is not None:
        opt["lr_scheduler"] = sched
    prefix = str(tmp_path / ("%s-a" % pkg.__name__))
    sprefix = str(tmp_path / ("%s-b" % pkg.__name__))
    kv = pkg.kvstore.create("device")
    if route == "states":
        mod = pkg.mod.Module.load(sprefix, 1, load_optimizer_states=True,
                                  context=ctx)
        arg_p = aux_p = None
        if pkg is mx:
            # the JAX Module.load keeps the states file's name and never
            # reads it (ROADMAP Queue 3): load them by hand
            mod.bind([("data", (B, 1, 28, 28))], [("softmax_label", (B,))])
            mod.init_optimizer(kvstore=kv, optimizer="sgd",
                               optimizer_params=opt)
            mod.load_optimizer_states("%s-0001.states" % sprefix)
    else:
        mod = pkg.mod.Module(_lenet(pkg), context=ctx)
        if route == "params":
            _, arg_p, aux_p = pkg.model.load_checkpoint(
                prefix, 1, **({"ctx": CPU} if pkg is mt else {}))
        else:
            arg_p = {k: _nd(pkg, v) for k, v in arg.items()}
            aux_p = {k: _nd(pkg, v) for k, v in aux.items()}
    rates = []

    def rate(param):
        rates.append(mod._optimizer.learning_rate)
    epoch_end = None
    if route is None:
        epoch_end = [pkg.callback.do_checkpoint(prefix),
                     pkg.callback.module_checkpoint(
                         mod, sprefix, save_optimizer_states=True)]
    mod.fit(pkg.io.NDArrayIter(x, y, batch_size=B),
            kvstore=kv, optimizer="sgd",
            optimizer_params=opt, arg_params=arg_p, aux_params=aux_p,
            initializer=pkg.initializer.Xavier(magnitude=2.0),
            eval_metric=["acc"], begin_epoch=load_epoch or 0, num_epoch=2,
            batch_end_callback=rate, epoch_end_callback=epoch_end)
    return mod, rates


def test_fitpy_resume_both_routes(tmp_path):
    arg, aux = _init_numpy()
    whole, rates = _resume_run(mt, tmp_path, arg, aux)
    assert rates == [0.05] * NB + [0.05 * 0.1] * NB
    want = _params(whole)
    jwhole, jrates = _resume_run(mx, tmp_path, arg, aux)
    assert jrates == rates
    jwant = _params(jwhole)
    for k in want:
        np.testing.assert_allclose(want[k], jwant[k], rtol=0, atol=1.2e-6,
                                   err_msg=k)
    # parameters only: momentum restarts, the rate does not
    mod, got_rates = _resume_run(mt, tmp_path, arg, aux, route="params")
    assert got_rates == rates[NB:]
    diff = max(np.abs(_params(mod)[k] - want[k]).max() for k in want)
    assert diff > 0
    # with the optimizer's states: the uninterrupted run, bit for bit
    mod, got_rates = _resume_run(mt, tmp_path, arg, aux, route="states")
    assert got_rates == rates[NB:]
    got = _params(mod)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_resume_from_the_other_packages_states(tmp_path, writer):
    """Each package resumes epoch 2 from the other's epoch-1 checkpoint
    and store states, and lands within 1.2e-6 of the other's
    uninterrupted run."""
    arg, aux = _init_numpy()
    src, dst = (mt, mx) if writer == "port" else (mx, mt)
    whole, _ = _resume_run(src, tmp_path, arg, aux)
    want = _params(whole)
    for suffix in ("a", "b"):
        for ext in ("-symbol.json", "-0001.params", "-0001.states"):
            path = str(tmp_path / ("%s-%s%s" % (src.__name__, suffix, ext)))
            if os.path.exists(path):
                os.replace(path, str(tmp_path / (
                    "%s-%s%s" % (dst.__name__, suffix, ext))))
    mod, _ = _resume_run(dst, tmp_path, arg, aux, route="states")
    got = _params(mod)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1.2e-6,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# gluon.Trainer with a store
# ---------------------------------------------------------------------------

def _mlp(pkg):
    net = pkg.gluon.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(8, activation="relu", in_units=5))
        net.add(pkg.gluon.nn.Dense(3, in_units=8))
    return net


def _trainer_run(pkg, kv, per_key=False, steps=3):
    rs = np.random.RandomState(4)
    net = _mlp(pkg)
    ctx = CPU if pkg is mt else mx.cpu()
    net.initialize(ctx=ctx)
    w = np.random.RandomState(1)
    for p in net.collect_params().values():
        p.set_data(_nd(pkg, w.randn(*p.shape).astype(np.float32) * 0.3))
    tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9,
                            "wd": 1e-3}, kvstore=kv)
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(steps):
        x = _nd(pkg, rs.randn(6, 5).astype(np.float32))
        y = _nd(pkg, rs.randint(0, 3, 6).astype(np.float32))
        with pkg.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        if per_key:     # the JAX Trainer's route: one key at a time
            tr._optimizer.rescale_grad = 1.0 / 6
            if not tr._kv_initialized:
                tr._init_kvstore()
            for i, p in enumerate(tr._params):
                tr._kvstore.push(i, p.grad())
                tr._kvstore.pull(i, out=p.data())
        else:
            tr.step(6)
    return {k: p.data().asnumpy() for k, p in
            net.collect_params().items()}, tr


def test_trainer_with_store_routes_and_jax():
    batched, tr = _trainer_run(mt, mt.kvstore.create("device"))
    assert tr._update_on_kvstore and tr._kvstore is not None
    per_key, _ = _trainer_run(mt, mt.kvstore.create("device"), per_key=True)
    none, tr0 = _trainer_run(mt, None)
    assert tr0._kvstore is None
    want, jtr = _trainer_run(mx, mx.kvstore.create("device"))
    assert jtr._update_on_kvstore
    for k in batched:
        np.testing.assert_array_equal(per_key[k], batched[k], err_msg=k)
        np.testing.assert_array_equal(none[k], batched[k], err_msg=k)
        np.testing.assert_allclose(batched[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_trainer_states_through_the_store(tmp_path):
    """save_states/load_states go through the store's updater: a Trainer
    that loads them continues as the one that saved them."""
    fname = str(tmp_path / "trainer.states")
    a, tra = _trainer_run(mt, mt.kvstore.create("device"), steps=2)
    tra.save_states(fname)
    b, trb = _trainer_run(mt, mt.kvstore.create("device"), steps=1)
    trb.load_states(fname)
    st_a = pickle.loads(tra._kvstore._updater.get_states())
    st_b = pickle.loads(trb._kvstore._updater.get_states())
    assert sorted(st_a) == sorted(st_b)
    for i in st_a:
        np.testing.assert_array_equal(np.asarray(st_a[i]),
                                      np.asarray(st_b[i]))
