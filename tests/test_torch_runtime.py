"""The runtime's leftovers against the JAX package: ``mx.engine``,
``mx.storage`` (and ``resource`` temp space over it), the registry
helpers, ``tuner.OperatorTuner``, ``mx.viz.print_summary``,
``mx.contrib``, ``mx.test_utils``, ``DeviceMemoryError``,
``nd.load_frombuffer``, ``mx.libinfo`` and ``MXNET_PROFILER_AUTOSTART``.

The engine and the storage pool are the port's copies of the JAX
package's ``src/engine.cc`` and ``src/storage.cc``, built here with the
host compiler at first use; the JAX package runs its Python fallbacks
here (its libraries are not built), so the engine is held to the same
results as the JAX package's for the same program of pushes, and the
pool to the C source's rules.
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import executor as mx_executor

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import executor as mt_executor
from torch_threads import one_torch_thread  # noqa: F401

PKGS = (mx, mt)


# -- mx.engine ---------------------------------------------------------------

def test_engine_writes_in_push_order_readers_together():
    """Exclusive writers run in push order; readers between two writers
    overlap and never meet a writer (the ThreadedVar discipline)."""
    e = mt.engine.Engine(num_workers=4)
    assert not e.naive
    v = e.new_var()
    out = []

    def mk(i):
        def f():
            time.sleep(0.0005)
            out.append(i)
        return f

    for i in range(100):
        e.push(mk(i), mutable_vars=[v])
    e.wait_for_var(v)
    assert out == list(range(100))

    lock = threading.Lock()
    active, peak, seen = [0], [0], []

    def reader():
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        time.sleep(0.01)
        with lock:
            active[0] -= 1

    def writer():
        with lock:
            seen.append(active[0])

    for _ in range(6):
        e.push(reader, const_vars=[v])
    e.push(writer, mutable_vars=[v])
    for _ in range(6):
        e.push(reader, const_vars=[v])
    e.wait_all()
    assert peak[0] > 1 and seen == [0]


def _dataflow(engine_mod, naive):
    """A program of 60 pushes over 4 variables, each reading some and
    writing one (with jittered sleeps): the final state is fixed by the
    dependency rules alone."""
    e = engine_mod.Engine(num_workers=4, naive=naive)
    rs = np.random.RandomState(7)
    vars_ = [e.new_var() for _ in range(4)]
    state = [1, 2, 3, 4]
    for i in range(60):
        w = int(rs.randint(4))
        reads = [int(r) for r in rs.choice(4, 2, replace=False) if r != w]
        sleep = float(rs.uniform(0, 0.002))

        def op(w=w, reads=reads, i=i, sleep=sleep):
            acc = [state[r] for r in reads]
            time.sleep(sleep)
            state[w] = (state[w] * 31 + sum(acc) * 7 + i) % 1000003
        e.push(op, const_vars=[vars_[r] for r in reads],
               mutable_vars=[vars_[w]])
    e.wait_all()
    return state


def test_engine_dataflow_matches_the_jax_engine():
    """The same pushes give the JAX engine's state, threaded and naive."""
    want = _dataflow(mx.engine, None)
    assert _dataflow(mt.engine, False) == want
    assert _dataflow(mt.engine, True) == want


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "port"])
def test_engine_rejects_overlapping_sets_and_naive_runs_inline(pkg):
    e = pkg.engine.Engine(num_workers=2)
    v = e.new_var()
    with pytest.raises(pkg.base.MXNetError):
        e.push(lambda: None, const_vars=[v], mutable_vars=[v])
    with pytest.raises(pkg.base.MXNetError):
        e.push(lambda: None, mutable_vars=[v, v])
    n = pkg.engine.NaiveEngine()
    out = []
    n.push(lambda: out.append(1), mutable_vars=[n.new_var()])
    assert out == [1]
    prev = pkg.engine.set_bulk_size(5)
    with pkg.engine.bulk(10):
        assert pkg.engine.set_bulk_size(10) == 10
    assert pkg.engine.set_bulk_size(prev) == 5


def test_engine_errors_surface_at_the_wait():
    """Work that raises: the next wait raises ``MXNetError`` with the
    error as its cause (the JAX engine prints it and goes on); work after
    it still runs; the naive engine raises at the push."""
    e = mt.engine.Engine(num_workers=2)
    v = e.new_var()
    boom = ValueError("boom")
    done = []

    def bad():
        raise boom

    e.push(bad, mutable_vars=[v])
    e.push(lambda: done.append(1), mutable_vars=[v])
    with pytest.raises(mt.MXNetError, match="boom") as ei:
        e.wait_all()
    assert ei.value.__cause__ is boom and done == [1]
    e.wait_all()                                 # reported once
    e.delete_var(v)
    with pytest.raises(mt.MXNetError, match="boom"):
        mt.engine.NaiveEngine().push(bad)


def test_engine_type_from_the_environment(monkeypatch):
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    assert mt.engine.Engine().naive
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "ThreadedEnginePerDevice")
    monkeypatch.setenv("MXNET_CPU_WORKER_NTHREADS", "2")
    assert not mt.engine.Engine().naive
    assert isinstance(mt.engine.get(), mt.engine.Engine)


# -- mx.storage and resource temp space ------------------------------------

def test_storage_pool_handles_and_stats():
    """Power-of-two buckets from 4 KB, a freed buffer parked and handed out
    again, ``direct_free`` past the pool, ``release_all`` emptying it, and
    a ``Handle.array`` view that writes the buffer."""
    st = mt.storage.Storage.get()
    assert st is mt.resource.Storage.get()
    st.release_all()
    base = st.stats()
    h = st.alloc(5000)
    a = h.array((10, 25), np.float32)
    a[:] = np.arange(250, dtype=np.float32).reshape(10, 25)
    np.testing.assert_array_equal(h.array((250,), np.float32),
                                  np.arange(250, dtype=np.float32))
    s1 = st.stats()
    assert s1["allocated"] - base["allocated"] == 8192
    assert s1["peak"] >= s1["allocated"]
    with pytest.raises(mt.MXNetError, match="exceeds"):
        h.array((5001,), np.uint8)
    ptr = h.ptr
    st.free(h)
    with pytest.raises(mt.MXNetError, match="use-after-free"):
        h.array((1,))
    assert st.stats()["pooled"] == 8192
    h2 = st.alloc(6000)                          # the same bucket, reused
    assert h2.ptr == ptr and st.stats()["pooled"] == 0
    st.direct_free(h2)
    assert st.stats()["pooled"] == 0
    h3 = st.alloc(100)
    st.free(h3)
    assert st.stats()["pooled"] == 4096
    st.release_all()
    assert st.stats()["pooled"] == 0
    assert st.stats()["allocated"] == base["allocated"]


def test_temp_space_comes_from_the_pool():
    """``resource`` temp space is pooled storage, as in the JAX package:
    one slot reused while it fits, a larger request a larger bucket, and
    ``release`` hands everything back."""
    st = mt.storage.Storage.get()
    before = st.stats()["allocated"]
    r = mt.resource.Resource("temp_space", mt.cpu())
    a = r.get_space((4, 4))
    a[:] = 3.0
    assert st.stats()["allocated"] - before == 4096
    b = r.get_space((2, 8))
    assert np.shares_memory(a, b) and (b == 3.0).all()
    r.get_space((4096,))                         # 16 KB: a new bucket
    assert st.stats()["allocated"] - before == 4096 + 16384
    r.release()
    assert st.stats()["allocated"] == before
    jr = mx.resource.Resource("temp_space", mx.cpu())
    np.testing.assert_array_equal(jr.get_space((3, 5)).shape, (3, 5))


def test_device_stats_and_ledger_report_on_the_host():
    assert mt.storage.Storage.device_stats(mt.cpu()) == {}
    rep = mt.storage.Storage.ledger_report()
    assert set(rep) >= {"contexts", "devices", "top_buffers"}
    assert ("reconciliation" in rep) == torch.cuda.is_available()
    json.dumps(rep)


# -- the registry helpers ----------------------------------------------------

def _registry_roundtrip(pkg):
    class Base:
        def __init__(self, a=1):
            self.a = a

    class Thing(Base):
        pass

    nick = "things_%s" % pkg.__name__
    reg = pkg.registry.get_register_func(Base, nick)
    alias = pkg.registry.get_alias_func(Base, nick)
    create = pkg.registry.get_create_func(Base, nick)
    reg(Thing)
    alias("thing2", "t3")(Thing)
    out = [type(create("Thing")).__name__, create("THING2", a=4).a,
           create('["t3", {"a": 5}]').a]
    inst = Thing()
    out.append(create(inst) is inst)
    with pytest.raises(pkg.base.MXNetError, match="not registered"):
        create("nope")
    with pytest.raises(AssertionError):
        reg(int)
    sgd = pkg.registry.get_create_func(pkg.optimizer.Optimizer,
                                       "optimizer")(
        '["sgd", {"learning_rate": 0.25}]')
    out.append((type(sgd).__name__, sgd.lr))
    return out


def test_registry_helpers_match_jax():
    assert _registry_roundtrip(mt) == _registry_roundtrip(mx)


def test_kind_registries_share_names_with_jax():
    """The built-in metrics, optimizers, initializers and data iterators
    are visible by the JAX package's names through the kind registries,
    ``mx.init_registry`` and ``io.create_iterator``."""
    from mxnet_tpu import base as mx_base
    from mxnet_tpu_torch import base as mt_base
    for kind in ("metric", "optimizer", "initializer", "data iterator"):
        want = set(mx_base._KIND_REGISTRIES[kind])
        have = set(mt_base._KIND_REGISTRIES[kind])
        assert want <= have, (kind, sorted(want - have))
    for pkg in PKGS:
        assert type(pkg.init_registry["create"]("xavier")).__name__ == \
            "Xavier"
        assert callable(pkg.metric.registry_create)


def test_create_iterator_builds_a_registered_iterator(tmp_path):
    path = str(tmp_path / "d.csv")
    np.savetxt(path, np.arange(24, dtype=np.float32).reshape(6, 4),
               delimiter=",")
    got = []
    for pkg in PKGS:
        it = pkg.io.create_iterator("csviter", data_csv=path,
                                    data_shape=(4,), batch_size=3)
        got.append([b.data[0].asnumpy() for b in it])
    assert len(got[0]) == len(got[1]) == 2
    for a, b in zip(*got):
        np.testing.assert_array_equal(a, b)


# -- tuner.OperatorTuner -------------------------------------------------------

def _cands(slow_s=0.01):
    calls = {"slow": 0, "fast": 0}

    def slow():
        calls["slow"] += 1
        time.sleep(slow_s)
        return torch.zeros(1)

    def fast():
        calls["fast"] += 1
        return torch.zeros(1)

    return [("slow", slow), ("fast", fast)], calls


def test_operator_tuner_chooses_and_caches(monkeypatch):
    monkeypatch.delenv("MXNET_TUNING_CACHE", raising=False)
    monkeypatch.setenv("MXNET_TUNING_REPEAT", "2")
    t = mt.tuner.OperatorTuner()
    cands, calls = _cands()
    assert t.choose("op", "k1", cands) == "fast"
    assert calls == {"slow": 3, "fast": 3}       # warm-up + 2 timed each
    assert t.choose("op", "k1", cands) == "fast"
    assert calls == {"slow": 3, "fast": 3}       # cached: no new runs
    (op, key, win, times), = t.records()
    assert (op, key, win) == ("op", "k1", "fast") and times["slow"] > 0.01
    broken = [("bad", lambda: 1 / 0), ("ok", lambda: torch.ones(1))]
    assert t.choose("op", "k2", broken) == "ok"
    assert t.choose("op", "k3", [("only", None)]) == "only"
    t.clear()
    assert t.records() == []
    assert mt.tuner.tuner() is mt.tuner.tuner()


def test_operator_tuner_off_gives_the_first_candidate(monkeypatch):
    monkeypatch.setenv("MXNET_USE_OPERATOR_TUNING", "0")
    cands, calls = _cands()
    assert mt.tuner.OperatorTuner().choose("op", "k", cands) == "slow"
    assert calls == {"slow": 0, "fast": 0}


def test_operator_tuner_cache_file_shared_with_jax(tmp_path, monkeypatch):
    """``MXNET_TUNING_CACHE`` persists the decisions as the JAX package's
    JSON: a file written by either package's tuner is read by the
    other's without measuring again."""
    path = str(tmp_path / "tune.json")
    monkeypatch.setenv("MXNET_TUNING_CACHE", path)
    cands, calls = _cands()
    assert mt.tuner.OperatorTuner().choose("op", "k", cands) == "fast"
    assert json.load(open(path)) == {"op|k": "fast"}
    jt = mx.tuner.OperatorTuner()
    assert jt.choose("op", "k", [("slow", None), ("fast", None)]) == "fast"
    assert jt.records() == []
    jt.choose("op", "j", [("a", lambda: None), ("b", lambda: None)])
    port = mt.tuner.OperatorTuner()
    assert port.choose("op", "j", [("a", None), ("b", None)]) == \
        json.load(open(path))["op|j"]
    assert port.records() == []


def test_tuned_choice_never_measures_meta_tensors(monkeypatch):
    monkeypatch.delenv("MXNET_TUNING_CACHE", raising=False)
    mt.tuner.tuner().clear()
    cands, calls = _cands()
    meta = torch.empty(3, device="meta")
    assert mt.tuner.tuned_choice("op", "m", cands, args=(meta,)) == "slow"
    assert calls == {"slow": 0, "fast": 0}
    assert mt.tuner.tuned_choice("op", "m", cands, args=(torch.ones(3),)) \
        == "fast"
    assert mt.tuner.tuned_choice("op", "m", cands, args=(meta,)) == "fast"
    mt.tuner.tuner().clear()


# -- mx.viz.print_summary ------------------------------------------------------

def _viz_net(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.Convolution(data, kernel=(3, 3), num_filter=4,
                              pad=(1, 1), name="conv")
    net = pkg.sym.BatchNorm(net, name="bn")
    net = pkg.sym.Activation(net, act_type="relu", name="relu")
    net = pkg.sym.Flatten(net, name="flatten")
    net = pkg.sym.FullyConnected(net, num_hidden=10, name="fc")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


@pytest.mark.parametrize("shape", [None, {"data": (1, 3, 8, 8)}],
                         ids=["no_shape", "shape"])
def test_print_summary_text_equals_jax(capsys, shape):
    got = mt.viz.print_summary(_viz_net(mt), shape=shape)
    text = capsys.readouterr().out
    want = mx.viz.print_summary(_viz_net(mx), shape=shape)
    assert text == capsys.readouterr().out
    assert got == want
    if shape:
        assert got == 3 * 3 * 3 * 4 + 4 + 4 + 4 + 4 * 8 * 8 * 10 + 10
    assert mt.visualization.print_summary is mt.viz.print_summary


def test_print_summary_counts_an_unrolled_cell_once(capsys):
    """Shared weights of an unrolled ``mx.rnn.ConvLSTMCell`` count once,
    so the total is the size of every learnable argument; the JAX
    package counts an input only when its name starts with the node's
    and gives 0 here (ROADMAP Queue 3, faults of the reference)."""
    shapes = {"data": (2, 3, 3, 6, 6), "s0": (2, 4, 6, 6),
              "s1": (2, 4, 6, 6)}
    totals = []
    for pkg in PKGS:
        cell = pkg.rnn.ConvLSTMCell(input_shape=(2, 3, 6, 6), num_hidden=4,
                                    prefix="c_")
        out, _ = cell.unroll(3, pkg.sym.Variable("data"), layout="NTC",
                             begin_state=[pkg.sym.Variable("s0"),
                                          pkg.sym.Variable("s1")])
        totals.append(pkg.viz.print_summary(out, shape=shapes))
        arg_shapes = dict(zip(out.list_arguments(),
                              out.infer_shape(**shapes)[0]))
    capsys.readouterr()
    want = sum(int(np.prod(s)) for n, s in arg_shapes.items()
               if n not in shapes)
    assert totals == [0, want] and want == 4 * 4 * (3 + 4) * 9 + 2 * 16


def test_plot_network_needs_graphviz():
    try:
        import graphviz  # noqa: F401
    except ImportError:
        with pytest.raises(mt.MXNetError, match="graphviz"):
            mt.viz.plot_network(_viz_net(mt))
        return
    src = mt.viz.plot_network(_viz_net(mt)).source
    assert src == mx.viz.plot_network(_viz_net(mx)).source


# -- mx.contrib ------------------------------------------------------------

def _contrib_grads(pkg):
    ctx = pkg.cpu()
    x = pkg.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3) / 5,
                     ctx=ctx)
    g = pkg.nd.zeros((2, 3), ctx=ctx)
    pkg.contrib.autograd.mark_variables([x], [g])
    with pkg.contrib.autograd.train_section():
        y = pkg.nd.tanh(x) * x
        with pkg.contrib.autograd.test_section():
            assert not pkg.autograd.is_training()
    pkg.contrib.autograd.compute_gradient([y])
    f = pkg.contrib.autograd.grad_and_loss(lambda a, b: (a * b).sum())
    grads, loss = f(pkg.nd.array([[1.0, 2.0]], ctx=ctx),
                    pkg.nd.array([[3.0, 4.0]], ctx=ctx))
    only = pkg.contrib.autograd.grad(lambda a: (a * a).sum(), argnum=0)(
        pkg.nd.array([2.0, 3.0], ctx=ctx))
    prev = pkg.contrib.autograd.set_is_training(False)
    return (g.asnumpy(), [v.asnumpy() for v in grads], loss.asnumpy(),
            only[0].asnumpy(), prev)


def test_contrib_autograd_matches_jax():
    got, want = _contrib_grads(mt), _contrib_grads(mx)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    assert got[4] == want[4]
    assert mt.contrib.ndarray is mt.nd.contrib
    assert mt.contrib.symbol is mt.sym.contrib


class _Param:
    def __init__(self, metric):
        self.eval_metric = metric


def test_log_metrics_callback_writes_the_jsonl_log(tmp_path, monkeypatch):
    """Without a SummaryWriter the callback writes the JAX package's
    JSONL lines; with a prefix the tags are prefixed."""
    logs = []
    for pkg in PKGS:
        tb = pkg.contrib.tensorboard
        monkeypatch.setattr(tb, "_make_writer", tb._JsonlWriter)
        d = str(tmp_path / pkg.__name__)
        cb = tb.LogMetricsCallback(d, prefix="train")
        m = pkg.metric.Accuracy()
        m.update([pkg.nd.array([0, 1, 1], ctx=pkg.cpu())],
                 [pkg.nd.array([[0.9, 0.1], [0.2, 0.8], [0.7, 0.3]],
                               ctx=pkg.cpu())])
        cb(_Param(m))
        cb(_Param(None))
        cb(_Param(m))
        cb.summary_writer.close()
        logs.append([{k: v for k, v in json.loads(line).items()
                      if k != "wall_time"}
                     for line in open(os.path.join(d, "events.jsonl"))])
    assert logs[0] == logs[1] and len(logs[0]) == 2
    assert logs[0][0]["tag"] == "train-accuracy"


# -- mx.test_utils --------------------------------------------------------------

def _fc():
    x = mt.sym.Variable("x")
    w = mt.sym.Variable("w")
    return mt.sym.FullyConnected(x, weight=w, no_bias=True, num_hidden=3)


def test_test_utils_checks_on_port_symbols():
    mt.test_utils.set_default_context(mt.cpu())
    try:
        assert mt.test_utils.default_context() == mt.cpu()
        rs = np.random.RandomState(0)
        x = rs.randn(2, 4).astype(np.float32)
        w = rs.randn(3, 4).astype(np.float32)
        mt.test_utils.check_symbolic_forward(_fc(), [x, w], [x @ w.T],
                                             rtol=1e-5, atol=1e-6)
        head = rs.randn(2, 3).astype(np.float32)
        mt.test_utils.check_symbolic_backward(
            _fc(), [x, w], [head], {"x": head @ w, "w": head.T @ x},
            rtol=1e-5, atol=1e-6)
        sig = mt.sym.sigmoid(mt.sym.Variable("a") * 2.0)
        mt.test_utils.check_numeric_gradient(
            sig, [rs.randn(3, 2).astype(np.float32)], numeric_eps=1e-2,
            rtol=2e-2)
        out = mt.test_utils.simple_forward(_fc(), x=x, w=w)
        np.testing.assert_allclose(out, x @ w.T, rtol=1e-5)
        res = mt.test_utils.check_consistency(
            _fc(), [{"ctx": mt.cpu(0), "x": (2, 4), "w": (3, 4)},
                    {"ctx": mt.cpu(1), "x": (2, 4), "w": (3, 4)}])
        assert len(res) == 2 and set(res[0][1]) == {"x", "w"}
        with pytest.raises(AssertionError, match="differ"):
            mt.test_utils.assert_almost_equal(np.ones(3), np.zeros(3))
        np.random.seed(4)
        a = mt.test_utils.rand_ndarray((4, 5), "csr", density=0.3)
        np.random.seed(4)
        b = mx.test_utils.rand_ndarray((4, 5), "csr", density=0.3)
        assert a.stype == b.stype == "csr"
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
        rsp = mt.test_utils.rand_ndarray((4, 5), "row_sparse")
        assert rsp.stype == "row_sparse" and rsp.context == mt.cpu()
    finally:
        mt.test_utils.set_default_context(None)


def test_assert_almost_equal_message_equals_jax():
    msgs = []
    for pkg in PKGS:
        with pytest.raises(AssertionError) as ei:
            pkg.test_utils.assert_almost_equal(
                np.array([1.0, 2.0, 3.0]), np.array([1.0, 2.5, 3.0]),
                rtol=1e-3, atol=1e-4, names=("got", "want"))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    assert mt.test_utils.list_gpus() == (
        list(range(torch.cuda.device_count()))
        if torch.cuda.is_available() else [])


# -- DeviceMemoryError -----------------------------------------------------------

def _mlp(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=8, name="fc1")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


_FAKE = ("RESOURCE_EXHAUSTED: Out of memory while trying to allocate "
         "9123456 bytes.")


def _oom_lines(pkg, monkeypatch, fake):
    ex = _mlp(pkg).simple_bind(ctx=pkg.cpu(), grad_req="write",
                               data=(8, 16), softmax_label=(8,))
    ex.forward(is_train=False)
    # the suspect: a buffer larger than any other live one (earlier test
    # modules in this process may keep large buffers alive)
    top = pkg.telemetry.ledger_top(1)
    rows = max(512, top[0]["nbytes"] // (512 * 4) + 1 if top else 512)
    hog = pkg.nd.zeros((rows, 512), ctx=pkg.cpu())

    def boom(*a, **k):
        raise fake

    if pkg is mx:
        monkeypatch.setattr(mx_executor._InstrumentedProgram, "_invoke",
                            boom)
        err_cls = mx_executor.DeviceMemoryError
    else:
        monkeypatch.setattr(ex._prog, "eval_graph", boom)
        err_cls = mt_executor.DeviceMemoryError
    with pytest.raises(err_cls) as ei:
        ex.forward(is_train=False)
    monkeypatch.undo()
    lines = str(ei.value).splitlines()
    assert any("(%d, 512)" % rows in ln for ln in lines), lines
    del hog
    return lines, ei.value


def test_device_memory_error_lines_match_jax(monkeypatch):
    """A synthetic OOM at dispatch: the JAX package's lines in its order
    (the backend's text first, the program's memory card, the ledger's
    totals, the top live buffers with the largest suspect), the original
    error as ``__cause__``, ``serving.DeviceMemoryError`` the executor's;
    ``torch.OutOfMemoryError`` is taken as one too, other errors pass."""
    fake = RuntimeError(_FAKE)
    got, err = _oom_lines(mt, monkeypatch, fake)
    want, _ = _oom_lines(mx, monkeypatch, RuntimeError(_FAKE))
    assert err.__cause__ is fake
    assert mt.serving.DeviceMemoryError is mt_executor.DeviceMemoryError
    assert isinstance(err, mt.MXNetError)

    def sections(lines):
        return [ln.split(":")[0] for ln in lines[1:]
                if not ln.startswith("  ")
                and not ln.startswith("pjrt device stats")]

    assert got[0].startswith("device memory exhausted dispatching program")
    assert got[0].endswith(_FAKE) and want[0].endswith(_FAKE)
    assert sections(got) == sections(want) == [
        "program memory card", "live device-buffer ledger",
        "top live buffers"]
    assert [f.split("=")[0] for f in got[1].split(": ")[1].split()] == \
        [f.split("=")[0] for f in want[1].split(": ")[1].split()]
    oom = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate")
    _, err2 = _oom_lines(mt, monkeypatch, oom)
    assert err2.__cause__ is oom
    ex = _mlp(mt).simple_bind(ctx=mt.cpu(), data=(8, 16),
                              softmax_label=(8,))

    def other(*a, **k):
        raise RuntimeError("some unrelated backend failure")

    monkeypatch.setattr(ex._prog, "eval_graph", other)
    with pytest.raises(RuntimeError, match="unrelated") as ei:
        ex.forward(is_train=False)
    assert not isinstance(ei.value, mt_executor.DeviceMemoryError)


# -- nd.save / load / load_frombuffer across the packages ----------------------

def test_save_files_and_buffers_cross_the_packages(tmp_path):
    rs = np.random.RandomState(0)
    vals = {"a": rs.randn(3, 4).astype(np.float32),
            "b": rs.randint(0, 9, (5,)).astype(np.int32)}
    for src, dst in ((mt, mx), (mx, mt)):
        path = str(tmp_path / ("%s.params" % src.__name__))
        src.nd.save(path, {k: src.nd.array(v, ctx=src.cpu(), dtype=v.dtype)
                           for k, v in vals.items()})
        blob = open(path, "rb").read()
        kw = {"ctx": mt.cpu()} if dst is mt else {}
        for loaded in (dst.nd.load(path, **kw),
                       dst.nd.load_frombuffer(blob, **kw)):
            assert sorted(loaded) == ["a", "b"]
            for k, v in vals.items():
                np.testing.assert_array_equal(loaded[k].asnumpy(), v)
        lst = str(tmp_path / ("%s.list" % src.__name__))
        src.nd.save(lst, [src.nd.array(vals["a"], ctx=src.cpu())])
        got = dst.nd.load_frombuffer(bytearray(open(lst, "rb").read()),
                                     **kw)
        assert isinstance(got, list) and len(got) == 1
        np.testing.assert_array_equal(got[0].asnumpy(), vals["a"])


def test_bfloat16_saves_widened_to_float32(tmp_path):
    x = torch.tensor([[1.5, -2.25], [3.0, 0.0078125]], dtype=torch.bfloat16)
    arr = mt.nd.NDArray(x, mt.cpu())
    path = str(tmp_path / "bf16.params")
    mt.nd.save(path, {"w": arr})
    back = mt.nd.load_frombuffer(open(path, "rb").read(), ctx=mt.cpu())
    assert back["w"].dtype == np.float32
    np.testing.assert_array_equal(back["w"].asnumpy(), x.float().numpy())
    np.testing.assert_array_equal(mx.nd.load(path)["w"].asnumpy(),
                                  x.float().numpy())


# -- mx.libinfo, the profiler's autostart ----------------------------------------

def test_libinfo_paths():
    from mxnet_tpu_torch.kernels import _build
    mt.engine.Engine(num_workers=1)              # builds libengine.so
    assert os.path.isfile(os.path.join(mt.libinfo.find_include_path(),
                                       "engine.cc"))
    libs = mt.libinfo.find_lib_path()
    assert os.path.join(_build.BUILD_DIR, "libengine.so") in libs
    assert all(p.startswith(_build.BUILD_DIR) for p in libs)
    assert mt.libinfo.__version__ == mx.libinfo.__version__


def test_profiler_autostart_at_import(tmp_path):
    """``MXNET_PROFILER_AUTOSTART=1``: tracing runs from the import, and
    the trace is written at exit (``profile.json`` in the working
    directory)."""
    code = ("import mxnet_tpu_torch as mt; "
            "print(mt.profiler._state['running']); "
            "mt.nd.ones((2, 2), ctx=mt.cpu()).asnumpy()")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, MXNET_PROFILER_AUTOSTART="1",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True"
    trace = json.load(open(tmp_path / "profile.json"))
    assert trace["traceEvents"]
    assert mt.profiler.get_env is mt.base.get_env
