"""Dense prediction and the Module toolbox of the port against the JAX
package's, on the CPU.

The model is ``chip_smoke.py``'s FCN-16s on VGG-16 (the pattern of
``examples/fcn-xs/fcn_xs.py``: Deconvolution, Crop, the per-pixel
``SoftmaxOutput`` over VOC labels with 255 void) at a narrow
size: VGG-16's layout with widths cut by 16 (4, 8, 16, 32, 32; ``fc6``
and ``fc7`` 64), 64x64 inputs, 5 classes plus 255, batch 2. Its crops
are real windows (6 -> 4 at offset 1, 80 -> 64 at offset 8). Dropout is
0 where the packages are compared (their generators differ) and 0.5
where the port is held to itself.

- ``Module.fit`` for 3 batches (SGD, momentum 0.9, wd 5e-4) from the
  same weights: every parameter within 1e-5 of its tensor's largest
  |value| of the JAX package's (measured: 8.0e-7).
- Preemption (a signal in ``batch_end_callback``) and ``resume=True``:
  parameters and optimizer states bit-equal to an uninterrupted run,
  the signal handlers in force before ``fit`` restored after it; a
  checkpoint of either package resumes in the other (1e-5).
- The divergence sentinel's three policies under a ``dispatch:nan``
  fault; ``Monitor``'s statistics (1e-5 relative); SequentialModule +
  PythonLossModule; SymbolBlock; ``autograd.get_symbol``.
"""
import importlib.util
import os
import pickle
import signal
import threading

import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke_fcn", os.path.join(ROOT, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

CPU = mt.cpu()
CFG = cs._FCN[True]
TOL = 1e-5


def _ctx(pkg):
    return CPU if pkg is mt else mx.cpu()


def _sym(pkg, p=0.0, head=True):
    return cs.fcn16s_symbol(pkg, CFG["classes"], CFG["widths"], CFG["fc"],
                            p=p, head=head)


def _data(n=6):
    return cs.fcn_data(cs._FCN_SEED, n, CFG["hw"], CFG["classes"])


@pytest.fixture(scope="module")
def start():
    """The JAX package's FCN initializer, drawn once from one numpy seed:
    the weights every run starts from."""
    x, y = _data(2)
    np.random.seed(0)
    mod = mx.mod.Module(_sym(mx))
    mod.bind([("data", x.shape)], [("softmax_label", y.shape)])
    mod.init_params(cs.fcn_init(mx))
    arg, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in arg.items()}


@pytest.fixture(autouse=True)
def _clean():
    for pkg in (mt, mx):
        pkg.telemetry.enable()
        pkg.telemetry.reset()
    handlers = [signal.getsignal(s) for s in (signal.SIGTERM,
                                              signal.SIGINT)]
    yield
    mt.faults.clear()
    mt.flight.configure(None)
    mt.flight.uninstall()
    assert [signal.getsignal(s) for s in (signal.SIGTERM,
                                          signal.SIGINT)] == handlers


def _fit(pkg, start, num_epoch=1, mod=None, p=0.0, **kw):
    x, y = _data()
    ctx = _ctx(pkg)
    it = pkg.io.NDArrayIter(x, y, batch_size=CFG["batch"], shuffle=False)
    if mod is None:
        mod = pkg.mod.Module(_sym(pkg, p=p), context=ctx)
    arg = {k: pkg.nd.array(v, ctx=ctx) for k, v in start.items()}
    mod.fit(it, optimizer="sgd", optimizer_params=cs._FCN_OPT,
            arg_params=arg, initializer=cs.fcn_init(pkg),
            num_epoch=num_epoch, eval_metric="loss", **kw)
    return mod


def _params(mod):
    arg, aux = mod.get_params()
    return {k: v.asnumpy() for k, v in arg.items()}


def _states(mod):
    upd = mod._updater if hasattr(mod, "_updater") else None
    return pickle.loads(upd.get_states())


def _worst(got, want):
    return max(float(np.abs(got[k] - want[k]).max())
               / max(float(np.abs(want[k]).max()), 1e-30) for k in want)


def test_fcn_shapes_and_parameter_count():
    """The full-width FCN-16s: 134,815,994 parameters; the crops take
    26 -> 24 at offset 1 and 400 -> 384 at offset 8."""
    sym = cs.fcn16s_symbol(mt, 21)
    shapes = dict(data=(8, 3, 384, 384), softmax_label=(8, 384, 384))
    arg, out, _ = sym.infer_shape(**shapes)
    n = sum(int(np.prod(s)) for name, s in zip(sym.list_arguments(), arg)
            if name not in shapes)
    assert n == cs._FCN[False]["params"] == 134815994
    assert out == [(8, 21, 384, 384)]
    ints = sym.get_internals()
    for name, hw in (("upscore2_output", 26), ("score_pool4c_output", 24),
                     ("upscore16_output", 400), ("score_output", 384)):
        assert ints[name].infer_shape(data=shapes["data"])[1] == \
            [(8, 21, hw, hw)]
    jsym = cs.fcn16s_symbol(mx, 21)
    assert jsym.list_arguments() == sym.list_arguments()
    assert jsym.infer_shape(**shapes) == (
        [tuple(s) for s in arg], out, [])


def test_fcn_data_marks_void_bands():
    x, y = _data(4)
    labels = set(np.unique(y).tolist())
    assert labels <= {0.0, 1.0, 2.0, 3.0, 4.0, 255.0} and 255.0 in labels
    assert x.shape == (4, 3, 64, 64) and y.shape == (4, 64, 64)


def test_fcn_fit_matches_jax(start):
    jmod = _fit(mx, start)
    tmod = _fit(mt, start)
    jp, tp = _params(jmod), _params(tmod)
    assert _worst(tp, jp) <= TOL, _worst(tp, jp)
    moved = _worst({k: jp[k] for k in start}, start)
    assert moved > 1e-4      # the three steps moved the weights


def _preempting_callback(at_epoch, at_batch, mgr):
    """Send SIGTERM (the armed handler sets the flag) after batch
    ``at_batch`` of epoch ``at_epoch``; off the main thread, where
    ``fit`` cannot arm handlers, set the flag directly."""
    def cb(param):
        if (param.epoch, param.nbatch) == (at_epoch, at_batch):
            if threading.current_thread() is threading.main_thread():
                os.kill(os.getpid(), signal.SIGTERM)
            else:
                mgr.request_preempt("SIGTERM")
    return cb


def test_fcn_preempt_and_resume_bit_equal(start, tmp_path):
    """Dropout 0.5 draws from the port's CPU generator: the resumed run
    must restore it to finish bit-equal."""
    mt.random.seed(11)
    ref = _fit(mt, start, num_epoch=2, p=0.5,
               checkpoint=mt.CheckpointManager(str(tmp_path / "a"), 2))
    mt.random.seed(11)
    mgr = mt.CheckpointManager(str(tmp_path / "b"), keep_last=2)
    with pytest.raises(mt.checkpoint.TrainingPreempted) as exc:
        _fit(mt, start, num_epoch=2, p=0.5, checkpoint=mgr,
             batch_end_callback=_preempting_callback(1, 1, mgr))
    assert (exc.value.epoch, exc.value.nbatch) == (1, 2)
    assert mgr.latest()["nbatch"] == 2
    mt.random.seed(99)          # the checkpoint's state must win
    resumed = _fit(mt, start, num_epoch=2, p=0.5, resume=True,
                   checkpoint=mt.CheckpointManager(str(tmp_path / "b"), 2))
    a, b = _params(ref), _params(resumed)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    sa, sb = _states(ref), _states(resumed)
    assert sorted(sa) == sorted(sb)
    assert all(np.array_equal(sa[k], sb[k]) for k in sa)
    assert resumed._optimizer._index_update_count == \
        ref._optimizer._index_update_count
    counters = mt.telemetry.counters()
    assert counters["training.preempted"] == 1
    assert counters["checkpoint.resume"] == 1
    # keep_last=2: the epoch-1 and epoch-2 checkpoints, the mid-epoch
    # save (epoch 1) replaced by the finished epoch's
    assert mt.CheckpointManager(str(tmp_path / "b")).epochs() == [1, 2]


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")])
def test_checkpoint_resumes_in_the_other_package(start, tmp_path, first,
                                                 second):
    pkgs = {"jax": mx, "port": mt}
    p1, p2 = pkgs[first], pkgs[second]
    prefix = str(tmp_path / "ck")
    _fit(p1, start, num_epoch=1, checkpoint=p1.CheckpointManager(prefix))
    resumed = _fit(p2, start, num_epoch=2, resume=True,
                   checkpoint=p2.CheckpointManager(prefix))
    ref = _fit(p1, start, num_epoch=2)
    assert _worst(_params(resumed), _params(ref)) <= TOL


@pytest.mark.parametrize("policy", ["halt", "skip", "rollback"])
def test_divergence_policies(start, tmp_path, policy):
    """``dispatch:nan`` poisons the outputs of the 5th train step (epoch
    1, batch 2), after epoch 0's checkpoint: halt raises, skip counts
    and goes on, rollback restores the checkpoint and finishes."""
    mt.faults.configure("dispatch:nan:n=5")
    mgr = mt.CheckpointManager(str(tmp_path / "d"), keep_last=2)
    kw = dict(num_epoch=2, checkpoint=mgr, divergence_check_every=1,
              divergence_policy=policy)
    if policy == "halt":
        with pytest.raises(mt.checkpoint.DivergenceError,
                           match="epoch 1 batch 1"):
            _fit(mt, start, **kw)
    else:
        mod = _fit(mt, start, **kw)
        assert all(np.isfinite(v).all() for v in _params(mod).values())
        assert mod.finite_check()
    c = mt.telemetry.counters()
    assert c["divergence.detected"] == 1
    assert c.get("divergence.skipped", 0) == (policy == "skip")
    assert c.get("divergence.rollback", 0) == (policy == "rollback")
    assert mt.faults.counts()["dispatch"]["fired"] == 1


def _monitor_rows(pkg, start):
    x, y = _data(2)
    ctx = _ctx(pkg)
    mod = pkg.mod.Module(_sym(pkg), context=ctx)
    mod.bind([("data", x.shape)], [("softmax_label", y.shape)])
    mod.init_params(arg_params={k: pkg.nd.array(v, ctx=ctx)
                                for k, v in start.items()})
    mon = pkg.mon.Monitor(1, pattern=".*upscore.*", sort=True)
    mod.install_monitor(mon)
    mon.tic()
    mod.forward(pkg.io.DataBatch([pkg.nd.array(x, ctx=ctx)],
                                 [pkg.nd.array(y, ctx=ctx)]), is_train=True)
    return mon.toc()


def test_monitor_stats_match_jax(start):
    jrows, trows = _monitor_rows(mx, start), _monitor_rows(mt, start)
    assert [r[1] for r in trows] == [r[1] for r in jrows] == [
        "upscore16_output", "upscore16_weight", "upscore2_output",
        "upscore2_weight"]
    for (_, _, tv), (_, _, jv) in zip(trows, jrows):
        np.testing.assert_allclose(float(tv), float(jv), rtol=TOL)


def test_fit_with_monitor_phase_splits_and_taps_every_batch(start):
    """``fit(monitor=)`` falls back with the ``monitor`` code (counted),
    and the port taps the op outputs of the forward its
    ``forward_backward`` runs (the JAX package's taps only
    ``forward``)."""
    class Keep(mt.mon.Monitor):
        rows = []

        def toc_print(self):
            self.rows.extend(self.toc())
    mon = Keep(1, pattern=".*upscore16_output")
    mod = _fit(mt, start, monitor=mon)
    assert [r[1] for r in Keep.rows] == ["upscore16_output"] * 3
    assert mod._fused_fallback_reason.code == "monitor"
    assert mt.telemetry.counters()["fused_fallback.monitor"] == 3


def _seq_module(pkg, python_loss, start):
    ctx = _ctx(pkg)
    hinge, feature, head = cs.seq_module_parts(pkg, ctx)
    mod = pkg.mod.SequentialModule()
    mod.add(feature())
    if python_loss:
        mod.add(pkg.mod.PythonLossModule(grad_func=hinge), take_labels=True,
                auto_wiring=True)
    else:
        mod.add(head(), take_labels=True, auto_wiring=True)
    it = cs.seq_module_data(pkg)
    arg = {k: pkg.nd.array(v, ctx=ctx) for k, v in start.items()}
    mod.fit(it, optimizer_params={"learning_rate": 0.1 if python_loss
                                  else 0.02},
            arg_params=arg, initializer=pkg.init.Xavier(), num_epoch=1,
            eval_metric="acc")
    return mod


@pytest.mark.parametrize("python_loss", [False, True],
                         ids=["module_head", "python_loss"])
def test_sequential_module_matches_jax(python_loss):
    """examples/module/seq_module.py's chains (auto_wiring, take_labels,
    the host hinge gradient through PythonLossModule) for one epoch
    from the same weights; parameters read back and loaded per stage
    (``weights.module_to_numpy``/``load_into_module``)."""
    np.random.seed(3)
    start = {"fc1_weight": np.random.uniform(-0.1, 0.1, (128, 64)),
             "fc1_bias": np.zeros(128),
             "fc2_weight": np.random.uniform(-0.1, 0.1, (64, 128)),
             "fc2_bias": np.zeros(64),
             "fc3_weight": np.random.uniform(-0.1, 0.1, (10, 64)),
             "fc3_bias": np.zeros(10)}
    start = {k: v.astype(np.float32) for k, v in start.items()}
    if python_loss:
        start = {k: v for k, v in start.items() if k.startswith("fc1")}
    jmod = _seq_module(mx, python_loss, start)
    tmod = _seq_module(mt, python_loss, start)
    jp, tp = _params(jmod), _params(tmod)
    assert sorted(tp) == sorted(start)
    assert _worst(tp, jp) <= TOL, _worst(tp, jp)
    arg, aux, states = mt.weights.module_to_numpy(tmod)
    assert len(states) == (1 if python_loss else 2)
    fresh = mt.mod.SequentialModule()
    _, feature, head = cs.seq_module_parts(mt, CPU)
    fresh.add(feature())
    if not python_loss:
        fresh.add(head(), take_labels=True, auto_wiring=True)
        fresh.bind([("data", (64, 64))], [("softmax_label", (64,))])
    else:
        fresh.bind([("data", (64, 64))])
    fresh.init_params()
    fresh.init_optimizer()
    mt.weights.load_into_module(fresh, arg, aux, opt_states=states)
    assert _worst(_params(fresh), tp) == 0.0


def test_symbol_block_runs_the_module_graph(start):
    """``gluon.SymbolBlock`` over the FCN without its loss head takes the
    Module's parameters (``weights.load_into_block``); its forward,
    hybridized or not, is bit-equal to a Module's forward of the same
    graph, and within 1e-5 of the JAX package's SymbolBlock."""
    x, _ = _data(2)
    outs = {}
    for pkg in (mx, mt):
        ctx = _ctx(pkg)
        score = _sym(pkg, head=False)
        mod = pkg.mod.Module(score, label_names=[], context=ctx)
        mod.bind([("data", x.shape)], for_training=False)
        mod.init_params(arg_params={k: pkg.nd.array(v, ctx=ctx)
                                    for k, v in start.items()})
        mod.forward(pkg.io.DataBatch([pkg.nd.array(x, ctx=ctx)], None),
                    is_train=False)
        mod_out = mod.get_outputs()[0].asnumpy()
        blk = pkg.gluon.SymbolBlock(score, pkg.sym.var("data"))
        if pkg is mt:
            mt.weights.load_into_block(blk, start, ctx=ctx)
        else:
            for k, p in blk.collect_params().items():
                p.set_data(mx.nd.array(start[k]))
        if pkg is mx:
            # calling the JAX package's SymbolBlock raises (HybridBlock's
            # __call__ reaches its hybrid_forward); its forward runs
            outs[pkg] = (blk.forward(mx.nd.array(x)).asnumpy(),)
            continue
        eager = blk(pkg.nd.array(x, ctx=ctx)).asnumpy()
        blk.hybridize()
        hyb = blk(pkg.nd.array(x, ctx=ctx)).asnumpy()
        outs[pkg] = (mod_out, eager, hyb)
    want, eager, hyb = outs[mt]
    np.testing.assert_array_equal(eager, want)
    np.testing.assert_array_equal(hyb, want)
    assert _worst({"s": want}, {"s": outs[mx][0]}) <= TOL
    with pytest.raises(mx.MXNetError, match="stored symbol"):
        blk = mx.gluon.SymbolBlock(_sym(mx, head=False), mx.sym.var("data"))
        blk(mx.nd.array(x))


def test_symbol_block_deferred_init_and_gradients(start):
    """Parameter shapes defer to the first call (``infer_shape_partial``);
    under ``autograd.record`` gradients reach the block's parameters."""
    x, _ = _data(2)
    blk = mt.gluon.SymbolBlock(_sym(mt, head=False), mt.sym.var("data"))
    blk.collect_params().initialize(mt.init.Xavier(), ctx=CPU)
    xin = mt.nd.array(x, ctx=CPU)
    with mt.autograd.record():
        out = blk(xin)
        loss = (out * out).sum()
    loss.backward()
    p = blk.collect_params()
    assert p["fc6_weight"].shape == start["fc6_weight"].shape
    assert float(np.abs(p["upscore16_weight"].grad().asnumpy()).max()) > 0


def test_get_symbol_matches_jax(start):
    """``autograd.get_symbol`` rebuilds the recorded Deconvolution/Crop
    chain with the JAX package's names (var, const and op counters)."""
    x = _data(1)[0][:, :, :8, :8]
    jsons = []
    for pkg in (mx, mt):
        ctx = _ctx(pkg)
        d = pkg.nd.array(x, ctx=ctx)
        w = pkg.nd.array(start["upscore2_weight"][:3, :3], ctx=ctx)
        d.attach_grad()
        w.attach_grad()
        with pkg.autograd.record():
            up = pkg.nd.Deconvolution(d, w, kernel=(4, 4), stride=(2, 2),
                                      num_filter=3)
            out = pkg.nd.Crop(up, d, offset=(1, 1), num_args=2) + d
            out = pkg.nd.LeakyReLU(out, slope=0.2)
        jsons.append(pkg.autograd.get_symbol(out).tojson())
    assert jsons[0] == jsons[1]
    with pytest.raises(mt.MXNetError, match="recorded"):
        mt.autograd.get_symbol(mt.nd.array(x, ctx=CPU))


def test_bucketing_module_monitor_and_states():
    """``BucketingModule.install_monitor`` taps the bound buckets and
    each bucket bound later; ``get_states``/``set_states`` delegate to
    the current bucket (none here, as in the JAX package)."""
    def sym_gen(key):
        data = mt.sym.var("data")
        out = mt.sym.FullyConnected(data, num_hidden=3, name="fc")
        return mt.sym.LinearRegressionOutput(out, name="lro"), ("data",), \
            ("lro_label",)
    mod = mt.mod.BucketingModule(sym_gen, default_bucket_key=4,
                                 context=CPU)
    mod.bind([("data", (2, 4))], [("lro_label", (2, 3))])
    mod.init_params()
    mon = mt.mon.Monitor(1, pattern="fc_output")
    mod.install_monitor(mon)
    for key in (4, 6):
        mod.switch_bucket(key, [("data", (2, 4))], [("lro_label", (2, 3))])
        mon.tic()
        mod.forward(mt.io.DataBatch(
            [mt.nd.ones((2, 4), ctx=CPU)], [mt.nd.ones((2, 3), ctx=CPU)],
            bucket_key=key, provide_data=[("data", (2, 4))],
            provide_label=[("lro_label", (2, 3))]))
        assert [r[1] for r in mon.toc()] == ["fc_output"]
    assert mod.get_states() == []
    mod.set_states()
