"""``Module(partition_rules=, mesh_axes=)`` of the PyTorch port: a
rule-sharded ``dp x mp`` mesh over eight CPU Contexts (one thread a
member), against itself, the port's one device and ``ReplicaSet`` path,
and the JAX package's mesh ``Module`` on its 8 virtual CPU devices.

The MLP of ``tests/test_partition.py`` (both layers' weights and biases
sharded over ``mp``) trains 6 batches of 32 with SGD (lr 0.05, momentum
0.9, wd 1e-4) from the same carried weights:

- the fused step is bit-equal to the phase-split path on the same mesh
  (one arithmetic), counts one ``train_step`` dispatch a batch a member,
  and is within rtol 1e-5 / atol 1e-6 of one device and of the JAX mesh
  module (the ``dp`` sum reassociates);
- the members' committed parameter bytes (the ledger's ``mesh(8dev)``
  key) are 0.2-0.35 of the replicated layout's at ``mp`` 4;
- ``mesh_axes={"dp": -1}`` without rules is bit-equal to the several-
  Context ``ReplicaSet`` path;
- checkpoints restore across mesh shapes (``dp``-only <-> ``dp x mp``,
  mesh <-> one device) and across the two packages, with the layout in
  the meta record; loaded optimizer states land on the weight's shards;
  ``weights.load_into_module`` carries a JAX mesh module's whole
  parameters and momenta into a port mesh of another shape;
- a narrow ``resnet18_v1`` (BatchNorm over the ``dp`` line) at step 1
  against one device and the JAX mesh module (rtol 1e-4, atol 1e-5:
  one step, so no ReLU unit has drifted across zero).
"""
import contextlib
import gc
import os
import threading

import numpy as np
import pytest

import jax
from jax.sharding import PartitionSpec as JP

import mxnet_tpu as mx
from mxnet_tpu.parallel import PartitionRules as JRules

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401
import mxnet_tpu_torch.executor as t_executor
from mxnet_tpu_torch.io import DataBatch, DataDesc
from mxnet_tpu_torch.parallel import PartitionRules, P

import torch_mesh_worker as W

N_DEV = 8
needs_mesh = pytest.mark.skipif(
    jax.device_count() < N_DEV, reason="needs the 8-device virtual CPU mesh")
RULES = PartitionRules(W.MODULE_RULES)
J_RULES = JRules([(p, JP(*s)) for p, s in W.MODULE_RULES])
TOL = dict(rtol=1e-5, atol=1e-6)


@contextlib.contextmanager
def _pin(fused):
    old = os.environ.get("MXNET_MODULE_FUSED_STEP")
    os.environ["MXNET_MODULE_FUSED_STEP"] = "1" if fused else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("MXNET_MODULE_FUSED_STEP", None)
        else:
            os.environ["MXNET_MODULE_FUSED_STEP"] = old


def _ctxs(pkg=mt):
    return [pkg.cpu(i) for i in range(N_DEV)]


def _make(ctx, pkg=mt, **kw):
    mod = pkg.mod.Module(W.mlp(pkg.sym), context=ctx, **kw)
    mod.bind(data_shapes=[DataDesc("data", (32, 16))] if pkg is mt
             else [mx.io.DataDesc("data", (32, 16))],
             label_shapes=[("softmax_label", (32,))])
    mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                for k, v in W.module_init().items()})
    mod.init_optimizer(kvstore="device", optimizer="sgd",
                       optimizer_params=W.MODULE_OPT)
    return mod


def _batch(pkg, x, y):
    return pkg.io.DataBatch(data=[pkg.nd.array(x, ctx=pkg.cpu())],
                            label=[pkg.nd.array(y, ctx=pkg.cpu())])


def _steps(mod, batches, fused, pkg=mt):
    metric = pkg.metric.Accuracy()
    with _pin(fused):
        for x, y in batches:
            b = _batch(pkg, x, y)
            ok = mod._fused_batch_step(b, metric)
            if fused:
                assert ok, mod._fused_fallback_reason
            if not ok:
                mod.forward_backward(b)
                mod.update()
                mod.update_metric(metric, b.label)
    return metric.get()[1]


def _params(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _train(fused, ctx, pkg=mt, n=6, **kw):
    counts, lock = {}, threading.Lock()

    def hook(kind):
        with lock:
            counts[kind] = counts.get(kind, 0) + 1
    with _pin(fused):
        mod = _make(ctx, pkg, **kw)
    prev, t_executor.dispatch_hook = t_executor.dispatch_hook, hook
    try:
        acc = _steps(mod, W.module_batches(n), fused, pkg)
    finally:
        t_executor.dispatch_hook = prev
    return _params(mod), counts, mod, acc


def _close(got, want, **tol):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                   **(tol or TOL))


@needs_mesh
@pytest.mark.parametrize("axes", [{"dp": 2, "mp": 4}, {"dp": 4, "mp": 2}])
def test_fused_dpxmp_matches_phase_split_one_device_and_jax(axes):
    kw = dict(partition_rules=RULES, mesh_axes=axes)
    fused, counts, mod, acc = _train(True, _ctxs(), **kw)
    assert counts == {"train_step": 6 * N_DEV}, counts
    mp = axes["mp"]
    assert mod._exec.arg_dict["fc1_weight"].shape == (64 // mp, 16)
    split, _, _, acc_split = _train(False, _ctxs(), **kw)
    for k in fused:
        assert np.array_equal(fused[k], split[k]), k
    one, _, _, acc_one = _train(True, mt.cpu())
    _close(fused, one)
    assert acc == acc_split == acc_one
    with _pin(True):
        jmod = _make(_ctxs(mx), mx, partition_rules=J_RULES, mesh_axes=axes)
    _steps(jmod, W.module_batches(6), True, mx)
    _close(fused, _params(jmod))
    assert mod.partition_summary() == jmod.partition_summary()


@needs_mesh
def test_committed_param_bytes_per_member_shrink_by_mp():
    tel = mt.telemetry
    was = tel.enabled()
    tel.enable()
    try:
        def charged():
            gc.collect()
            led = tel.ledger().get("mesh(%ddev)" % N_DEV, {})
            return led.get("by_kind", {}).get("param", 0)

        def param_bytes(**kw):
            before = charged()
            mod = _make(_ctxs(), **kw)
            n = charged() - before
            held = sum(ex.arg_dict[k]._data.nbytes for ex in mod._execs
                       for k in W.module_init())
            assert n == held
            return n
        repl = param_bytes(mesh_axes={"dp": -1})
        sharded = param_bytes(partition_rules=RULES,
                              mesh_axes={"dp": 2, "mp": 4})
        assert 0.2 <= sharded / repl <= 0.35, (sharded, repl)
    finally:
        tel.reset()
        if not was:
            tel.disable()


def test_mesh_axes_without_rules_bit_equal_to_replica_set():
    ctxs = _ctxs()[:4]
    mesh, counts, mod, _ = _train(True, ctxs, mesh_axes={"dp": -1})
    assert mod.partition_summary()["mesh_axes"] == {"dp": 4}
    assert mod._replicas is None
    repl, _, rmod, _ = _train(True, ctxs)
    assert rmod._replicas is not None
    for k in mesh:
        assert np.array_equal(mesh[k], repl[k]), k


def test_one_device_mesh_is_the_plain_path():
    mod = _make([mt.cpu()], partition_rules=RULES,
                mesh_axes={"dp": 1, "mp": -1})
    assert mod.partition_summary() is None and mod._layout is None


@needs_mesh
def test_checkpoint_restores_across_mesh_shapes(tmp_path):
    bs = W.module_batches(6)
    dp_only = dict(mesh_axes={"dp": -1})
    dpxmp = dict(partition_rules=RULES, mesh_axes={"dp": 2, "mp": 4})
    oracle = _make(_ctxs(), **dp_only)
    _steps(oracle, bs, True)
    want = _params(oracle)
    for i, (first, then) in enumerate((
            (dict(ctx=_ctxs(), **dp_only), dict(ctx=_ctxs(), **dpxmp)),
            (dict(ctx=_ctxs(), **dpxmp), dict(ctx=_ctxs(), **dp_only)),
            (dict(ctx=_ctxs(), **dpxmp), dict(ctx=mt.cpu())),
            (dict(ctx=mt.cpu()), dict(ctx=_ctxs(), **dpxmp)))):
        a = _make(**first)
        _steps(a, bs[:3], True)
        mgr = mt.CheckpointManager(str(tmp_path / ("m%d" % i)))
        meta = mgr.save(a, 0)
        assert meta.get("layout") == a.partition_summary()
        b = _make(**then)
        mgr.restore(b)
        saved, restored = _params(a), _params(b)
        for k in saved:
            assert np.array_equal(saved[k], restored[k]), k
        _steps(b, bs[3:], True)
        _close(_params(b), want)


@needs_mesh
def test_checkpoints_across_packages(tmp_path):
    """JAX mesh module: 3 batches, save, 3 more. The port's mesh restores
    the JAX checkpoint (params and momenta) and runs the last 3; the JAX
    mesh restores the port's checkpoint after its first 3 and runs the
    last 3. Both ends agree with the JAX run."""
    bs = W.module_batches(6)
    axes = {"dp": 2, "mp": 4}
    with _pin(True):
        jmod = _make(_ctxs(mx), mx, partition_rules=J_RULES, mesh_axes=axes)
        _steps(jmod, bs[:3], True, mx)
        jmgr = mx.CheckpointManager(str(tmp_path / "jax"))
        jmgr.save(jmod, 0)
        _steps(jmod, bs[3:], True, mx)
        want = _params(jmod)

        port = _make(_ctxs(), partition_rules=RULES, mesh_axes=axes)
        mt.CheckpointManager(str(tmp_path / "jax")).restore(port)
        _steps(port, bs[3:], True)
        _close(_params(port), want)

        first = _make(_ctxs(), partition_rules=RULES, mesh_axes=axes)
        _steps(first, bs[:3], True)
        meta = mt.CheckpointManager(str(tmp_path / "port")).save(first, 0)
        assert meta["layout"]["mesh_axes"] == axes
        jback = _make(_ctxs(mx), mx, partition_rules=J_RULES, mesh_axes=axes)
        mx.CheckpointManager(str(tmp_path / "port")).restore(jback)
        _steps(jback, bs[3:], True, mx)
        _close(_params(jback), want)


def test_loaded_states_land_on_the_weight_shards(tmp_path):
    ctxs = _ctxs()[:4]
    kw = dict(partition_rules=RULES, mesh_axes={"dp": 2, "mp": 2})
    bs = W.module_batches(4)
    a = _make(ctxs, **kw)
    _steps(a, bs[:2], True)
    states = str(tmp_path / "opt.states")
    a.save_optimizer_states(states)
    b = _make(ctxs, **kw)
    b.set_params(*a.get_params())
    b.load_optimizer_states(states)
    _steps(b, bs[2:], True)
    i = b._param_names.index("fc1_weight")
    for ex, upd in zip(b._execs, b._updater.members):
        assert upd.states[i].shape == ex.arg_dict["fc1_weight"].shape \
            == (32, 16)
    _steps(a, bs[2:], True)
    pa, pb = _params(a), _params(b)
    for k in pa:
        assert np.array_equal(pa[k], pb[k]), k


@needs_mesh
def test_weights_carry_a_jax_mesh_module_across():
    """``weights.load_into_module`` takes a JAX mesh module's whole
    parameters, momenta and update counts into a port mesh of another
    shape (the port cuts its shards); both go on for 3 batches and
    ``module_to_numpy`` reads the port's back whole."""
    import pickle
    bs = W.module_batches(6)
    with _pin(True):
        jmod = _make(_ctxs(mx), mx, partition_rules=J_RULES,
                     mesh_axes={"dp": 2, "mp": 4})
        _steps(jmod, bs[:3], True, mx)
        jarg, jaux = jmod.get_params()
        jupd = jmod._kvstore._updater if jmod._update_on_kvstore \
            else jmod._updater
        port = _make(_ctxs(), partition_rules=RULES,
                     mesh_axes={"dp": 4, "mp": 2})
        mt.weights.load_into_module(
            port, jarg, jaux, opt_states=pickle.loads(jupd.get_states()),
            update_counts=jmod._optimizer._index_update_count)
        _steps(jmod, bs[3:], True, mx)
        _steps(port, bs[3:], True)
    arg, _, states = mt.weights.module_to_numpy(port)
    _close(arg, _params(jmod))
    i = port._param_names.index("fc1_weight")
    assert states[i].shape == (64, 16)
    assert port._updater.states[i].shape == (32, 16)


def test_finite_check_reads_every_member():
    mod = _make(_ctxs()[:4], partition_rules=RULES,
                mesh_axes={"dp": 2, "mp": 2})
    _steps(mod, W.module_batches(1), True)
    assert mod.finite_check()
    mod._execs[3].arg_dict["fc2_weight"]._data[0, 0] = float("nan")
    assert not mod.finite_check()


def test_batch_divisibility_names_the_dp_axis():
    mod = mt.mod.Module(W.mlp(mt.sym), context=_ctxs(),
                        partition_rules=RULES, mesh_axes={"dp": 2, "mp": 4})
    mod.bind(data_shapes=[("data", (6, 16))],
             label_shapes=[("softmax_label", (6,))])
    mod2 = mt.mod.Module(W.mlp(mt.sym), context=_ctxs(),
                         partition_rules=RULES, mesh_axes={"dp": 2, "mp": 4})
    with pytest.raises(mt.MXNetError) as e:
        mod2.bind(data_shapes=[("data", (7, 16))],
                  label_shapes=[("softmax_label", (7,))])
    assert "'dp' mesh axis" in str(e.value) and "size 2" in str(e.value)
    with pytest.raises(mt.MXNetError, match="dist"):
        mod.init_params()
        mod.init_optimizer(kvstore="dist_sync")


# -- BatchNorm over the dp line: a narrow resnet18_v1 ---------------------------

RES_B, RES_HW = 8, 16


def _resnet_symbol(pkg):
    from importlib import import_module
    res = import_module(pkg.__name__ + ".gluon.model_zoo.vision.resnet")
    with pkg.name.NameManager():
        net = res.ResNetV1(res.BasicBlockV1, [2, 2, 2, 2],
                           [8, 8, 16, 32, 64], classes=10, thumbnail=True)
        out = net(pkg.sym.Variable("data"))
        return pkg.sym.SoftmaxOutput(out, pkg.sym.Variable("softmax_label"),
                                     name="softmax")


def _bench_rules(pkg_rules, spec):
    # bench.py's ResNet rules (_mp_bench_rules)
    return pkg_rules([(r"(conv\d*|fc\d*)_weight$", spec("mp")),
                      (r"weight$", spec("mp")),
                      (r"(gamma|beta|bias)$", spec("mp"))])


def _resnet_step1(pkg, ctx, arg, aux, x, y, **kw):
    mod = pkg.mod.Module(_resnet_symbol(pkg), context=ctx, **kw)
    mod.bind(data_shapes=[("data", (RES_B, 3, RES_HW, RES_HW))],
             label_shapes=[("softmax_label", (RES_B,))])
    mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                for k, v in arg.items()},
                    aux_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                for k, v in aux.items()})
    mod.init_optimizer(kvstore="device", optimizer="sgd",
                       optimizer_params=W.MODULE_OPT)
    with _pin(True):
        assert mod._fused_batch_step(_batch(pkg, x, y))
    arg1, aux1 = mod.get_params()
    return ({k: v.asnumpy() for k, v in arg1.items()},
            {k: v.asnumpy() for k, v in aux1.items()})


@needs_mesh
def test_resnet18_batchnorm_over_dp_step1():
    probe = mt.mod.Module(_resnet_symbol(mt), context=mt.cpu())
    probe.bind(data_shapes=[("data", (RES_B, 3, RES_HW, RES_HW))],
               label_shapes=[("softmax_label", (RES_B,))])
    probe.init_params(mt.init.Xavier())
    arg, aux = (({k: v.asnumpy() for k, v in d.items()})
                for d in probe.get_params())
    rs = np.random.RandomState(2)
    aux = {k: (rs.uniform(0.5, 1.5, v.shape) if "var" in k
               else rs.uniform(-.1, .1, v.shape)).astype(np.float32)
           for k, v in aux.items()}
    x = rs.uniform(-1, 1, (RES_B, 3, RES_HW, RES_HW)).astype(np.float32)
    y = rs.randint(0, 10, RES_B).astype(np.float32)
    axes = {"dp": 2, "mp": 2}
    mesh = _resnet_step1(mt, _ctxs()[:4], arg, aux, x, y,
                         partition_rules=_bench_rules(PartitionRules, P),
                         mesh_axes=axes)
    one = _resnet_step1(mt, mt.cpu(), arg, aux, x, y)
    jmesh = _resnet_step1(mx, _ctxs(mx)[:4], arg, aux, x, y,
                          partition_rules=_bench_rules(JRules, JP),
                          mesh_axes=axes)
    for got, want in ((mesh, one), (mesh, jmesh)):
        for g, w in zip(got, want):
            _close(g, w, rtol=1e-4, atol=1e-5)
