"""``Module`` over several contexts in one process, against the JAX
package's data-parallel Module on as many virtual CPU devices (the
conftest makes 8) and against one context at the same global batch.

``tests/test_module_dp.py``'s MLP and toy clusters, batch 64, SGD lr 0.1
momentum 0.9, 4 batches through ``forward_backward``/``update`` with the
default ``local`` store (the contexts' gradients summed by its push of
shard lists), from the same numpy parameters in both packages: losses
within 1e-5 relative and every parameter within 1e-5 of its tensor's
largest magnitude, against the JAX package's n-device Module and the
port's one-context Module (4 steps of summing in other orders: 5.5e-6
absolute at worst on weights up to 2.9). The
fused step over the contexts equals the phase-split path bit for bit; a
batch that does not divide raises; duplicate contexts raise;
``FUSED_FALLBACK_CODES`` is the JAX package's set; a compressed
in-process store phase-splits under ``kvstore_compression``;
``DataParallelExecutorManager``/``FeedForward`` and
``DataParallelExecutorGroup`` over 2 contexts; the store's optimizer
states round-trip (a resumed Module bit-equal to the uninterrupted one).
"""
import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401

import torch_dist_worker as W

B = 64


def _params(seed=3):
    return W.mlp_params(seed)


def _batches(nbatch=4):
    x, y = W.toy_data()
    return [(x[i * B:(i + 1) * B], y[i * B:(i + 1) * B])
            for i in range(nbatch)]


def _module(pkg, contexts, kvstore="local", bn=False, **kw):
    mod = pkg.mod.Module((W.bn_mlp if bn else W.mlp)(pkg), context=contexts,
                         **kw)
    mod.bind(data_shapes=[("data", (B, W.D_IN))],
             label_shapes=[("softmax_label", (B,))])
    nd = (lambda a: pkg.nd.array(a, ctx=contexts[0])) if pkg is mt \
        else pkg.nd.array
    mod.init_params(arg_params={k: nd(v) for k, v in
                                (W.bn_mlp_params(3) if bn
                                 else _params()).items()},
                    aux_params={k: nd(v) for k, v in W.BN_AUX.items()}
                    if bn else None)
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    return mod


def _fit(pkg, contexts, nbatch=4, fused=False, **kw):
    mod = _module(pkg, contexts, **kw)
    ctx0 = contexts[0]
    losses = []
    for x, y in _batches(nbatch):
        nd = (lambda a: pkg.nd.array(a, ctx=ctx0)) if pkg is mt \
            else pkg.nd.array
        batch = pkg.io.DataBatch([nd(x)], [nd(y)])
        if fused:
            assert mod._fused_batch_step(batch), mod._fused_fallback_reason
        else:
            mod.forward_backward(batch)
            mod.update()
        out = mod.get_outputs()[0].asnumpy()
        assert out.shape == (B, W.C)
        losses.append(-np.log(np.maximum(
            out[np.arange(B), y.astype(int)], 1e-8)).mean())
    arg, aux = mod.get_params()
    mod.aux_np = {k: v.asnumpy() for k, v in aux.items()}
    return losses, {k: v.asnumpy() for k, v in arg.items()}, mod


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _close_to_largest(got, want, tol=1e-5):
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("n", [2, 4])
def test_module_on_n_contexts_matches_jax_and_one_context(n):
    j_losses, j_params, _ = _fit(mx, [mx.cpu(i) for i in range(n)])
    t_losses, t_params, mod = _fit(mt, [mt.cpu(i) for i in range(n)])
    one_losses, one_params, _ = _fit(mt, [mt.cpu(0)])
    assert len(mod._execs) == n
    assert mod._execs[1].arg_dict["data"].shape == (B // n, W.D_IN)
    _close(t_losses, j_losses)
    _close(t_losses, one_losses)
    for k in j_params:
        _close_to_largest(t_params[k], j_params[k])
        _close_to_largest(t_params[k], one_params[k])
    # every context's replica holds the same weights
    for ex in mod._execs[1:]:
        for k in j_params:
            np.testing.assert_array_equal(ex.arg_dict[k].asnumpy(),
                                          t_params[k])


@pytest.mark.parametrize("n,fused", [(2, False), (2, True), (4, True)])
def test_batchnorm_over_contexts_takes_the_whole_batch(n, fused):
    j_losses, j_params, jmod = _fit(mx, [mx.cpu(i) for i in range(n)],
                                    bn=True)
    t_losses, t_params, mod = _fit(mt, [mt.cpu(i) for i in range(n)],
                                   fused=fused, bn=True)
    _, one_params, one = _fit(mt, [mt.cpu(0)], bn=True)
    assert mod._fused_fallback_reason is None
    _close(t_losses, j_losses)
    for got, ref in ((t_params, j_params), (mod.aux_np, jmod.aux_np),
                     (t_params, one_params), (mod.aux_np, one.aux_np)):
        assert sorted(got) == sorted(ref)
        for k in ref:
            _close_to_largest(got[k], ref[k])
    # every context's replica holds the same moving stats
    for ex in mod._execs[1:]:
        for k, v in ex.aux_dict.items():
            np.testing.assert_array_equal(v.asnumpy(), mod.aux_np[k])


@pytest.mark.parametrize("kvstore", ["local", None])
def test_fused_equals_phase_split_over_contexts(kvstore):
    ctxs = [mt.cpu(0), mt.cpu(1)]
    a_losses, a_params, _ = _fit(mt, ctxs, kvstore=kvstore)
    b_losses, b_params, mod = _fit(mt, ctxs, fused=True, kvstore=kvstore)
    assert a_losses == b_losses
    for k in a_params:
        np.testing.assert_array_equal(b_params[k], a_params[k])
    assert mod._fused_fallback_reason is None


def test_batch_that_does_not_divide_raises():
    for pkg in (mx, mt):
        mod = pkg.mod.Module(W.mlp(pkg),
                             context=[pkg.cpu(i) for i in range(3)])
        with pytest.raises(pkg.base.MXNetError, match="not divisible"):
            mod.bind(data_shapes=[("data", (62, W.D_IN))],
                     label_shapes=[("softmax_label", (62,))])


def test_duplicate_contexts_and_unported_options_raise():
    mod = mx.mod.Module(W.mlp(mx), context=[mx.cpu(0), mx.cpu(0)])
    with pytest.raises(mx.base.MXNetError, match="duplicate devices"):
        mod.bind(data_shapes=[("data", (B, W.D_IN))],
                 label_shapes=[("softmax_label", (B,))])
    with pytest.raises(mt.MXNetError, match="duplicate devices"):
        mt.mod.Module(W.mlp(mt), context=[mt.cpu(0), mt.cpu(0)])
    # group2ctxs with a context list raises at bind, naming group2ctxs,
    # in both packages
    for pkg in (mx, mt):
        mod = pkg.mod.Module(W.mlp(pkg), context=[pkg.cpu(0), pkg.cpu(1)],
                             group2ctxs=[{"a": pkg.cpu(1)}])
        with pytest.raises(pkg.base.MXNetError, match="group2ctxs"):
            mod.bind(data_shapes=[("data", (B, W.D_IN))],
                     label_shapes=[("softmax_label", (B,))])
    # the meshes are ported (tests/test_torch_module_mesh.py): a rule
    # tree that is not one raises, a dp mesh over the two binds
    with pytest.raises(mt.MXNetError, match="partition_rules must be"):
        mt.mod.Module(W.mlp(mt), context=[mt.cpu(0), mt.cpu(1)],
                      partition_rules=object())
    mod = mt.mod.Module(W.mlp(mt), context=[mt.cpu(0), mt.cpu(1)],
                        mesh_axes={"dp": 2})
    mod.bind(data_shapes=[("data", (B, W.D_IN))],
             label_shapes=[("softmax_label", (B,))])
    assert mod.partition_summary()["mesh_axes"] == {"dp": 2}


def test_fused_fallback_codes_equal_jax():
    assert mt.mod.FUSED_FALLBACK_CODES == mx.mod.FUSED_FALLBACK_CODES


def test_compressed_local_store_phase_splits():
    ctxs = [mt.cpu(0), mt.cpu(1)]
    mod = _module(mt, ctxs, compression_params={"type": "2bit",
                                                "threshold": 0.5})
    assert mod._kvstore._compression.type == "2bit"
    x, y = _batches(1)[0]
    batch = mt.io.DataBatch([mt.nd.array(x, ctx=ctxs[0])],
                            [mt.nd.array(y, ctx=ctxs[0])])
    assert not mod._fused_batch_step(batch)
    assert mod._fused_fallback_reason.code == "kvstore_compression"
    before = mod.get_params()[0]["fc2_bias"].asnumpy()
    mod.forward_backward(batch)
    mod.update()
    step = mod.get_params()[0]["fc2_bias"].asnumpy() - before
    # each context's gradient quantised to 0 or +-0.5, summed, times lr
    assert set(np.round(np.abs(step) / 0.05).astype(int)) <= {0, 1, 2}


def test_store_states_round_trip_over_contexts(tmp_path):
    ctxs = [mt.cpu(0), mt.cpu(1)]
    _, want, _ = _fit(mt, ctxs, nbatch=4)
    _, _, mod = _fit(mt, ctxs, nbatch=2)
    fname = str(tmp_path / "dp.states")
    mod.save_optimizer_states(fname)
    arg, aux = mod.get_params()
    mod2 = mt.mod.Module(W.mlp(mt), context=ctxs)
    mod2.bind(data_shapes=[("data", (B, W.D_IN))],
              label_shapes=[("softmax_label", (B,))])
    mod2.init_params(arg_params=arg, aux_params=aux)
    mod2.init_optimizer(kvstore="local", optimizer="sgd",
                        optimizer_params={"learning_rate": 0.1,
                                          "momentum": 0.9})
    mod2.load_optimizer_states(fname)
    for x, y in _batches(4)[2:]:
        mod2.forward_backward(mt.io.DataBatch(
            [mt.nd.array(x, ctx=ctxs[0])], [mt.nd.array(y, ctx=ctxs[0])]))
        mod2.update()
    got = {k: v.asnumpy() for k, v in mod2.get_params()[0].items()}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_feedforward_and_executor_manager_over_two_contexts():
    x, y = W.toy_data()
    ctxs = [mt.cpu(0), mt.cpu(1)]
    init = {k: mt.nd.array(v, ctx=ctxs[0]) for k, v in _params().items()}
    ff = mt.model.FeedForward(W.mlp(mt), ctx=ctxs, num_epoch=1,
                              optimizer="sgd", learning_rate=0.1,
                              momentum=0.9, arg_params=dict(init),
                              numpy_batch_size=B)
    ff.fit(mt.io.NDArrayIter(x, y, batch_size=B))
    one = mt.model.FeedForward(W.mlp(mt), ctx=[ctxs[0]], num_epoch=1,
                               optimizer="sgd", learning_rate=0.1,
                               momentum=0.9, arg_params=dict(init),
                               numpy_batch_size=B)
    one.fit(mt.io.NDArrayIter(x, y, batch_size=B))
    for k in init:
        _close_to_largest(ff.arg_params[k].asnumpy(),
                          one.arg_params[k].asnumpy())
    it = mt.io.NDArrayIter(x, y, batch_size=B)
    sym = W.mlp(mt)
    names = sym.list_arguments()
    params = [n for n in names if n not in ("data", "softmax_label")]
    mgr = mt.executor_manager.DataParallelExecutorManager(
        sym, ctxs, it, names, params, [], work_load_list=[1, 3])
    assert mgr.slices == [slice(0, 16), slice(16, 64)]
    mgr.set_params(init, {})
    batch = next(iter(it))
    mgr.load_data_batch(batch)
    mgr.forward(is_train=True)
    mgr.backward()
    summed = {n: sum(g.asnumpy() for g in gl)
              for n, gl in zip(params, mgr.grad_arrays)}
    ref = sym.simple_bind(ctx=ctxs[0], grad_req="write", data=(B, W.D_IN),
                          softmax_label=(B,))
    ref.copy_params_from(init)
    ref.forward_backward(data=batch.data[0], softmax_label=batch.label[0])
    for n in params:
        _close(summed[n], ref.grad_dict[n].asnumpy())
    out = {}
    mgr.copy_to(out, {})
    for k in init:
        np.testing.assert_array_equal(out[k].asnumpy(), init[k].asnumpy())
    with pytest.raises(ValueError, match="empty"):
        mt.executor_manager._split_input_slice(2, [1, 1, 1])


def test_executor_group_facade_over_two_contexts():
    from mxnet_tpu_torch.module.executor_group import \
        DataParallelExecutorGroup
    sym = W.mlp(mt)
    params = [n for n in sym.list_arguments()
              if n not in ("data", "softmax_label")]
    ctxs = [mt.cpu(0), mt.cpu(1)]
    grp = DataParallelExecutorGroup(
        sym, ctxs, None, [("data", (B, W.D_IN))], [("softmax_label", (B,))],
        params, True, False)
    init = {k: mt.nd.array(v, ctx=ctxs[0]) for k, v in _params().items()}
    grp.set_params(init)
    x, y = _batches(1)[0]
    batch = mt.io.DataBatch([mt.nd.array(x, ctx=ctxs[0])],
                            [mt.nd.array(y, ctx=ctxs[0])])
    grp.forward(batch, is_train=True)
    grp.backward()
    ref = sym.simple_bind(ctx=ctxs[0], grad_req="write", data=(B, W.D_IN),
                          softmax_label=(B,))
    ref.copy_params_from(init)
    ref.forward_backward(data=batch.data[0], softmax_label=batch.label[0])
    np.testing.assert_allclose(grp.get_outputs()[0].asnumpy(),
                               ref.outputs[0].asnumpy(), rtol=1e-6)
    assert len(grp.get_outputs(merge_multi_context=False)[0]) == 2
    for n in params:
        summed = sum(ex.grad_dict[n].asnumpy() for ex in grp.execs)
        _close(summed, ref.grad_dict[n].asnumpy())
