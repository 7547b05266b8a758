"""``group2ctx`` (model parallelism by op group) in the port against the
JAX package: the counterparts of ``tests/test_module.py``'s group2ctx
cases with ``cpu(0)``/``cpu(1)`` as the groups (two Contexts of the host:
every placement is checked by Context). Forward and gradients of the
grouped executor equal the ungrouped one's and match the JAX package's
grouped executor within 1e-6; parameters, gradients and outputs live on
their group's Context; a caller's array on the wrong group's Context
raises at bind, naming it; ``Module(group2ctxs=)`` with a context list
raises naming ``group2ctxs``; ``Module.fit`` phase-splits under the
``group2ctx`` code, bit-equal to the port's ungrouped ``fit`` and within
1e-6 of the JAX package's. (The JAX package's own grouped ``fit`` stops
in its optimizer, which jits one update over parameters on two devices,
so its ungrouped ``fit`` is the reference.)
"""
import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt

RS = np.random.RandomState(0)
X = RS.uniform(-1, 1, (4, 6)).astype(np.float32)
W1 = RS.uniform(-0.5, 0.5, (5, 6)).astype(np.float32)
W2 = RS.uniform(-0.5, 0.5, (3, 5)).astype(np.float32)


def _build(pkg, act=True):
    with pkg.AttrScope(ctx_group="dev1"):
        data = pkg.sym.Variable("data")
        net = pkg.sym.FullyConnected(data, num_hidden=5, no_bias=True,
                                     name="fc1")
        if act:
            net = pkg.sym.Activation(net, act_type="tanh")
    with pkg.AttrScope(ctx_group="dev2"):
        net = pkg.sym.FullyConnected(net, num_hidden=3, no_bias=True,
                                     name="fc2")
    return net


def _g2c(pkg):
    return {"dev1": pkg.cpu(0), "dev2": pkg.cpu(1)}


def _run(pkg, group2ctx):
    ex = _build(pkg).simple_bind(ctx=pkg.cpu(0), grad_req="write",
                                 group2ctx=group2ctx, data=(4, 6))
    ex.arg_dict["data"][:] = X
    ex.arg_dict["fc1_weight"][:] = W1
    ex.arg_dict["fc2_weight"][:] = W2
    out = ex.forward_backward(out_grads=pkg.nd.ones((4, 3), ctx=pkg.cpu(1)),
                              is_train=True)[0]
    return ex, out.asnumpy(), {n: ex.grad_dict[n].asnumpy()
                               for n in ("fc1_weight", "fc2_weight")}


@pytest.mark.parametrize("grouped", [False, True])
def test_forward_and_gradients_match_jax(grouped):
    ex, out, grads = _run(mt, _g2c(mt) if grouped else None)
    _, jout, jgrads = _run(mx, _g2c(mx))
    np.testing.assert_allclose(out, jout, rtol=0, atol=1e-6)
    for k in grads:
        np.testing.assert_allclose(grads[k], jgrads[k], rtol=0, atol=1e-6)
    _, bout, bgrads = _run(mt, None)
    np.testing.assert_array_equal(out, bout)
    for k in grads:
        np.testing.assert_array_equal(grads[k], bgrads[k])


def test_placement_follows_the_groups():
    ex, _, _ = _run(mt, _g2c(mt))
    # two Contexts assigned, the variables on their first consumer's group
    assert set(ex._prog.node_ctx.values()) == {mt.cpu(0), mt.cpu(1)}
    assert ex.arg_dict["data"].context == mt.cpu(0)
    assert ex.arg_dict["fc1_weight"].context == mt.cpu(0)
    assert ex.arg_dict["fc2_weight"].context == mt.cpu(1)
    assert ex.grad_dict["fc2_weight"].context == mt.cpu(1)
    assert ex.outputs[0].context == mt.cpu(1)
    ungrouped, _, _ = _run(mt, None)
    assert ungrouped._prog.node_ctx is None
    assert ungrouped.outputs[0].context == mt.cpu(0)


def test_misplaced_caller_array_raises_at_bind():
    net = _build(mt, act=False)
    args = {"data": mt.nd.zeros((4, 6), ctx=mt.cpu(0)),
            "fc1_weight": mt.nd.zeros((5, 6), ctx=mt.cpu(0)),
            "fc2_weight": mt.nd.zeros((3, 5), ctx=mt.cpu(0))}
    with pytest.raises(mt.MXNetError, match="fc2_weight"):
        net.bind(ctx=mt.cpu(0), args=args, group2ctx=_g2c(mt))
    # correctly placed caller arrays bind and are not moved
    args["fc2_weight"] = mt.nd.zeros((3, 5), ctx=mt.cpu(1))
    ex = net.bind(ctx=mt.cpu(0), args=args, group2ctx=_g2c(mt))
    assert args["fc2_weight"].context == mt.cpu(1)
    ex.forward(is_train=False)
    assert ex.outputs[0].context == mt.cpu(1)


def test_module_with_a_context_list_raises():
    net = _build(mt, act=False)
    mod = mt.mod.Module(net, context=[mt.cpu(0), mt.cpu(1)],
                        group2ctxs=_g2c(mt))
    with pytest.raises(mt.MXNetError, match="group2ctxs"):
        mod.bind(data_shapes=[("data", (4, 6))], label_shapes=None)
    mod = mt.mod.Module(net, context=mt.cpu(0), label_names=None,
                        group2ctxs=_g2c(mt))
    mod.bind(data_shapes=[("data", (4, 6))], label_shapes=None)
    assert mod._exec._prog.node_ctx


def _fit(pkg, group2ctxs):
    rs = np.random.RandomState(3)
    x = rs.uniform(-1, 1, (24, 6)).astype(np.float32)
    y = rs.randint(0, 3, 24).astype(np.float32)
    sym = pkg.sym.SoftmaxOutput(_build(pkg), name="softmax")
    mod = pkg.mod.Module(sym, context=pkg.cpu(0), group2ctxs=group2ctxs)
    it = pkg.io.NDArrayIter(x, y, batch_size=8)
    mod.fit(it, num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params={"fc1_weight": pkg.nd.array(W1, ctx=pkg.cpu()),
                        "fc2_weight": pkg.nd.array(W2, ctx=pkg.cpu())},
            kvstore=None)
    return mod, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_module_fit_phase_splits_and_matches_jax():
    mt.telemetry.enable()
    mt.telemetry.reset()
    mod, got = _fit(mt, _g2c(mt))
    assert mod._fused_fallback_reason.code == "group2ctx"
    assert mt.telemetry.counters().get("fused_fallback.group2ctx") == 6
    assert mod._exec.arg_dict["fc2_weight"].context == mt.cpu(1)
    _, want = _fit(mx, None)
    _, plain = _fit(mt, None)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got[k], plain[k])
    mt.telemetry.reset()
