"""The recurrent family in the PyTorch port against the JAX package.

The same numpy inputs and weights (carried by ``mxnet_tpu_torch.weights``
or set by name) go through ``mxnet_tpu`` and ``mxnet_tpu_torch`` on the
CPU:

* the fused ``RNN`` op (``lstm``/``gru``/``rnn_tanh``/``rnn_relu`` x
  uni/bidirectional x 1-2 layers, p = 0): output, final states and the
  gradients of data, parameters and states within 1e-5;
* ``gluon.rnn.LSTM``/``GRU`` in TNC and NTC, hybridized and not:
  outputs, states and parameter gradients within 1e-5;
* every gluon cell's and symbolic cell's ``unroll`` with
  ``merge_outputs`` True and False within 1e-5, and
  ``FusedRNNCell.unfuse()`` against the fused cell (port and JAX);
* ``Perplexity``, ``Adam`` (per parameter and fused, 4 steps with wd and
  clip), ``adam_update``, ``BucketSentenceIter``'s batches and keys,
  ``nn.Sequential``/``Dropout``/``Embedding`` and ``Embedding``'s
  padding index -1;
* three truncated-BPTT steps of the word language model of
  ``examples/gluon/word_language_model/train.py`` at a small size (vocab
  60, 2 layers of 32, bptt 8, batch 8, dropout 0), eager and hybridized:
  loss within 1e-5 relative, parameters within 1e-4 of each tensor's
  largest magnitude.

Random draws are PyTorch's, not ``jax.random``'s, so Dropout and the
samplers are held to their statistics, never to the JAX package's values:
the kept share within 4 binomial standard deviations of 1 - p, the scale
1 / (1 - p), identity in inference, the same mask from the same
``mx.random.seed``; the samplers' means and variances within 5 standard
errors.
"""
import json
import pickle
import random

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.ops.rnn import rnn_param_size

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401
from mxnet_tpu_torch import weights

CPU = mt.cpu()
MODES = ["lstm", "gru", "rnn_tanh", "rnn_relu"]


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _scaled(got, want):
    """Largest |got - want| over the largest |want|."""
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# The fused RNN op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_rnn_op_matches_jax(mode, bidirectional, layers):
    rs = np.random.RandomState(0)
    T, N, I, H = 5, 3, 4, 6
    d = 2 if bidirectional else 1
    arrs = [rs.randn(T, N, I), 0.3 * rs.randn(
        rnn_param_size(I, H, layers, mode, bidirectional)),
            rs.randn(layers * d, N, H), rs.randn(layers * d, N, H)]
    arrs = [a.astype(np.float32) for a in arrs]
    if mode != "lstm":
        arrs = arrs[:3]
    heads = [rs.randn(T, N, d * H).astype(np.float32),
             rs.randn(layers * d, N, H).astype(np.float32),
             rs.randn(layers * d, N, H).astype(np.float32)]
    kw = dict(state_size=H, num_layers=layers, mode=mode,
              bidirectional=bidirectional, state_outputs=True)
    res = []
    for pkg, ctx in ((mx, {}), (mt, {"ctx": CPU})):
        xs = [pkg.nd.array(a, **ctx) for a in arrs]
        for x in xs:
            x.attach_grad()
        with pkg.autograd.record():
            outs = pkg.nd.RNN(*xs, **kw)
            loss = sum((o * pkg.nd.array(h, **ctx)).sum()
                       for o, h in zip(outs, heads))
        loss.backward()
        res.append(([o.asnumpy() for o in outs],
                    [x.grad.asnumpy() for x in xs]))
    (jo, jg), (to, tg) = res
    assert len(to) == len(jo) == (3 if mode == "lstm" else 2)
    for a, b in zip(to + tg, jo + jg):
        _close(a, b)


def test_rnn_op_ignores_state_clip_like_jax():
    rs = np.random.RandomState(1)
    x = rs.randn(4, 2, 3).astype(np.float32)
    p = rs.randn(rnn_param_size(3, 5, 1, "lstm")).astype(np.float32)
    h = 3 * rs.randn(1, 2, 5).astype(np.float32)
    outs = [mt.nd.RNN(*[mt.nd.array(a, ctx=CPU) for a in (x, p, h, h)],
                      state_size=5, mode="lstm", state_outputs=True, **kw)
            for kw in ({}, {"lstm_state_clip_min": -0.1,
                            "lstm_state_clip_max": 0.1})]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


def test_rnn_symbol_lists_state_cell_for_lstm_only():
    for mode, want in (("lstm", 4), ("gru", 3)):
        s = mt.sym.RNN(mt.sym.Variable("data"), state_size=4, mode=mode,
                       name="r")
        assert len(s.list_arguments()) == want
        s2 = mt.sym.RNN(mt.sym.Variable("data"), state_size=4, mode=mode,
                        state_outputs=True, name="r")
        assert len(s2.list_outputs()) == (3 if mode == "lstm" else 2)
        shapes, outs, _ = s2.infer_shape(data=(5, 2, 3))
        assert shapes[1] == (rnn_param_size(3, 4, 1, mode),)
        assert outs[0] == (5, 2, 4) and outs[1] == (1, 2, 4)


# ---------------------------------------------------------------------------
# gluon.rnn layers
# ---------------------------------------------------------------------------

def _gluon_pair(cls_name, layout, **kw):
    with mx.name.NameManager():
        j = getattr(mx.gluon.rnn, cls_name)(8, 2, layout=layout,
                                            input_size=5, **kw)
    j.initialize(mx.init.Xavier())
    with mt.name.NameManager():
        t = getattr(mt.gluon.rnn, cls_name)(8, 2, layout=layout,
                                            input_size=5, **kw)
    t.initialize(mt.init.Xavier(), ctx=CPU)
    weights.load_into_block(t, j.collect_params(), ctx=CPU)
    return j, t


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("layout", ["TNC", "NTC"])
@pytest.mark.parametrize("cls_name", ["LSTM", "GRU"])
def test_gluon_rnn_layer_matches_jax(cls_name, layout, hybridize):
    rs = np.random.RandomState(2)
    j, t = _gluon_pair(cls_name, layout, bidirectional=cls_name == "GRU")
    assert list(t.collect_params().keys()) == \
        list(j.collect_params().keys())
    x = rs.randn(4, 3, 5).astype(np.float32)
    batch = 3 if layout == "TNC" else 4
    res = []
    for pkg, net, ctx in ((mx, j, {}), (mt, t, {"ctx": CPU})):
        if hybridize:
            net.hybridize()
        xin = pkg.nd.array(x, **ctx)
        states = [pkg.nd.array(rs.rand(*s["shape"]).astype(np.float32)
                               * 0 + 0.1, **ctx)
                  for s in net.state_info(batch)]
        with pkg.autograd.record():
            out, new = net(xin, states)
            loss = (out * out).sum() + sum((s * s).sum() for s in new)
        loss.backward()
        nostate = net(xin)          # states=None: the output alone
        res.append((out.asnumpy(), [s.asnumpy() for s in new],
                    nostate.asnumpy(),
                    {k: p.grad().asnumpy()
                     for k, p in net.collect_params().items()}))
    (jo, js, jn, jg), (to, ts, tn, tg) = res
    _close(to, jo)
    _close(tn, jn)
    assert len(ts) == len(js) == (2 if cls_name == "LSTM" else 1)
    for a, b in zip(ts, js):
        _close(a, b)
    for k in jg:
        _close(tg[k], jg[k])


def test_gluon_rnn_layer_deferred_input_size_and_begin_state():
    net = mt.gluon.rnn.LSTM(6, 2, bidirectional=True)
    net.initialize(ctx=CPU)
    states = net.begin_state(batch_size=3)
    assert [s.shape for s in states] == [(4, 3, 6), (4, 3, 6)]
    assert states[0].context == CPU
    out, new = net(mt.nd.ones((5, 3, 7), ctx=CPU), states)
    assert out.shape == (5, 3, 12)
    assert net.l0_i2h_weight.shape == (24, 7)
    assert net.l1_i2h_weight.shape == (24, 12)


# ---------------------------------------------------------------------------
# gluon cells
# ---------------------------------------------------------------------------

def _gluon_cells(pkg):
    R = pkg.gluon.rnn
    return {
        "rnn": lambda: R.RNNCell(6, input_size=4),
        "lstm": lambda: R.LSTMCell(6, input_size=4),
        "gru": lambda: R.GRUCell(6, input_size=4),
        "sequential": lambda: _seq(R),
        "dropout_in_stack": lambda: _seq(R, R.DropoutCell(0.5)),
        "zoneout": lambda: R.ZoneoutCell(R.LSTMCell(6, input_size=4), 0.3,
                                         0.3),
        "residual": lambda: R.ResidualCell(R.GRUCell(4, input_size=4)),
        "bidirectional": lambda: R.BidirectionalCell(
            R.LSTMCell(6, input_size=4), R.GRUCell(5, input_size=4)),
    }


def _seq(R, middle=None):
    s = R.SequentialRNNCell()
    s.add(R.LSTMCell(6, input_size=4))
    if middle is not None:
        s.add(middle)
    s.add(R.RNNCell(5, input_size=6))
    return s


@pytest.mark.parametrize("merge", [True, False])
@pytest.mark.parametrize("kind", sorted(_gluon_cells(mx)))
def test_gluon_cell_unroll_matches_jax(kind, merge):
    if kind == "bidirectional" and not merge:
        merge = True            # BidirectionalCell always merges
    rs = np.random.RandomState(3)
    x = rs.randn(2, 5, 4).astype(np.float32)       # NTC
    with mx.name.NameManager():
        j = _gluon_cells(mx)[kind]()
    j.collect_params().initialize(mx.init.Xavier())
    with mt.name.NameManager():
        t = _gluon_cells(mt)[kind]()
    t.collect_params().initialize(mt.init.Xavier(), ctx=CPU)
    weights.load_into_block(t, j.collect_params(), ctx=CPU)
    jo, js = j.unroll(5, mx.nd.array(x), layout="NTC", merge_outputs=merge)
    to, ts = t.unroll(5, mt.nd.array(x, ctx=CPU), layout="NTC",
                      merge_outputs=merge)
    if merge:
        _close(to.asnumpy(), jo.asnumpy())
    else:
        assert len(to) == len(jo) == 5
        for a, b in zip(to, jo):
            _close(a.asnumpy(), b.asnumpy())
    assert len(ts) == len(js)
    for a, b in zip(ts, js):
        _close(a.asnumpy(), b.asnumpy())


def test_gluon_zoneout_and_dropout_cells_draw_in_training():
    R = mt.gluon.rnn
    cell = R.ZoneoutCell(R.LSTMCell(6, input_size=4), 0.5, 0.5)
    cell.collect_params().initialize(ctx=CPU)
    x = mt.nd.ones((2, 5, 4), ctx=CPU)
    ref, _ = cell.unroll(5, x, merge_outputs=True)
    with mt.autograd.record():
        mt.random.seed(7)
        a, _ = cell.unroll(5, x, merge_outputs=True)
        mt.random.seed(7)
        b, _ = cell.unroll(5, x, merge_outputs=True)
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    assert not np.array_equal(a.asnumpy(), ref.asnumpy())


# ---------------------------------------------------------------------------
# symbolic cells
# ---------------------------------------------------------------------------

def _sym_cells(pkg):
    R = pkg.rnn
    return {
        "rnn": lambda: R.RNNCell(6, prefix="rnn_"),
        "lstm": lambda: R.LSTMCell(6, prefix="lstm_"),
        "gru": lambda: R.GRUCell(6, prefix="gru_"),
        "sequential": lambda: _sym_seq(R),
        "residual": lambda: R.ResidualCell(R.GRUCell(4, prefix="res_")),
        "zoneout": lambda: R.ZoneoutCell(R.LSTMCell(6, prefix="z_")),
        "bidirectional": lambda: R.BidirectionalCell(
            R.LSTMCell(6, prefix="l_"), R.GRUCell(5, prefix="r_")),
        "fused_lstm": lambda: R.FusedRNNCell(6, 2, "lstm",
                                             get_next_state=True,
                                             prefix="f_"),
        "fused_gru_bi": lambda: R.FusedRNNCell(6, 1, "gru",
                                               bidirectional=True,
                                               get_next_state=True,
                                               prefix="g_"),
    }


def _sym_seq(R):
    s = R.SequentialRNNCell()
    s.add(R.LSTMCell(6, prefix="s0_"))
    s.add(R.DropoutCell(0.0))
    s.add(R.RNNCell(5, prefix="s1_"))
    return s


def _bind_run(pkg, sym, values, ctx):
    """Forward of ``sym`` on ``values``; a JAX-only state_cell variable
    (see ``test_symbolic_cell_unroll_matches_jax``) takes zeros."""
    shapes = dict(zip(sym.list_arguments(),
                      sym.infer_shape_partial(data=values["data"].shape)[0]))
    args = {n: pkg.nd.array(values[n] if n in values
                            else np.zeros(shapes[n] or (1,), np.float32),
                            **ctx)
            for n in sym.list_arguments()}
    kw = {"ctx": CPU} if ctx else {}
    ex = sym.bind(args=args, **kw)
    return [o.asnumpy() for o in ex.forward()]


@pytest.mark.parametrize("merge", [True, False])
@pytest.mark.parametrize("kind", sorted(_sym_cells(mx)))
def test_symbolic_cell_unroll_matches_jax(kind, merge):
    rs = np.random.RandomState(4)
    x = rs.randn(2, 5, 4).astype(np.float32)       # NTC
    outs = []
    for pkg in (mx, mt):
        with pkg.name.NameManager():
            cell = _sym_cells(pkg)[kind]()
            data = pkg.sym.Variable("data")
            o, states = cell.unroll(5, data, layout="NTC",
                                    merge_outputs=merge)
            o = [o] if isinstance(o, pkg.sym.Symbol) and merge else list(o)
            outs.append(pkg.sym.Group(o + list(states)))
    js, ts = outs
    # the JAX package makes a state_cell variable for a GRU's fused op
    # too; the port lists it for LSTM only, as upstream MXNet does
    jax_only = [n for n in js.list_arguments()
                if kind == "fused_gru_bi" and n.endswith("_state_cell")]
    assert ts.list_arguments() == [n for n in js.list_arguments()
                                   if n not in jax_only]
    shapes, _, _ = ts.infer_shape(data=x.shape)
    values = {n: (0.3 * rs.randn(*s)).astype(np.float32)
              for n, s in zip(ts.list_arguments(), shapes)}

    values["data"] = x
    got = _bind_run(mt, ts, values, {"ctx": CPU})
    want = _bind_run(mx, js, values, {})
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _close(a, b)


def _unfused_values(cell, flat, in_size):
    """The unfused stack's arguments from the packed vector: each layer's
    gates are contiguous rows of W_ih, W_hh, b_ih, b_hh."""
    from mxnet_tpu_torch.ops.rnn import _GATES
    g, H = _GATES[cell._mode], cell._num_hidden
    out, off = {}, 0
    for layer in range(cell._num_layers):
        n_in = in_size if layer == 0 else H * cell._directions
        for d in range(cell._directions):
            pre = "%s%s%d_" % (cell._prefix, "lr"[d], layer)
            for name, shape in (("i2h_weight", (g * H, n_in)),
                                ("h2h_weight", (g * H, H)),
                                ("i2h_bias", (g * H,)),
                                ("h2h_bias", (g * H,))):
                n = int(np.prod(shape))
                out[pre + name] = flat[off:off + n].reshape(shape)
                off += n
    return out


@pytest.mark.parametrize("mode,bi", [("lstm", False), ("gru", True),
                                     ("rnn_tanh", False)])
def test_fused_cell_unfuse_matches_fused(mode, bi):
    rs = np.random.RandomState(5)
    x = rs.randn(3, 6, 4).astype(np.float32)        # NTC
    flat = (0.3 * rs.randn(rnn_param_size(4, 5, 2, mode, bi))).astype(
        np.float32)
    results = []
    for pkg, ctx in ((mt, {"ctx": CPU}), (mx, {})):
        fused = pkg.rnn.FusedRNNCell(5, 2, mode, bidirectional=bi,
                                     prefix="f_")
        fo, _ = fused.unroll(6, pkg.sym.Variable("data"), layout="NTC",
                             merge_outputs=True)
        got = _bind_run(pkg, fo, {"data": x, "f_parameters": flat}, ctx)[0]
        results.append(got)
    stack = fused_cell = mt.rnn.FusedRNNCell(5, 2, mode, bidirectional=bi,
                                             prefix="f_")
    stack = fused_cell.unfuse()
    uo, _ = stack.unroll(6, mt.sym.Variable("data"), layout="NTC",
                         merge_outputs=True)
    values = _unfused_values(fused_cell, flat, 4)
    values["data"] = x
    assert sorted(uo.list_arguments()) == sorted(values)
    unfused = _bind_run(mt, uo, values, {"ctx": CPU})[0]
    _close(results[0], results[1])
    _close(unfused, results[0])


def test_fused_cell_pack_unpack_and_weights_carry():
    rs = np.random.RandomState(6)
    flat = rs.randn(rnn_param_size(3, 4, 2, "lstm", True)).astype(
        np.float32)
    jcell = mx.rnn.FusedRNNCell(4, 2, "lstm", bidirectional=True,
                                prefix="f_")
    tcell = mt.rnn.FusedRNNCell(4, 2, "lstm", bidirectional=True,
                                prefix="f_")
    ju = jcell.unpack_weights({"f_parameters": mx.nd.array(flat)})
    tu = tcell.unpack_weights({"f_parameters": mt.nd.array(flat, ctx=CPU)})
    assert sorted(ju) == sorted(tu)
    for k in ju:
        np.testing.assert_array_equal(tu[k].asnumpy(), ju[k].asnumpy())
    back = tcell.pack_weights(tu)["f_parameters"].asnumpy()
    np.testing.assert_array_equal(back, flat)
    for blob in ({"f_parameters": flat},
                 {k: v.asnumpy() for k, v in ju.items()}):
        got = weights.fused_rnn_from_numpy(tcell, blob, ctx=CPU)
        np.testing.assert_array_equal(got["f_parameters"].asnumpy(), flat)
    with pytest.raises(mt.MXNetError):
        weights.fused_rnn_from_numpy(tcell, {"f_parameters": flat[:-3]},
                                     ctx=CPU)
    extra = {k: v.asnumpy() for k, v in ju.items()}
    extra["f_extra_weight"] = flat[:3]
    with pytest.raises(mt.MXNetError):
        weights.fused_rnn_from_numpy(tcell, extra, ctx=CPU)


def test_lstm_bias_and_fused_rnn_initializers():
    b = mt.nd.zeros((16,), ctx=CPU)
    mt.init.LSTMBias(forget_bias=2.0)("x_bias", b)
    np.testing.assert_array_equal(b.asnumpy(),
                                  np.repeat([0, 2.0, 0, 0], 4))
    size = rnn_param_size(3, 4, 2, "lstm")
    arr = mt.nd.zeros((size,), ctx=CPU)
    init = mt.init.FusedRNN(mt.init.Uniform(0.5), 4, 2, "lstm",
                            forget_bias=1.5)
    init(mt.init.InitDesc("f_parameters", {"__init__": init.dumps()}), arr)
    args = mt.rnn.FusedRNNCell(4, 2, "lstm", prefix="").unpack_weights(
        {"parameters": arr})
    for k, v in args.items():
        v = v.asnumpy()
        if k.endswith("_f_bias"):
            np.testing.assert_array_equal(v, 1.5)
        elif k.endswith("_bias"):
            np.testing.assert_array_equal(v, 0.0)
        else:
            assert np.abs(v).max() <= 0.5 and v.std() > 0.1
    name, kwargs = json.loads(init.dumps())
    again = mt.init.create(name, **kwargs)
    assert isinstance(again, mt.init.FusedRNN) and again.forget_bias == 1.5


# ---------------------------------------------------------------------------
# Metric, optimizer, iterator, layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ignore", [None, -1])
def test_perplexity_matches_jax(ignore):
    rs = np.random.RandomState(7)
    labels = [rs.randint(-1 if ignore else 0, 9, (4, 5)).astype(np.float32)
              for _ in range(2)]
    preds = []
    for _ in range(2):
        p = rs.rand(20, 9).astype(np.float32)
        preds.append(p / p.sum(1, keepdims=True))
    jm = mx.metric.Perplexity(ignore_label=ignore)
    tm = mt.metric.Perplexity(ignore_label=ignore)
    tn = mt.metric.create("perplexity", ignore_label=ignore)
    for _ in range(2):
        jm.update([mx.nd.array(l) for l in labels],
                  [mx.nd.array(p) for p in preds])
        tm.update([mt.nd.array(l, ctx=CPU) for l in labels],
                  [mt.nd.array(p, ctx=CPU) for p in preds])
        tn.update(labels, preds)
    want = jm.get()[1]
    assert abs(tm.get()[1] - want) <= 1e-5 * want
    assert abs(tn.get()[1] - want) <= 1e-5 * want
    assert tm.num_inst == jm.num_inst


@pytest.mark.parametrize("fused", [False, True])
def test_adam_matches_jax_over_four_steps(fused):
    rs = np.random.RandomState(8)
    w0 = [rs.randn(5, 3).astype(np.float32), rs.randn(7).astype(np.float32)]
    grads = [[rs.randn(*w.shape).astype(np.float32) * 3 for w in w0]
             for _ in range(4)]
    kw = dict(learning_rate=0.05, wd=0.01, clip_gradient=1.0,
              rescale_grad=0.5, param_idx2name={0: "a_weight", 1: "b_bias"})
    ju = mx.optimizer.get_updater(mx.optimizer.Adam(**kw))
    tu = mt.optimizer.get_updater(mt.optimizer.create("adam", **kw))
    jw = [mx.nd.array(w) for w in w0]
    tw = [mt.nd.array(w, ctx=CPU) for w in w0]
    for gs in grads:
        if fused:
            ju.update_batch([0, 1], [mx.nd.array(g) for g in gs], jw)
            tu.update_batch([0, 1], [mt.nd.array(g, ctx=CPU) for g in gs],
                            tw)
        else:
            for i, g in enumerate(gs):
                ju(i, mx.nd.array(g), jw[i])
                mt.optimizer.Updater.__call__(tu, i, mt.nd.array(g, ctx=CPU),
                                              tw[i])
    for a, b in zip(tw, jw):
        _close(a.asnumpy(), b.asnumpy())
    js = pickle.loads(ju.get_states())
    ts = pickle.loads(tu.get_states())
    for i in js:
        for a, b in zip(ts[i], js[i]):
            _close(a, b)
    # the JAX states load into the port's updater and step on alike
    tu2 = mt.optimizer.get_updater(mt.optimizer.create("adam", **kw))
    tu2.set_states(ju.get_states())
    tu2.optimizer._index_update_count = dict(ju.optimizer._index_update_count)
    tw2 = [mt.nd.array(w.asnumpy(), ctx=CPU) for w in jw]
    g = grads[0]
    tu2.update_batch([0, 1], [mt.nd.array(x, ctx=CPU) for x in g], tw2)
    ju.update_batch([0, 1], [mx.nd.array(x) for x in g], jw)
    for a, b in zip(tw2, jw):
        _close(a.asnumpy(), b.asnumpy())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_adam_trainer_states_carry_both_ways(writer, tmp_path):
    """A Trainer's Adam states saved by one package load in the other's
    ``load_states`` (update counts carried by hand, as the pickled states
    do not hold them) and the next step agrees."""
    rs = np.random.RandomState(10)
    w0 = rs.randn(3, 4).astype(np.float32)
    steps = [rs.randn(5, 4).astype(np.float32) for _ in range(3)]
    nets = {}
    for pkg, ctx in ((mx, {}), (mt, {"ctx": CPU})):
        with pkg.name.NameManager():
            net = pkg.gluon.nn.Dense(3, in_units=4, use_bias=False)
        net.initialize(**ctx)
        net.weight.set_data(pkg.nd.array(w0, **ctx))
        tr = pkg.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 0.1, "wd": 0.01})
        nets[pkg] = (net, tr, ctx)

    def step(pkg, x):
        net, tr, ctx = nets[pkg]
        with pkg.autograd.record():
            loss = (net(pkg.nd.array(x, **ctx)) ** 2).sum()
        loss.backward()
        tr.step(4)

    src, dst = (mx, mt) if writer == "jax" else (mt, mx)
    for x in steps[:2]:
        step(src, x)
    path = str(tmp_path / "adam.states")
    nets[src][1].save_states(path)
    nets[dst][0].weight.set_data(dst.nd.array(
        nets[src][0].weight.data().asnumpy(), **nets[dst][2]))
    nets[dst][1].load_states(path)
    nets[dst][1]._optimizer._index_update_count = dict(
        nets[src][1]._optimizer._index_update_count)
    step(src, steps[2])
    step(dst, steps[2])
    _close(nets[dst][0].weight.data().asnumpy(),
           nets[src][0].weight.data().asnumpy())


def test_adam_multi_precision_keeps_fp32_master():
    opt = mt.optimizer.create("adam", learning_rate=0.1,
                              multi_precision=True)
    upd = mt.optimizer.get_updater(opt)
    w = mt.nd.array(np.ones((4,), np.float32), ctx=CPU, dtype="bfloat16")
    ref = mt.nd.array(np.ones((4,), np.float32), ctx=CPU)
    ref_upd = mt.optimizer.get_updater(mt.optimizer.create(
        "adam", learning_rate=0.1))
    for _ in range(3):
        g = np.full((4,), 0.5, np.float32)
        upd(0, mt.nd.array(g, ctx=CPU, dtype="bfloat16"), w)
        ref_upd(0, mt.nd.array(g, ctx=CPU), ref)
    master = upd.states[0][1].asnumpy()
    _close(master, ref.asnumpy(), 1e-6)
    assert w._data.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w._data.float().numpy(),
        torch.from_numpy(master).to(torch.bfloat16).float().numpy())


def test_adam_update_op_writes_in_place_like_jax():
    rs = np.random.RandomState(9)
    arrs = [rs.randn(6).astype(np.float32) for _ in range(2)] + \
        [np.zeros(6, np.float32), np.zeros(6, np.float32)]
    kw = dict(lr=0.01, wd=0.1, rescale_grad=0.5, clip_gradient=0.3)
    j = [mx.nd.array(a) for a in arrs]
    t = [mt.nd.array(a, ctx=CPU) for a in arrs]
    for _ in range(2):
        rj = mx.nd.adam_update(*j, **kw)
        rt = mt.nd.adam_update(*t, **kw)
    assert rt is t[0]
    for a, b in zip(t + [rt], j + [rj]):
        _close(a.asnumpy(), b.asnumpy(), 1e-6)


def _sentences(num=80, vocab=30, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(num):
        n = rng.randint(3, 25)
        s = rng.randint(0, vocab)
        out.append([(s + t) % vocab for t in range(n)])
    return out


@pytest.mark.parametrize("layout", ["NT", "TN"])
def test_bucket_sentence_iter_matches_jax(layout):
    res = []
    for pkg in (mx, mt):
        random.seed(11)
        np.random.seed(11)
        it = pkg.rnn.BucketSentenceIter(_sentences(), 4, buckets=[8, 16, 20],
                                        layout=layout)
        batches = []
        for _ in range(2):
            batches += [(b.bucket_key, b.data[0].asnumpy(),
                         b.label[0].asnumpy(), b.provide_data[0].shape)
                        for b in it]
            it.reset()
        res.append((it.default_bucket_key, it.provide_data[0].shape,
                    batches))
    (jk, jp, jb), (tk, tp, tb) = res
    assert (tk, tp) == (jk, jp)
    assert len(tb) == len(jb) > 0
    for (a, b, c, d), (e, f, g, h) in zip(tb, jb):
        assert a == e and d == h
        np.testing.assert_array_equal(b, f)
        np.testing.assert_array_equal(c, g)


def test_encode_sentences_matches_jax():
    sents = [["a", "b", "c"], ["c", "d"], ["a", "e", "b"]]
    assert mt.rnn.encode_sentences(sents) == mx.rnn.encode_sentences(sents)
    vocab = {"\n": -1, "a": 0, "b": 1}
    with pytest.raises(mt.MXNetError):
        mt.rnn.encode_sentences([["a", "z"]], vocab=vocab)
    assert mt.rnn.encode_sentences([["a", "z"]], vocab=dict(vocab),
                                   unknown_token="b")[0] == [[0, 1]]


def test_sequential_dropout_embedding_match_jax():
    rs = np.random.RandomState(12)
    idx = rs.randint(0, 20, (4, 3)).astype(np.float32)
    nets = []
    for pkg, ctx in ((mx, None), (mt, CPU)):
        with pkg.name.NameManager():
            net = pkg.gluon.nn.Sequential()
            with net.name_scope():
                net.add(pkg.gluon.nn.Embedding(20, 6),
                        pkg.gluon.nn.Dropout(0.4),
                        pkg.gluon.nn.Dense(5, flatten=False, in_units=6))
        net.initialize(pkg.init.Xavier(), **({} if ctx is None
                                             else {"ctx": ctx}))
        nets.append(net)
    j, t = nets
    weights.load_into_block(t, j.collect_params(), ctx=CPU)
    assert len(t) == 3 and isinstance(t[1], mt.gluon.nn.Dropout)
    assert len(t[:2]) == 2
    res = []
    for pkg, net, ctx in ((mx, j, {}), (mt, t, {"ctx": CPU})):
        x = pkg.nd.array(idx, **ctx)
        with pkg.autograd.record(train_mode=False):
            y = net(x)
            loss = (y * y).sum()
        loss.backward()
        res.append((y.asnumpy(), {k: p.grad().asnumpy()
                                  for k, p in net.collect_params().items()}))
    _close(res[1][0], res[0][0])
    for k in res[0][1]:
        _close(res[1][1][k], res[0][1][k])


def test_embedding_wraps_the_padding_index_like_jax():
    rs = np.random.RandomState(13)
    w = rs.randn(7, 3).astype(np.float32)
    idx = np.array([[-1, 0, 6], [2, -1, 3]], np.float32)
    jw, tw = mx.nd.array(w), mt.nd.array(w, ctx=CPU)
    jw.attach_grad()
    tw.attach_grad()
    with mx.autograd.record():
        jy = mx.nd.Embedding(mx.nd.array(idx), jw, input_dim=7, output_dim=3)
        (jy * jy).sum().backward()
    with mt.autograd.record():
        ty = mt.nd.Embedding(mt.nd.array(idx, ctx=CPU), tw, input_dim=7,
                             output_dim=3)
        (ty * ty).sum().backward()
    _close(ty.asnumpy(), jy.asnumpy())
    _close(tw.grad.asnumpy(), jw.grad.asnumpy())


# ---------------------------------------------------------------------------
# Dropout and the samplers: statistics, not values
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_statistics_scale_and_seed(p):
    n = 40000
    x = mt.nd.ones((200, 200), ctx=CPU)
    mt.random.seed(3)
    with mt.autograd.record():
        y = mt.nd.Dropout(x, p=p).asnumpy()
    kept = (y != 0).mean()
    sd = np.sqrt(p * (1 - p) / n)
    assert abs(kept - (1 - p)) <= 4 * sd
    np.testing.assert_allclose(np.unique(y[y != 0]), 1 / (1 - p),
                               rtol=1e-6)
    mt.random.seed(3)
    with mt.autograd.record():
        y2 = mt.nd.Dropout(x, p=p).asnumpy()
    np.testing.assert_array_equal(y, y2)
    np.testing.assert_array_equal(mt.nd.Dropout(x, p=p).asnumpy(), 1.0)
    always = mt.nd.Dropout(x, p=p, mode="always").asnumpy()
    assert 0 < (always == 0).mean() < 1


def test_dropout_axes_share_one_mask_per_slice():
    x = mt.nd.ones((50, 8, 30), ctx=CPU)
    with mt.autograd.record():
        y = mt.nd.Dropout(x, p=0.5, axes=(1,)).asnumpy()
    assert (y == y[:, :1, :]).all()
    assert 0 < (y == 0).mean() < 1


def test_dropout_gradient_is_the_mask():
    x = mt.nd.array(np.random.RandomState(0).randn(30, 30), ctx=CPU)
    x.attach_grad()
    with mt.autograd.record():
        y = mt.nd.Dropout(x, p=0.3)
    y.backward()
    g = x.grad.asnumpy()
    keep = y.asnumpy() != 0
    np.testing.assert_allclose(g[keep], 1 / 0.7, rtol=1e-6)
    assert (g[~keep] == 0).all()


def _moments(a, mean, var, n):
    se = np.sqrt(var / n)
    assert abs(a.mean() - mean) <= 5 * se + 1e-6, (a.mean(), mean)
    # the sample variance's standard error, from the fourth moment
    assert abs(a.var() - var) <= 5 * np.sqrt(
        max(((a - a.mean()) ** 4).mean() - var ** 2, 1e-12) / n) + 1e-6


@pytest.mark.parametrize("name,kw,mean,var", [
    ("uniform", dict(low=-1.0, high=3.0), 1.0, 16 / 12),
    ("normal", dict(loc=2.0, scale=0.5), 2.0, 0.25),
    ("gamma", dict(alpha=2.0, beta=1.5), 3.0, 4.5),
    ("exponential", dict(lam=4.0), 0.25, 1 / 16),
    ("poisson", dict(lam=3.0), 3.0, 3.0),
    ("negative_binomial", dict(k=3, p=0.4), 4.5, 11.25),
    ("generalized_negative_binomial", dict(mu=2.0, alpha=0.5), 2.0, 4.0),
])
def test_sampler_moments(name, kw, mean, var):
    n = 40000
    mt.random.seed(0)
    out = getattr(mt.nd.random, name)(shape=(200, 200), ctx=CPU, **kw)
    assert out.shape == (200, 200) and out.dtype == np.float32
    _moments(out.asnumpy().astype(np.float64), mean, var, n)
    mt.random.seed(0)
    again = getattr(mt.nd.random, name)(shape=(200, 200), ctx=CPU, **kw)
    np.testing.assert_array_equal(out.asnumpy(), again.asnumpy())


def test_tensor_samplers_shapes_and_moments():
    mt.random.seed(1)
    lo = mt.nd.array([0.0, 10.0], ctx=CPU)
    hi = mt.nd.array([1.0, 20.0], ctx=CPU)
    u = mt.nd.sample_uniform(lo, hi, shape=(20000,)).asnumpy()
    assert u.shape == (2, 20000)
    _moments(u[0].astype(np.float64), 0.5, 1 / 12, 20000)
    _moments(u[1].astype(np.float64), 15.0, 100 / 12, 20000)
    nrm = mt.nd.sample_normal(lo, hi, shape=(20000,)).asnumpy()
    _moments(nrm[1].astype(np.float64), 10.0, 400.0, 20000)
    lam = mt.nd.array([2.0, 5.0], ctx=CPU)
    for fn, mean, var in ((mt.nd.sample_exponential, 1 / 5, 1 / 25),
                          (mt.nd.sample_poisson, 5.0, 5.0)):
        v = fn(lam, shape=(20000,)).asnumpy()
        assert v.shape == (2, 20000)
        _moments(v[1].astype(np.float64), mean, var, 20000)
    g = mt.nd.sample_gamma(lam, mt.nd.array([1.0, 2.0], ctx=CPU),
                           shape=(20000,)).asnumpy()
    _moments(g[1].astype(np.float64), 10.0, 20.0, 20000)
    probs = mt.nd.array([[0.1, 0.2, 0.7], [0.5, 0.5, 0.0]], ctx=CPU)
    idx, logp = mt.nd.random.multinomial(probs, shape=(30000,),
                                         get_prob=True)
    idx = idx.asnumpy()
    assert idx.shape == (2, 30000) and idx.dtype == np.int32
    for row, p in enumerate(([0.1, 0.2, 0.7], [0.5, 0.5, 0.0])):
        share = np.bincount(idx[row], minlength=3) / 30000
        sd = np.sqrt(np.asarray(p) * (1 - np.asarray(p)) / 30000)
        assert (np.abs(share - p) <= 4 * sd + 1e-9).all()
    np.testing.assert_allclose(logp.asnumpy(), np.log(
        probs.asnumpy()[np.arange(2)[:, None], idx]), rtol=1e-5)
    data = mt.nd.array(np.arange(20).reshape(10, 2), ctx=CPU)
    sh = mt.nd.random.shuffle(data).asnumpy()
    assert sorted(sh[:, 0].tolist()) == list(range(0, 20, 2))
    np.testing.assert_array_equal(sh[:, 1], sh[:, 0] + 1)


def test_random_state_roundtrip_and_seeded_generators():
    mt.random.seed(5)
    a = mt.nd.random.uniform(shape=(8,), ctx=CPU).asnumpy()
    state = mt.random.get_state()
    b = mt.nd.random.uniform(shape=(8,), ctx=CPU).asnumpy()
    mt.random.set_state(state)
    c = mt.nd.random.uniform(shape=(8,), ctx=CPU).asnumpy()
    np.testing.assert_array_equal(b, c)
    assert not np.array_equal(a, b)
    assert mt.random.uniform is mt.nd.random.uniform
    mt.random.seed(6, ctx=CPU)
    d = mt.nd.random.uniform(shape=(8,), ctx=CPU).asnumpy()
    mt.random.seed(6)
    np.testing.assert_array_equal(
        d, mt.nd.random.uniform(shape=(8,), ctx=CPU).asnumpy())


def test_make_pure_fn_takes_an_explicit_generator():
    from mxnet_tpu_torch.gluon.block import make_pure_fn
    net = mt.gluon.nn.HybridSequential()
    net.add(mt.gluon.nn.Dense(4, in_units=3), mt.gluon.nn.Dropout(0.5))
    net.initialize(ctx=CPU)
    fn, raw, _ = make_pure_fn(net, train=True)
    x = [torch.ones(64, 3)]
    outs = [fn(raw, x, torch.Generator().manual_seed(9))[0][0]
            for _ in range(2)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    assert (outs[0] == 0).any()
    mt.random.seed(9)
    a = fn(raw, x)[0][0]
    mt.random.seed(9)
    torch.testing.assert_close(a, fn(raw, x)[0][0], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The word language model: three truncated-BPTT steps
# ---------------------------------------------------------------------------

def _word_lm(pkg, vocab, emsize, nhid, nlayers, dropout):
    """``examples/gluon/word_language_model/train.py``'s RNNModel (the
    states begin on the input's context)."""
    gluon = pkg.gluon

    class RNNModel(gluon.Block):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.drop = gluon.nn.Dropout(dropout)
                self.encoder = gluon.nn.Embedding(vocab, emsize)
                self.rnn = gluon.rnn.LSTM(nhid, nlayers, dropout=dropout,
                                          input_size=emsize)
                self.decoder = gluon.nn.Dense(vocab, in_units=nhid)
                self.hidden_dim = nhid

        def forward(self, inputs, hidden=None):
            emb = self.drop(self.encoder(inputs))
            if hidden is None:
                kw = {} if pkg is mx else {"ctx": inputs.context}
                hidden = self.rnn.begin_state(batch_size=inputs.shape[1],
                                              **kw)
            output, hidden = self.rnn(emb, hidden)
            output = self.drop(output)
            decoded = self.decoder(output.reshape((-1, self.hidden_dim)))
            return decoded, hidden

    with pkg.name.NameManager():
        return RNNModel()


def _word_lm_steps(pkg, model, data, bptt, batch, steps, ctx):
    trainer = pkg.gluon.Trainer(model.collect_params(), "sgd",
                                {"learning_rate": 1.0,
                                 "rescale_grad": 1.0 / batch})
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    hidden, losses = None, []
    for i in range(0, steps * bptt, bptt):
        x = pkg.nd.array(data[i:i + bptt], **ctx)
        y = pkg.nd.array(data[i + 1:i + 1 + bptt].reshape(-1), **ctx)
        if hidden is not None:
            hidden = [h.detach() for h in hidden]
        with pkg.autograd.record():
            out, hidden = model(x, hidden)
            loss = loss_fn(out, y).sum()
        loss.backward()
        grads = [p.grad() for p in model.collect_params().values()
                 if p.grad_req != "null"]
        pkg.gluon.utils.clip_global_norm(grads, 0.25 * batch)
        trainer.step(bptt)
        losses.append(float(loss.asnumpy()))
    return losses, {k: p.data().asnumpy()
                    for k, p in model.collect_params().items()}


@pytest.mark.parametrize("hybridize", [False, True])
def test_word_lm_three_bptt_steps_match_jax(hybridize):
    vocab, bptt, batch = 60, 8, 8
    rs = np.random.RandomState(14)
    data = rs.randint(0, vocab, (3 * bptt + 1, batch)).astype(np.float32)
    j = _word_lm(mx, vocab, 32, 32, 2, 0.0)
    j.initialize(mx.init.Xavier())
    t = _word_lm(mt, vocab, 32, 32, 2, 0.0)
    t.initialize(mt.init.Xavier(), ctx=CPU)
    weights.load_into_block(t, j.collect_params(), ctx=CPU)
    if hybridize:
        j.hybridize()
        t.hybridize()
    jl, jp = _word_lm_steps(mx, j, data, bptt, batch, 3, {})
    tl, tp = _word_lm_steps(mt, t, data, bptt, batch, 3, {"ctx": CPU})
    for a, b in zip(tl, jl):
        assert abs(a - b) <= 1e-5 * abs(b), (tl, jl)
    for k in jp:
        assert _scaled(tp[k], jp[k]) <= 1e-4, k


def test_word_lm_hybridized_equals_eager_and_frees_each_chunk():
    vocab, bptt, batch = 60, 8, 8
    data = np.random.RandomState(15).randint(
        0, vocab, (3 * bptt + 1, batch)).astype(np.float32)
    runs = []
    for hybridize in (False, True):
        mt.random.seed(1)
        net = _word_lm(mt, vocab, 16, 16, 2, 0.5)
        net.initialize(mt.init.Xavier(), ctx=CPU)
        if hybridize:
            net.hybridize()
        mt.random.seed(2)
        runs.append(_word_lm_steps(mt, net, data, bptt, batch, 3,
                                   {"ctx": CPU}))
    # the same seed, the same random ops in the same order: the same masks
    assert runs[0][0] == runs[1][0]
    for k in runs[0][1]:
        np.testing.assert_array_equal(runs[1][1][k], runs[0][1][k])


def test_rnn_checkpoint_helpers_roundtrip(tmp_path):
    cell = mt.rnn.LSTMCell(4, prefix="c_")
    out, _ = cell.unroll(3, mt.sym.Variable("data"), merge_outputs=True)
    arg = {"c_i2h_weight": mt.nd.ones((16, 2), ctx=CPU)}
    prefix = str(tmp_path / "rnn")
    cb = mt.rnn.do_rnn_checkpoint(cell, prefix, period=2)
    cb(0, out, arg, {})
    cb(1, out, arg, {})
    sym, args, _ = mt.rnn.load_rnn_checkpoint(cell, prefix, 2, ctx=CPU)
    assert sym.list_arguments() == out.list_arguments()
    np.testing.assert_array_equal(args["c_i2h_weight"].asnumpy(), 1.0)
    js, ja, _ = mx.rnn.load_rnn_checkpoint(cell, prefix, 2)
    np.testing.assert_array_equal(ja["c_i2h_weight"].asnumpy(), 1.0)
