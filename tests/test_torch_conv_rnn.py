"""The recurrent family's rest against the JAX package: the nine Gluon
convolutional cells of ``gluon.contrib.rnn``, ``VariationalDropoutCell``,
``mx.rnn``'s convolutional cells, a small ConvLSTM encoder-forecaster
(``chip_smoke.convlstm_ef``/``convlstm_ef_symbol``, the card phase's
model at 2 layers of 8 channels on 8x8, 3+3 frames) stepped once in Gluon
and in ``Module``, and the word LM with its decoder tied to its
embedding.

Both packages get the same seeded numpy inputs and weights. Forward
values agree to TOL, gradients and one optimizer step to GTOL (fp32 on
both CPUs; the convolutions sum in different orders).
"""
import importlib.util
import os

import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke_conv_rnn", os.path.join(ROOT, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

TOL = 1e-5
GTOL = 1e-4
PKGS = (mx, mt)


def _close(a, b, tol, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(float(np.abs(b).max()), 1.0)
    err = float(np.abs(a - b).max()) / scale
    assert err <= tol, (what, err)


# -- the nine Gluon convolutional cells ------------------------------------

_SPATIAL = {1: (7,), 2: (5, 6), 3: (4, 3, 5)}
_LAYOUTS = {1: ("NCW", "NWC"), 2: ("NCHW", "NHWC"), 3: ("NCDHW", "NDHWC")}


def _gluon_cell_run(pkg, cls, dims, layout, w, x, head, i2h_pad):
    ctx = pkg.cpu()
    spatial = _SPATIAL[dims]
    shape = (3,) + spatial if layout[1] == "C" else spatial + (3,)
    with pkg.name.NameManager():
        cell = getattr(pkg.gluon.contrib.rnn, cls)(
            input_shape=shape, hidden_channels=4, i2h_kernel=3,
            h2h_kernel=3, i2h_pad=i2h_pad, conv_layout=layout)
    cell.initialize(ctx=ctx)
    params = cell.collect_params()
    if w is None:
        return {k: p.shape for k, p in params.items()}, cell
    for k, p in params.items():
        p.set_data(pkg.nd.array(w[k], ctx=ctx))
    xa = pkg.nd.array(x, ctx=ctx)
    xa.attach_grad()
    with pkg.autograd.record():
        out, states = cell.unroll(3, xa, layout="NTC", merge_outputs=True)
        loss = (out * pkg.nd.array(head, ctx=ctx)).sum()
        for s in states:
            loss = loss + s.sum()
    loss.backward()
    return (out.asnumpy(), [s.asnumpy() for s in states],
            {k: p.grad().asnumpy() for k, p in params.items()},
            xa.grad.asnumpy(), cell)


@pytest.mark.parametrize("layout_i", [0, 1], ids=["channels_first",
                                                  "channels_last"])
@pytest.mark.parametrize("family", ["RNN", "LSTM", "GRU"])
@pytest.mark.parametrize("dims", [1, 2, 3])
def test_gluon_conv_cell_matches_jax(dims, family, layout_i):
    """Outputs, states and the gradients of the parameters and the input
    through a 3-step ``unroll``; the parameter names, shapes, gate order
    and ``state_info`` are the JAX cell's."""
    cls = "Conv%dD%sCell" % (dims, family)
    layout = _LAYOUTS[dims][layout_i]
    i2h_pad = 1 if dims != 2 else (1, 0)     # the state shrinks along W
    shapes, jcell = _gluon_cell_run(mx, cls, dims, layout, None, None, None,
                                    i2h_pad)
    rs = np.random.RandomState(dims * 10 + layout_i)
    w = {k: (rs.randn(*s) * 0.3).astype(np.float32)
         for k, s in shapes.items()}
    xshape = (2, 3) + jcell._input_shape
    x = rs.randn(*xshape).astype(np.float32)
    sshape = jcell.state_info(2)[0]["shape"]
    head = rs.randn(2, 3, *sshape[1:]).astype(np.float32)
    got = _gluon_cell_run(mt, cls, dims, layout, w, x, head, i2h_pad)
    want = _gluon_cell_run(mx, cls, dims, layout, w, x, head, i2h_pad)
    assert got[4].state_info(2) == want[4].state_info(2)
    assert sorted(got[2]) == sorted(want[2])
    _close(got[0], want[0], TOL, "outputs")
    for g, e in zip(got[1], want[1]):
        _close(g, e, TOL, "states")
    for k in want[2]:
        _close(got[2][k], want[2][k], GTOL, k)
    _close(got[3], want[3], GTOL, "input grad")


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "port"])
def test_gluon_conv_cell_rejects_even_h2h_and_wrong_rank(pkg):
    crnn = pkg.gluon.contrib.rnn
    with pytest.raises(ValueError, match="odd"):
        crnn.Conv2DLSTMCell((3, 8, 8), 4, i2h_kernel=3, h2h_kernel=2)
    with pytest.raises(ValueError, match="input_shape"):
        crnn.Conv2DGRUCell((3, 8), 4, i2h_kernel=3, h2h_kernel=3)


# -- VariationalDropoutCell -------------------------------------------------

def _vardrop(pkg, p):
    ctx = pkg.cpu()
    with pkg.name.NameManager():
        base = pkg.gluon.rnn.LSTMCell(5, input_size=3)
    cell = pkg.gluon.contrib.rnn.VariationalDropoutCell(
        base, drop_inputs=p, drop_states=p, drop_outputs=p)
    cell.initialize(ctx=ctx)
    return cell, ctx


def _steps(pkg, cell, ctx, x, n=4):
    states = cell.begin_state(2, ctx=ctx)
    outs = []
    for _ in range(n):
        o, states = cell(pkg.nd.array(x, ctx=ctx), states)
        outs.append(o.asnumpy())
    return outs


def test_variational_dropout_one_mask_per_sequence():
    """One mask for inputs, states and outputs across every step (the
    zero pattern of the output is the same at each step), a fresh one
    after ``reset()``, drawn from ``mx.random.seed``'s generator."""
    cell, ctx = _vardrop(mt, 0.5)
    x = np.ones((2, 3), np.float32)
    mt.random.seed(3)
    with mt.autograd.record():
        outs = _steps(mt, cell, ctx, x)
    masks = (cell.drop_inputs_mask, cell.drop_states_mask,
             cell.drop_outputs_mask)
    assert all(m is not None for m in masks)
    zeros = [o == 0 for o in outs]
    assert zeros[0].any() and all((z == zeros[0]).all() for z in zeros)
    first = masks[2].asnumpy()
    assert set(np.unique(first)) <= {0.0, 2.0}
    cell.reset()
    assert cell.drop_outputs_mask is None
    with mt.autograd.record():
        _steps(mt, cell, ctx, x, n=1)
    assert not np.array_equal(cell.drop_outputs_mask.asnumpy(), first)
    mt.random.seed(3)
    cell.reset()
    with mt.autograd.record():
        _steps(mt, cell, ctx, x, n=1)
    np.testing.assert_array_equal(cell.drop_outputs_mask.asnumpy(), first)


def test_variational_dropout_identity_at_inference_and_jax_at_p0():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 3).astype(np.float32)
    cell, ctx = _vardrop(mt, 0.5)
    w = {k: rs.randn(*p.shape).astype(np.float32) * 0.3
         for k, p in cell.collect_params().items()}
    for k, p in cell.collect_params().items():
        p.set_data(mt.nd.array(w[k], ctx=ctx))
    plain = _steps(mt, cell.base_cell, ctx, x)
    cell.reset()
    for a, b in zip(_steps(mt, cell, ctx, x), plain):
        np.testing.assert_array_equal(a, b)      # not training: no masks
    assert cell.drop_inputs_mask is None
    got = []
    for pkg in PKGS:
        c, cx = _vardrop(pkg, 0.0)
        for k, p in c.collect_params().items():
            p.set_data(pkg.nd.array(w[k], ctx=cx))
        with pkg.autograd.record():
            got.append(_steps(pkg, c, cx, x))
    for a, b in zip(*got):
        _close(a, b, TOL, "p=0")


# -- mx.rnn's convolutional cells -------------------------------------------

def _sym_cell_run(pkg, cls, vals, heads, default_begin=False):
    cell = getattr(pkg.rnn, cls)(input_shape=(2, 3, 6, 6), num_hidden=4,
                                 prefix="c_")
    n_states = len(cell.state_info)
    data = pkg.sym.Variable("data")
    begin = None if default_begin else [pkg.sym.Variable("s%d" % i)
                                        for i in range(n_states)]
    out, st = cell.unroll(3, data, begin_state=begin, layout="NTC",
                          merge_outputs=True)
    net = pkg.sym.Group([out] + list(st))
    shapes = {"data": (2, 3, 3, 6, 6)}
    if not default_begin:
        shapes.update({"s%d" % i: (2, 4, 6, 6) for i in range(n_states)})
    arg_shapes, out_shapes, _ = net.infer_shape(**shapes)
    names = net.list_arguments()
    if vals is None:
        return dict(zip(names, arg_shapes)), out_shapes, cell
    ctx = pkg.cpu()
    args = {n: pkg.nd.array(vals[n], ctx=ctx) for n in names}
    grads = {n: pkg.nd.zeros(vals[n].shape, ctx=ctx) for n in names}
    ex = net.bind(ctx=ctx, args=args, args_grad=grads)
    outs = [o.asnumpy() for o in ex.forward(is_train=True)]
    ex.backward([pkg.nd.array(h, ctx=ctx) for h in heads])
    return names, outs, {n: grads[n].asnumpy() for n in names}


@pytest.mark.parametrize("cls", ["ConvRNNCell", "ConvLSTMCell",
                                 "ConvGRUCell"])
def test_symbolic_conv_cell_matches_jax(cls):
    """``unroll`` of each cell, begin states given as inputs: outputs,
    last states and the gradients of every argument, under the JAX
    package's argument names."""
    shapes, out_shapes, cell = _sym_cell_run(mx, cls, None, None)
    rs = np.random.RandomState(len(cls))
    vals = {n: (rs.randn(*s) * 0.3).astype(np.float32)
            for n, s in shapes.items()}
    heads = [rs.randn(*s).astype(np.float32) for s in out_shapes]
    got = _sym_cell_run(mt, cls, vals, heads)
    want = _sym_cell_run(mx, cls, vals, heads)
    assert got[0] == want[0]
    for g, e in zip(got[1], want[1]):
        _close(g, e, TOL, "outputs")
    for n in want[0]:
        _close(got[2][n], want[2][n], GTOL, n)
    assert mt.rnn.ConvGRUCell((2, 3, 6, 6), 4).state_info == \
        mx.rnn.ConvGRUCell((2, 3, 6, 6), 4).state_info


def test_symbolic_conv_cell_default_begin_state():
    """Without a ``begin_state`` the port's zero states take their batch
    from the 5-D input. The JAX package's base rule sums the input over
    axes 0-2 but N only, which leaves the spatial axes in: its states
    come out with batch N*H*W and the graph fails shape inference (a
    reference fault, ROADMAP Queue 3)."""
    _, out_shapes, _ = _sym_cell_run(mt, "ConvLSTMCell", None, None,
                                     default_begin=True)
    assert out_shapes == [(2, 3, 4, 6, 6), (2, 4, 6, 6), (2, 4, 6, 6)]
    with pytest.raises(mx.base.MXNetError, match="broadcast"):
        _sym_cell_run(mx, "ConvLSTMCell", None, None, default_begin=True)


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "port"])
def test_symbolic_conv_cell_state_shape_from_the_i2h_probe(pkg):
    """The state's spatial shape is the i2h convolution's output, probed
    with shape inference (stride 2, pad 0 here); an even h2h kernel
    raises."""
    cell = pkg.rnn.ConvLSTMCell(input_shape=(2, 3, 9, 9), num_hidden=5,
                                i2h_kernel=(3, 3), i2h_stride=(2, 2),
                                i2h_pad=(0, 0))
    assert cell.state_shape == [(0, 5, 4, 4), (0, 5, 4, 4)]
    with pytest.raises(pkg.base.MXNetError, match="odd"):
        pkg.rnn.ConvRNNCell(input_shape=(2, 3, 9, 9), num_hidden=5,
                            h2h_kernel=(2, 3))


def test_bind_defaults_to_write_gradients():
    """``Symbol.bind`` with gradient arrays and no ``grad_req`` writes the
    gradients, as the JAX package and upstream do (``grad_req="write"``);
    an argument without a gradient array takes none. The port's default
    was ``"null"``: the arrays stayed zero without a word (ROADMAP Queue
    3, fixed in this slice)."""
    got = []
    for pkg in PKGS:
        ctx = pkg.cpu()
        x, w = pkg.sym.Variable("x"), pkg.sym.Variable("w")
        net = pkg.sym.FullyConnected(x, weight=w, no_bias=True, num_hidden=3)
        args = {"x": pkg.nd.ones((2, 4), ctx=ctx),
                "w": pkg.nd.ones((3, 4), ctx=ctx) * 0.5}
        grads = {"w": pkg.nd.zeros((3, 4), ctx=ctx)}
        ex = net.bind(ctx=ctx, args=args, args_grad=grads)
        ex.forward(is_train=True)
        ex.backward([pkg.nd.ones((2, 3), ctx=ctx)])
        got.append(grads["w"].asnumpy())
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(got[1], np.full((3, 4), 2.0, np.float32))


# -- the small encoder-forecaster -------------------------------------------

_EF = cs._CONVLSTM[True]


def _ef_gluon_step(pkg, init, x, y, hybridize):
    ctx = pkg.cpu()
    net = cs.convlstm_ef(pkg, _EF)
    net.initialize(ctx=ctx)
    params = net.collect_params()
    if init is None:
        return {k: p.shape for k, p in params.items()}
    for k, p in params.items():
        p.set_data(pkg.nd.array(init[k], ctx=ctx))
    net.hybridize(hybridize)
    loss_fn = pkg.gluon.loss.SigmoidBinaryCrossEntropyLoss()
    tr = pkg.gluon.Trainer(params, "rmsprop",
                           {"learning_rate": cs._CONVLSTM_LR,
                            "gamma1": cs._CONVLSTM_GAMMA1})
    with pkg.autograd.record():
        loss = loss_fn(net(pkg.nd.array(x, ctx=ctx),
                           *cs.convlstm_ef_states(pkg, _EF, ctx)),
                       pkg.nd.array(y, ctx=ctx)).mean()
    loss.backward()
    tr.step(1)
    return float(loss.asscalar()), {k: p.data().asnumpy()
                                    for k, p in params.items()}


def _ef_module_step(pkg, init, x, y):
    ctx = pkg.cpu()
    mod = pkg.mod.Module(cs.convlstm_ef_symbol(pkg, _EF),
                         data_names=("data",), label_names=("label",),
                         context=ctx)
    mod.bind(data_shapes=[("data", x.shape)], label_shapes=[("label",
                                                              y.shape)])
    mod.init_params()
    arg, aux = mod.get_params()
    assert sorted(arg) == sorted(init)
    mod.set_params({k: pkg.nd.array(init[k], ctx=ctx) for k in arg}, aux)
    mod.init_optimizer(optimizer="rmsprop", optimizer_params={
        "learning_rate": cs._CONVLSTM_LR, "gamma1": cs._CONVLSTM_GAMMA1,
        "rescale_grad": 1.0})
    mod.forward(pkg.io.DataBatch([pkg.nd.array(x, ctx=ctx)],
                                 [pkg.nd.array(y, ctx=ctx)]), is_train=True)
    loss = float(mod.get_outputs()[0].asnumpy())
    mod.backward()
    mod.update()
    return loss, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_encoder_forecaster_step1_gluon_and_module_match_jax():
    """Step 1 (RMSProp) of the small encoder-forecaster: the port's
    eager, hybridized and ``Module`` steps against the JAX package's
    eager step, within TOL in loss and GTOL of each parameter's largest
    value; hybridized equals eager within TOL."""
    x, y = cs.moving_sprites(_EF, _EF["batch"], 0)
    init = cs.convlstm_init(_EF, _ef_gluon_step(mx, None, x, y, False), 1)
    want = _ef_gluon_step(mx, init, x, y, False)
    eager = _ef_gluon_step(mt, init, x, y, False)
    hyb = _ef_gluon_step(mt, init, x, y, True)
    mod = _ef_module_step(mt, init, x, y)
    for got in (eager, hyb, mod):
        assert abs(got[0] - want[0]) <= TOL, (got[0], want[0])
        for k in want[1]:
            _close(got[1][k], want[1][k], GTOL, k)
    assert abs(hyb[0] - eager[0]) <= TOL


def test_moving_sprites_shapes_and_bounds():
    x, y = cs.moving_sprites(_EF, 3, 5)
    s = _EF["frame"] // _EF["patch"]
    assert x.shape == (3, _EF["frames_in"], _EF["patch"] ** 2, s, s)
    assert y.shape == (3, _EF["frames_out"], _EF["patch"] ** 2, s, s)
    assert 0.0 <= x.min() and x.max() <= 1.0 and x.max() > 0.5
    again = cs.moving_sprites(_EF, 3, 5)
    np.testing.assert_array_equal(x, again[0])


# -- the word LM with its decoder tied to its embedding ---------------------

_TIED = dict(vocab=50, emsize=16, nhid=16, nlayers=2, dropout=0.0, bptt=5,
             batch=4)


def _tied_lm(pkg):
    """``examples/gluon/word_language_model``'s RNNModel with ``--tied``:
    the decoder shares the embedding's parameters
    (``nn.Dense(vocab, in_units=nhid, params=encoder.params)``)."""
    gluon = pkg.gluon
    cfg = _TIED

    class RNNModel(gluon.Block):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.encoder = gluon.nn.Embedding(cfg["vocab"],
                                                  cfg["emsize"])
                self.rnn = gluon.rnn.LSTM(cfg["nhid"], cfg["nlayers"],
                                          input_size=cfg["emsize"])
                self.decoder = gluon.nn.Dense(cfg["vocab"],
                                              in_units=cfg["nhid"],
                                              params=self.encoder.params)

        def forward(self, inputs, hidden):
            output, hidden = self.rnn(self.encoder(inputs), hidden)
            return self.decoder(output.reshape((-1, cfg["nhid"]))), hidden

    with pkg.name.NameManager():
        return RNNModel()


def _tied_steps(pkg, init, tokens, n=2):
    ctx = pkg.cpu()
    cfg = _TIED
    model = _tied_lm(pkg)
    model.initialize(ctx=ctx)
    params = model.collect_params()
    if init is None:
        return {k: p.shape for k, p in params.items()}
    for k, p in params.items():
        p.set_data(pkg.nd.array(init[k], ctx=ctx))
    tr = pkg.gluon.Trainer(params, "sgd", {"learning_rate": 0.5})
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    hidden = model.rnn.begin_state(batch_size=cfg["batch"], ctx=ctx)
    losses, grads = [], []
    for i in range(n):
        s = i * cfg["bptt"]
        x = pkg.nd.array(tokens[s:s + cfg["bptt"]], ctx=ctx)
        y = pkg.nd.array(tokens[s + 1:s + 1 + cfg["bptt"]].reshape(-1),
                         ctx=ctx)
        hidden = [h.detach() for h in hidden]
        with pkg.autograd.record():
            out, hidden = model(x, hidden)
            loss = loss_fn(out, y).mean()
        loss.backward()
        grads.append({k: p.grad().asnumpy() for k, p in params.items()})
        tr.step(1)
        losses.append(float(loss.asscalar()))
    return losses, grads, {k: p.data().asnumpy() for k, p in params.items()}


def test_tied_word_lm_two_steps_match_jax():
    """One ``…embedding0_weight`` in each package (the decoder's weight is
    the embedding's), two steps within TOL in loss and GTOL in the
    gradients and parameters; the tied weight's gradient is the sum of
    its two uses (checked against an untied twin with the same
    values)."""
    shapes = _tied_steps(mx, None, None)
    assert sorted(shapes) == sorted(_tied_steps(mt, None, None))
    tied = [k for k in shapes if k.endswith("embedding0_weight")]
    assert len(tied) == 1 and not [k for k in shapes if "dense" in k
                                   and k.endswith("weight")]
    rs = np.random.RandomState(0)
    init = {k: (rs.randn(*s) * 0.1).astype(np.float32)
            for k, s in shapes.items()}
    tokens = rs.randint(0, _TIED["vocab"], (2 * _TIED["bptt"] + 1,
                                            _TIED["batch"])).astype(
                                                np.float32)
    got = _tied_steps(mt, init, tokens)
    want = _tied_steps(mx, init, tokens)
    for a, b in zip(got[0], want[0]):
        assert abs(a - b) <= TOL, (got[0], want[0])
    for g, e in zip(got[1], want[1]):
        for k in e:
            _close(g[k], e[k], GTOL, k)
    for k in want[2]:
        _close(got[2][k], want[2][k], GTOL, k)
    # the sum of the two uses: the embedding's gradient plus the decoder's
    ctx = mt.cpu()
    emb = mt.nd.array(init[tied[0]], ctx=ctx)
    emb.attach_grad()
    dec = mt.nd.array(init[tied[0]], ctx=ctx)
    dec.attach_grad()
    x = mt.nd.array(tokens[:_TIED["bptt"]], ctx=ctx)
    y = mt.nd.array(tokens[1:1 + _TIED["bptt"]].reshape(-1), ctx=ctx)
    model = _tied_lm(mt)
    model.initialize(ctx=ctx)
    for k, p in model.collect_params().items():
        p.set_data(mt.nd.array(init[k], ctx=ctx))
    with mt.autograd.record():
        e = mt.nd.Embedding(x, emb, input_dim=_TIED["vocab"],
                            output_dim=_TIED["emsize"])
        out, _ = model.rnn(e, model.rnn.begin_state(
            batch_size=_TIED["batch"], ctx=ctx))
        bias = [p.data() for k, p in model.collect_params().items()
                if k.endswith("embedding0_bias")][0]
        logits = mt.nd.FullyConnected(out.reshape((-1, _TIED["nhid"])), dec,
                                      bias, num_hidden=_TIED["vocab"])
        loss = mt.gluon.loss.SoftmaxCrossEntropyLoss()(logits, y).mean()
    loss.backward()
    _close(got[1][0][tied[0]], emb.grad.asnumpy() + dec.grad.asnumpy(),
           GTOL, "tied gradient")


# -- weights carried across -------------------------------------------------

def test_weights_carry_conv_cells_module_and_tied_lm():
    """JAX parameters as numpy arrays load into the port by name: a
    Gluon conv cell (``load_into_block``), the encoder-forecaster's
    ``Module`` of ``mx.rnn`` conv cells (``load_into_module``), and the
    tied word LM; each then computes what the JAX model computes."""
    rs = np.random.RandomState(5)
    with mx.name.NameManager():
        jcell = mx.gluon.contrib.rnn.Conv2DGRUCell((6, 6, 3), 4, 3, 3,
                                                   i2h_pad=1,
                                                   conv_layout="NHWC")
    jcell.initialize(ctx=mx.cpu())
    with mt.name.NameManager():
        pcell = mt.gluon.contrib.rnn.Conv2DGRUCell((6, 6, 3), 4, 3, 3,
                                                   i2h_pad=1,
                                                   conv_layout="NHWC")
    pcell.initialize(ctx=mt.cpu())
    mt.weights.load_into_block(pcell, jcell.collect_params(), ctx=mt.cpu())
    x = rs.randn(2, 3, 6, 6, 3).astype(np.float32)
    want = jcell.unroll(3, mx.nd.array(x), merge_outputs=True)[0].asnumpy()
    got = pcell.unroll(3, mt.nd.array(x, ctx=mt.cpu()),
                       merge_outputs=True)[0].asnumpy()
    _close(got, want, TOL, "conv cell")

    x, y = cs.moving_sprites(_EF, _EF["batch"], 2)
    outs = []
    for pkg in PKGS:
        mod = pkg.mod.Module(cs.convlstm_ef_symbol(pkg, _EF),
                             data_names=("data",), label_names=("label",),
                             context=pkg.cpu())
        mod.bind(data_shapes=[("data", x.shape)],
                 label_shapes=[("label", y.shape)], for_training=False)
        if pkg is mx:
            mod.init_params(initializer=mx.init.Xavier())
            arg, aux = mod.get_params()
            arg = {k: v.asnumpy() for k, v in arg.items()}
        else:
            mod.init_params()
            mt.weights.load_into_module(mod, arg, {})
        mod.forward(pkg.io.DataBatch([pkg.nd.array(x, ctx=pkg.cpu())],
                                     [pkg.nd.array(y, ctx=pkg.cpu())]),
                    is_train=False)
        outs.append(float(mod.get_outputs()[0].asnumpy()))
    assert abs(outs[0] - outs[1]) <= TOL, outs

    jlm = _tied_lm(mx)
    jlm.initialize(mx.init.Xavier(), ctx=mx.cpu())
    plm = _tied_lm(mt)
    plm.initialize(ctx=mt.cpu())
    mt.weights.load_into_block(plm, jlm.collect_params(), ctx=mt.cpu())
    tok = rs.randint(0, _TIED["vocab"], (_TIED["bptt"], _TIED["batch"]))
    tok = tok.astype(np.float32)
    res = []
    for pkg, m in ((mx, jlm), (mt, plm)):
        ctx = pkg.cpu()
        h = m.rnn.begin_state(batch_size=_TIED["batch"], ctx=ctx)
        res.append(m(pkg.nd.array(tok, ctx=ctx), h)[0].asnumpy())
    _close(res[1], res[0], TOL, "tied LM")
