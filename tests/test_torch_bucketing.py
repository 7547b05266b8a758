"""``BucketingModule`` in the PyTorch port against the JAX package.

``examples/rnn/bucketing_lstm.py``'s graph (``SequentialRNNCell`` of
``LSTMCell``s unrolled with ``merge_outputs=True``, ``FullyConnected``,
``SoftmaxOutput(use_ignore=True, ignore_label=-1)``) at a small size
(vocabulary 30, 2 layers of 16, embed 8, batch 8, buckets 10 and 20)
trained through ``BucketingModule.fit`` with Adam (lr 0.01,
``rescale_grad`` 1/batch) and ``Perplexity(ignore_label=-1)`` in both
packages, from the JAX module's Xavier weights, on ``BucketSentenceIter``
batches drawn under the same Python and numpy seeds.

Tolerances: parameters within 1e-4 of each tensor's largest magnitude
and ``Perplexity`` within 1e-4 relative (measured on this CPU: 3.1e-6
and 2.3e-6 after 2 epochs); the port's fused batch step and its
phase-split path bit-equal.
"""
import pickle
import random

import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401
from mxnet_tpu_torch import weights

CPU = mt.cpu()
VOCAB, HIDDEN, EMBED, LAYERS, BATCH = 30, 16, 8, 2, 8


def _sentences(num=64, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(num):
        n = rng.randint(5, 20)
        s = rng.randint(0, VOCAB)
        out.append([(s + t) % VOCAB for t in range(n)])
    return out


def _sym_gen(pkg):
    """``examples/rnn/bucketing_lstm.py``'s ``sym_gen``."""
    def sym_gen(seq_len):
        data = pkg.sym.Variable("data")
        label = pkg.sym.Variable("softmax_label")
        embed = pkg.sym.Embedding(data=data, input_dim=VOCAB,
                                  output_dim=EMBED, name="embed")
        stack = pkg.rnn.SequentialRNNCell()
        for i in range(LAYERS):
            stack.add(pkg.rnn.LSTMCell(num_hidden=HIDDEN,
                                       prefix="lstm_l%d_" % i))
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = pkg.sym.Reshape(outputs, shape=(-1, HIDDEN))
        pred = pkg.sym.FullyConnected(data=pred, num_hidden=VOCAB,
                                      name="pred")
        label = pkg.sym.Reshape(label, shape=(-1,))
        pred = pkg.sym.SoftmaxOutput(data=pred, label=label, use_ignore=True,
                                     ignore_label=-1, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def _iter(pkg, buckets=(10, 20)):
    random.seed(1)
    np.random.seed(1)
    return pkg.rnn.BucketSentenceIter(_sentences(), BATCH,
                                      buckets=list(buckets))


def _module(pkg, init=None, buckets=(10, 20)):
    it = _iter(pkg, buckets)
    kw = {} if pkg is mx else {"context": CPU}
    mod = pkg.mod.BucketingModule(_sym_gen(pkg),
                                  default_bucket_key=it.default_bucket_key,
                                  **kw)
    mod.bind(it.provide_data, it.provide_label)
    if init is None:
        mod.init_params(pkg.init.Xavier())
    else:
        mod.init_params(arg_params=init, aux_params={})
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": 0.01,
                                         "rescale_grad": 1.0 / BATCH})
    return mod, it


def _fit(pkg, mod, it, epochs=2, seed=2):
    random.seed(seed)
    np.random.seed(seed)
    met = pkg.metric.Perplexity(ignore_label=-1)
    mod.fit(it, eval_metric=met, num_epoch=epochs)
    arg, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in arg.items()}, met.get()[1]


def _params(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _scaled(got, want):
    return max(float(np.abs(got[k] - want[k]).max()
                     / max(np.abs(want[k]).max(), 1e-30)) for k in want)


@pytest.fixture(scope="module")
def jax_run():
    mod, it = _module(mx)
    init = _params(mod)
    params, ppl = _fit(mx, mod, it)
    return init, params, ppl, mod


@pytest.mark.parametrize("fused", [True, False])
def test_bucketing_fit_matches_jax(jax_run, fused, monkeypatch):
    init, jparams, jppl, _ = jax_run
    if not fused:
        monkeypatch.setenv("MXNET_MODULE_FUSED_STEP", "0")
    mod, it = _module(mt, init)
    params, ppl = _fit(mt, mod, it)
    assert sorted(mod._buckets) == [10, 20]
    assert _scaled(params, jparams) <= 1e-4
    assert abs(ppl - jppl) <= 1e-4 * jppl
    assert np.isfinite(ppl) and ppl < VOCAB
    assert mod._fused_fallback_reason is None if fused else \
        mod._fused_fallback_reason.code == "env_pin"


def test_bucketing_fused_equals_phase_split(jax_run, monkeypatch):
    init = jax_run[0]
    runs = []
    for pin in ("1", "0"):
        monkeypatch.setenv("MXNET_MODULE_FUSED_STEP", pin)
        mod, it = _module(mt, init)
        runs.append(_fit(mt, mod, it))
    (fp, fppl), (sp, sppl) = runs
    assert fppl == sppl
    for k in fp:
        np.testing.assert_array_equal(fp[k], sp[k])


def test_bucket_modules_list_parameters_in_one_order():
    mod, _ = _module(mt, buckets=(5, 10, 20))
    names = [_sym_gen(mt)(k)[0].list_arguments() for k in (5, 10, 20)]
    assert names[0] == names[1] == names[2]
    jnames = _sym_gen(mx)(10)[0].list_arguments()
    assert names[1] == jnames


def _batch(pkg, key, seed):
    rs = np.random.RandomState(seed)
    data = rs.randint(0, VOCAB, (BATCH, key)).astype(np.float32)
    label = np.concatenate([data[:, 1:], np.full((BATCH, 1), -1.0)], 1) \
        .astype(np.float32)
    label[: BATCH // 2, key - 3:] = -1            # padded tails
    kw = {} if pkg is mx else {"ctx": CPU}
    return pkg.io.DataBatch(
        [pkg.nd.array(data, **kw)], [pkg.nd.array(label, **kw)], pad=0,
        bucket_key=key,
        provide_data=[pkg.io.DataDesc("data", data.shape)],
        provide_label=[pkg.io.DataDesc("softmax_label", label.shape)])


def test_alternating_buckets_keep_adam_moments_per_parameter(jax_run):
    init = jax_run[0]
    out = []
    for pkg in (mx, mt):
        mod, _ = _module(pkg, init)
        for step, key in enumerate((10, 20, 10, 20, 10)):
            mod.forward_backward(_batch(pkg, key, step))
            mod.update()
        out.append((_params(mod), mod))
    (jp, jmod), (tp, tmod) = out
    assert _scaled(tp, jp) <= 1e-4
    js = pickle.loads(jmod._curr_module._updater.get_states())
    ts = pickle.loads(tmod._curr_module._updater.get_states())
    assert sorted(ts) == sorted(js)
    for i in js:
        for a, b in zip(ts[i], js[i]):
            np.testing.assert_allclose(a, b, rtol=1e-4,
                                       atol=1e-4 * np.abs(b).max())
    # the default bucket (20) is bound first: one switch per batch, each
    # copying every parameter out of the current module and into the next
    n = len(tp)
    assert tmod.bucket_switches == 5
    assert tmod.param_copies == 5 * 2 * n


def test_softmax_output_zeroes_the_padded_positions_gradient():
    rs = np.random.RandomState(3)
    x = rs.randn(6, 5).astype(np.float32)
    lab = np.array([1, -1, 3, -1, 0, 4], np.float32)
    grads = []
    for pkg, kw in ((mx, {}), (mt, {"ctx": CPU})):
        s = pkg.sym.SoftmaxOutput(data=pkg.sym.Variable("data"),
                                  label=pkg.sym.Variable("label"),
                                  use_ignore=True, ignore_label=-1)
        args = {"data": pkg.nd.array(x, **kw),
                "label": pkg.nd.array(lab, **kw)}
        g = {"data": pkg.nd.zeros((6, 5), **kw)}
        ex = s.bind(args=args, args_grad=g, grad_req={"data": "write",
                                                      "label": "null"},
                    **({"ctx": CPU} if pkg is mt else {}))
        ex.forward(is_train=True)
        ex.backward()
        grads.append(g["data"].asnumpy())
    jg, tg = grads
    assert (tg[lab == -1] == 0).all()
    assert np.abs(tg[lab != -1]).min() > 0
    np.testing.assert_allclose(tg, jg, rtol=1e-6, atol=1e-7)


def test_jax_params_and_adam_states_carry_into_the_port(jax_run):
    """The JAX module's trained parameters, pickled Adam states and update
    counts load into a port BucketingModule (``weights.load_into_module``)
    and one more epoch in each package lands within the tolerances."""
    init = jax_run[0]
    jmod, jit = _module(mx, init)
    _fit(mx, jmod, jit, epochs=1)
    jarg, jaux = jmod.get_params()
    jstates = pickle.loads(jmod._curr_module._updater.get_states())
    counts = dict(jmod._curr_module._optimizer._index_update_count)
    tmod, _ = _module(mt, init)
    weights.load_into_module(tmod, jarg, jaux, opt_states=jstates,
                             update_counts=counts)
    arg, aux, states = weights.module_to_numpy(tmod)
    for k in arg:
        np.testing.assert_array_equal(arg[k], jarg[k].asnumpy())
    assert sorted(states) == sorted(jstates)
    # the iterators shuffle in place: fresh ones for the second epoch
    jp, jppl = _fit(mx, jmod, _iter(mx), epochs=1, seed=5)
    tp, tppl = _fit(mt, tmod, _iter(mt), epochs=1, seed=5)
    assert _scaled(tp, jp) <= 1e-4
    assert abs(tppl - jppl) <= 1e-4 * jppl


def test_bucketing_score_matches_jax(jax_run):
    _, jparams, _, jmod = jax_run
    random.seed(4)
    np.random.seed(4)
    jit = mx.rnn.BucketSentenceIter(_sentences(seed=9), BATCH,
                                    buckets=[10, 20])
    random.seed(4)
    np.random.seed(4)
    want = dict(jmod.score(jit, mx.metric.Perplexity(ignore_label=-1)))
    tmod, _ = _module(mt, jparams)
    random.seed(4)
    np.random.seed(4)
    tit = mt.rnn.BucketSentenceIter(_sentences(seed=9), BATCH,
                                    buckets=[10, 20])
    random.seed(4)
    np.random.seed(4)
    got = dict(tmod.score(tit, mt.metric.Perplexity(ignore_label=-1)))
    assert abs(got["perplexity"] - want["perplexity"]) <= \
        1e-4 * want["perplexity"]
    assert tmod.data_names == ["data"] and tmod.symbol is not None
    assert tmod.output_shapes[0][1][1] == VOCAB


def test_bucketing_module_needs_a_default_key_and_a_bind():
    with pytest.raises(mt.MXNetError):
        mt.mod.BucketingModule(_sym_gen(mt), context=CPU)
    mod = mt.mod.BucketingModule(_sym_gen(mt), default_bucket_key=10,
                                 context=CPU)
    assert mod.data_names == ("data",)
    with pytest.raises(mt.MXNetError):
        mod.get_params()
