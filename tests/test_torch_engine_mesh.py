"""The serving and decode engines on partitioned meshes in the PyTorch
port, against the port's one-device engines and the JAX package's mesh
engines on its 8 virtual CPU devices.

- Serving: a two-layer FC net over ``{"dp": 1, "mp": 8}`` (eight
  Contexts, one thread a member, both layers' weights and biases
  sharded over ``mp``) is bit-equal per bucket to the port's one-device
  engine (an op reads the gathered whole weight, so each bucket computes
  the one-device forward), and within 1e-5 of the largest value of the
  JAX package's mesh engine; ``{"dp": 2, "mp": 4}`` splits each bucket's
  rows; a bucket that the ``dp`` axis does not divide raises naming it.
- Decode: ``AttentionDecodeCell`` with 8 heads under
  ``DECODE_PARTITION_RULES`` over ``{"dp": 1, "mp": 8}``: the sharded
  pool's ``kv_cache_bytes`` is exactly 1/8 of the same pool held whole
  on every member, and the tokens equal the JAX mesh engine's up to the
  first position whose JAX top-2 margin is under 1e-4.
- Processes: one launch of ``tests/torch_mesh_worker.py`` on four CPU
  processes over gloo (``python -m mxnet_tpu_torch.launch -n 4
  --force-cpu``, 120 s hard limit): rank 0 serves and the followers
  follow (their ``submit`` raises naming rank 0); the outputs against
  the one-device engine here, the decode tokens against the mesh engine
  in this process, a 4-way sharded pool at 1/4 of the replicated one,
  and the ``dp 2 x mp 2`` ``Module`` against the same mesh in threads.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
from jax.sharding import PartitionSpec as JP

import mxnet_tpu as mx
import mxnet_tpu.decode as jdec
from mxnet_tpu.parallel import PartitionRules as JRules
from mxnet_tpu.parallel.ring_attention import \
    DECODE_PARTITION_RULES as J_DECODE_RULES
from mxnet_tpu.serving import InferenceEngine as JEngine

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401
from mxnet_tpu_torch.decode import DecodeEngine
from mxnet_tpu_torch.parallel import PartitionRules
from mxnet_tpu_torch.parallel.ring_attention import DECODE_PARTITION_RULES
from mxnet_tpu_torch.serving import InferenceEngine

import torch_mesh_worker as W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = mt.cpu()
N_DEV = 8
needs_mesh = pytest.mark.skipif(
    jax.device_count() < N_DEV, reason="needs the 8-device virtual CPU mesh")


def _ctxs(n=N_DEV):
    return [mt.cpu(i) for i in range(n)]


def _port_params(ctx=CPU):
    return {k: mt.nd.array(v, ctx=ctx) for k, v in W.serve_params().items()}


def _one_device(requests):
    with InferenceEngine(W.serve_net(mt.sym), _port_params(),
                         {"data": (8, 16)}, max_batch=8, ctx=CPU) as eng:
        return [eng.predict(data=x)[0] for x in requests]


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# -- serving -------------------------------------------------------------------

@needs_mesh
def test_serving_mp8_bit_equal_per_bucket_and_near_jax():
    reqs = W.serve_requests()
    one = _one_device(reqs)
    rules = PartitionRules(W.SERVE_RULES)
    with InferenceEngine(W.serve_net(mt.sym), _port_params(),
                         {"data": (8, 16)}, max_batch=8,
                         partition_rules=rules, contexts=_ctxs()) as eng:
        got = [eng.predict(data=x)[0] for x in reqs]
        summary = eng.partition_summary()
        shards = {k: tuple(v.shape) for k, v in eng._param_raw.items()}
        cards = eng.program_cards()
        bytes_ = eng.stats()["device_bytes"]
    assert shards == {"fc1_weight": (8, 16), "fc1_bias": (8,),
                      "fc2_weight": (1, 64), "fc2_bias": (1,)}
    assert len(cards) == len(eng.buckets)
    assert all(c["partition"] == summary for c in cards.values())
    assert bytes_["context"] == "mesh(8dev)" and bytes_["by_kind"]["param"]
    # each request's bucket against the same bucket on one device
    for g, o in zip(got, one):
        assert np.array_equal(g, o)
    jrules = JRules([(p, JP(*s)) for p, s in W.SERVE_RULES])
    jparams = {"arg:" + k: mx.nd.array(v)
               for k, v in W.serve_params().items()}
    with JEngine(W.serve_net(mx.sym), jparams, {"data": (8, 16)},
                 max_batch=8, partition_rules=jrules,
                 contexts=[mx.cpu(i) for i in range(N_DEV)]) as jeng:
        want = [jeng.predict(data=x)[0] for x in reqs]
        jsummary = jeng.partition_summary()
    assert summary == jsummary
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5


@needs_mesh
def test_serving_dp2_mp4_splits_rows():
    reqs = W.serve_requests()
    one = _one_device(reqs)
    with InferenceEngine(W.serve_net(mt.sym), _port_params(),
                         {"data": (8, 16)}, max_batch=8, buckets=[2, 4, 8],
                         partition_rules=W.SERVE_RULES,
                         mesh_axes={"dp": 2, "mp": 4},
                         contexts=_ctxs()) as eng:
        got = [eng.predict(data=x)[0] for x in reqs]
        assert eng.partition_summary()["mesh_axes"] == {"dp": 2, "mp": 4}
        assert eng._param_raw["fc1_weight"].shape == (16, 16)
        st = eng.stats()
    assert st["buckets"] == {"2": 2, "4": 1, "8": 2}
    for g, o in zip(got, one):
        assert g.shape == o.shape and _rel(g, o) <= 1e-6


def test_serving_bucket_divisibility_names_the_dp_axis():
    with pytest.raises(mt.MXNetError, match="'dp' mesh axis"):
        InferenceEngine(W.serve_net(mt.sym), _port_params(),
                        {"data": (8, 16)}, max_batch=8, buckets=[1, 8],
                        warmup=False, partition_rules=W.SERVE_RULES,
                        mesh_axes={"dp": 2, "mp": 4}, contexts=_ctxs())


# -- decode --------------------------------------------------------------------

def _decode(pkg_engine, cell, **kw):
    with pkg_engine(cell, cell.init_params(1), slots=4, max_new_tokens=8,
                    keep_logits=True, **kw) as eng:
        futs = [eng.submit(p) for p in W.decode_prompts()]
        res = [f.result(timeout=120) for f in futs]
        return res, eng.stats()["kv_cache_bytes"], eng.partition_summary()


@needs_mesh
def test_decode_head_sharded_cache_and_tokens_against_jax():
    axes = {"dp": 1, "mp": N_DEV}
    cell = W.decode_cell()
    got, sharded, summary = _decode(DecodeEngine, cell,
                                    partition_rules=DECODE_PARTITION_RULES,
                                    mesh_axes=axes, contexts=_ctxs())
    _, repl, _ = _decode(DecodeEngine, cell, partition_rules=[],
                         mesh_axes=axes, contexts=_ctxs())
    assert repl == N_DEV * sharded
    jcell = jdec.AttentionDecodeCell(64, 32, 8, 8, 48)
    want, jsharded, jsummary = _decode(
        jdec.DecodeEngine, jcell, partition_rules=J_DECODE_RULES,
        mesh_axes=axes, contexts=[mx.cpu(i) for i in range(N_DEV)])
    assert sharded == jsharded and summary == jsummary
    for g, w in zip(got, want):
        cut = _margin_cut(np.asarray(w.logits, np.float32), 1e-4)
        assert g.tokens[:cut] == w.tokens[:cut]


def _margin_cut(logits, tol):
    top2 = np.sort(logits, axis=-1)[:, -2:]
    small = np.nonzero(top2[:, 1] - top2[:, 0] < tol)[0]
    return int(small[0]) if small.size else len(logits)


def test_decode_mesh_replicates_the_lstm_cell():
    from mxnet_tpu_torch.decode import LSTMDecodeCell
    cell = LSTMDecodeCell(64, 16, 32, 48)
    prompt = W.decode_prompts()[0]
    with DecodeEngine(cell, cell.init_params(2), slots=2, ctx=CPU,
                      max_new_tokens=5) as eng:
        want = eng.generate(prompt).tokens
    with DecodeEngine(cell, cell.init_params(2), slots=2,
                      partition_rules=DECODE_PARTITION_RULES,
                      mesh_axes={"dp": 2, "mp": 2},
                      contexts=_ctxs(4), max_new_tokens=5) as eng:
        assert eng.generate(prompt).tokens == want
        assert not eng.partition_summary()["partition"]["sharded_params"]


# -- four processes --------------------------------------------------------------

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", "4",
         "--force-cpu", "--timeout", "120", "--", sys.executable,
         os.path.join(ROOT, "tests", "torch_mesh_worker.py"), str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=150)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-6000:]

    def arrays(name):
        return [dict(np.load(out / ("%s-r%d.npz" % (name, r))))
                for r in range(4)]
    return arrays


@pytest.mark.parametrize("name", [c[0] for c in W.SERVE_CASES])
def test_serving_across_processes_follows_rank0(run, name):
    ranks = run(name)
    reqs = W.serve_requests()
    one = _one_device(reqs)
    for i, o in enumerate(one):
        if name == "serve_mp4":
            assert np.array_equal(ranks[0]["out%d" % i], o)
        else:
            assert _rel(ranks[0]["out%d" % i], o) <= 1e-6
    assert all(bool(r["follower_refused"]) for r in ranks[1:])
    whole = sum(v.nbytes for v in W.serve_params().values())
    per = whole // (4 if name == "serve_mp4" else 2)
    assert all(int(r["param_bytes"]) == per for r in ranks)


def test_decode_across_processes_follows_rank0(run):
    ranks = run("decode_mp4")
    cell = W.decode_cell()
    axes = {"dp": 1, "mp": 4}
    for tag, rules in (("sharded", DECODE_PARTITION_RULES), ("repl", [])):
        want, _, _ = _decode(DecodeEngine, cell, partition_rules=rules,
                             mesh_axes=axes, contexts=_ctxs(4))
        for i, w in enumerate(want):
            cut = _margin_cut(w.logits, 1e-4)
            assert list(ranks[0]["%s_tokens%d" % (tag, i)])[:cut] \
                == w.tokens[:cut]
    assert all(int(r["kv_repl"]) == 4 * int(r["kv_sharded"]) for r in ranks)
    assert all(bool(r["follower_refused"]) for r in ranks[1:])


def test_module_across_processes_matches_threads(run):
    ranks = run("module_dp2mp2")
    mod = W.train_module(mt.mod.Module(
        W.mlp(mt.sym), context=_ctxs(4), partition_rules=W.MODULE_RULES,
        mesh_axes=W.MODULE_AXES), W.module_batches())
    want = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    for r, got in enumerate(ranks):
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
            mp = r % 2
            assert np.array_equal(got["shard_" + k],
                                  np.split(got[k], 2, axis=0)[mp])
