"""Data parallelism across worker processes: the port's ``dist*`` stores,
the launcher and the dp ``SPMDTrainer``, two processes over gloo on the
CPU, against the JAX package in this process.

One launch (``python -m mxnet_tpu_torch.launch -n 2 --force-cpu``, a
free port, a 90 s hard timeout) runs ``tests/torch_dist_worker.py`` on
both ranks once per module; each test reads what the workers wrote:

- identity: ranks 0 and 1 of 2, backend gloo, a barrier;
- ``Module.fit`` of ``tests/test_module_dp.py``'s MLP on a ``dist_sync``
  store, 4 batches of 32 rows per worker: the replicas bit-equal, each
  worker's own initial parameters replaced by rank 0's, and the result
  within rtol 1e-5 (atol 1e-6) of the JAX package's one-process Module
  at the global batch of 64 from rank 0's start;
- ``dist_async`` bit-equal to ``dist_sync`` (the JAX package defines it
  as synchronous), phase-split under the ``kvstore_dist`` code;
- 2-bit (threshold 0.5) and fp16 stores: replicas bit-equal, the wire
  bytes (``ceil(n/16)`` words per 2-bit key, 2 bytes per fp16 value),
  step 1 equal to a recompute from the workers' step-1 gradients
  (quantised by the JAX package's ``quantize_2bit``, summed, the SGD
  step) within 1e-6 of the update;
- the push-discipline check raises on mismatched key lists and
  ``MXNET_KVSTORE_CHECK_PUSH=0`` lets the push through;
- the MLP with a BatchNorm: the fused ``dist_sync`` step takes its
  statistics over both workers' rows (replicas and moving stats
  bit-equal, every tensor within 1e-5 of its largest magnitude of the
  JAX package's one-process Module at the global batch, moving stats
  included: the statistics are summed in another order); the
  phase-split ``dist_async`` path takes each worker's own rows (weights
  bit-equal, each rank within 1e-5 as before of a JAX Module of its own
  rows whose gradients are summed with the other's, its own moving
  stats included), as the JAX package's two paths do;
- ``gluon.Trainer(kvstore="dist_sync")`` with a BatchNorm (each
  worker's own rows, as in the JAX package's dist Trainer): weights
  bit-equal, rank 0's start, 4 steps within rtol 1e-5 of JAX nets on
  each worker's rows with the gradients summed (each rank's moving
  stats against its own), and a resume from step 2 through
  ``save_states``/``load_states`` bit-equal;
- the LM's ``SPMDTrainer`` over a ``dp`` mesh of the two processes
  (global batch 4, 3 steps) within rtol 1e-5 (atol 1e-6) of the JAX
  ``SPMDTrainer`` on a 2-device dp mesh.

The launcher: a hung worker is killed at ``--timeout`` (exit 124), a
failing worker takes the other down, the environment of each rank, the
backend rule and the server role's exit at import.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import mxnet_tpu as mx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.gradient_compression import quantize_2bit, dequantize_2bit

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import launch, dist

import torch_dist_worker as W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2


def _launch(args, timeout):
    # two threads a worker: the suite's own workers share this machine
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", "mxnet_tpu_torch.launch"]
                          + args, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    res = _launch(["-n", str(WORLD), "--force-cpu", "--timeout", "80", "--",
                   sys.executable, os.path.join(ROOT, "tests",
                                                "torch_dist_worker.py"),
                   str(out)], timeout=90)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-6000:]
    results = []
    for r in range(WORLD):
        with open(out / ("results-r%d.json" % r)) as f:
            results.append(json.load(f))

    def arrays(name):
        return [dict(np.load(out / ("%s-r%d.npz" % (name, r))))
                for r in range(WORLD)]
    return results, arrays, res.stderr


def _group(d, tag):
    return {k.split("/", 1)[1]: v for k, v in d.items()
            if k.startswith(tag + "/")}


def _bit_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_identity_backend_and_barrier(run):
    results, _, stderr = run
    for r, res in enumerate(results):
        assert res["identity"] == {"rank": r, "num_workers": WORLD,
                                   "backend": "gloo", "telemetry_rank": r}
    assert "backend gloo (a rank has no CUDA device)" in stderr


def _jax_module(start, rows, bn=False):
    mod = mx.mod.Module((W.bn_mlp if bn else W.mlp)(mx), context=mx.cpu())
    mod.bind(data_shapes=[("data", (rows, W.D_IN))],
             label_shapes=[("softmax_label", (rows,))])
    mod.init_params(arg_params={k: mx.nd.array(v) for k, v in start.items()},
                    aux_params={k: mx.nd.array(v) for k, v in
                                W.BN_AUX.items()} if bn else None)
    mod.init_optimizer(kvstore=None, optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    return mod


def _np_params(mod):
    arg, aux = mod.get_params()
    return {k: v.asnumpy() for k, v in arg.items()}, \
        {k: v.asnumpy() for k, v in aux.items()}


def _jax_fit(start, steps=W.NB, bn=False):
    """The JAX package's one-process Module at the global batch:
    (parameters, aux states)."""
    x, y = W.toy_data()
    g = W.LOCAL * WORLD
    mod = _jax_module(start, g, bn)
    for i in range(steps):
        mod.forward_backward(mx.io.DataBatch(
            [mx.nd.array(x[i * g:(i + 1) * g])],
            [mx.nd.array(y[i * g:(i + 1) * g])]))
        mod.update()
    return _np_params(mod)


def _jax_fit_per_worker(start, steps=W.NB):
    """The phase-split dist path in the JAX package's terms: one Module
    per worker on its own rows (its own batch statistics), the two
    workers' gradients summed into both before each update. Returns
    each worker's (parameters, aux states)."""
    mods, shards = [], []
    for r in range(WORLD):
        mods.append(_jax_module(start, W.LOCAL, bn=True))
        shards.append(W.local_shard(r, WORLD))
    for i in range(steps):
        rows = slice(i * W.LOCAL, (i + 1) * W.LOCAL)
        for mod, (x, y) in zip(mods, shards):
            mod.forward_backward(mx.io.DataBatch([mx.nd.array(x[rows])],
                                                 [mx.nd.array(y[rows])]))
        for n in start:
            total = sum(m._exec.grad_dict[n].asnumpy() for m in mods)
            for m in mods:
                m._exec.grad_dict[n][:] = total
        for mod in mods:
            mod.update()
    return [_np_params(m) for m in mods]


def test_dist_sync_fit_bit_equal_replicas_match_jax(run):
    results, arrays, _ = run
    a0, a1 = arrays("mlp_dist_sync_none")
    _bit_equal(_group(a0, "end"), _group(a1, "end"))
    assert results[0]["mlp_dist_sync_none"]["fallback"] is None
    assert results[0]["mlp_dist_sync_none"]["wire"] == \
        4 * sum(v.size for v in _group(a0, "start").values())
    want = _jax_fit(_group(a0, "start"))[0]
    got = _group(a0, "end")
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_rank_dependent_init_replaced_by_rank_zero(run):
    _, arrays, _ = run
    a0, a1 = arrays("mlp_dist_sync_none")
    b0, b1 = _group(a0, "before"), _group(a1, "before")
    assert any(not np.array_equal(b0[k], b1[k]) for k in b0)
    _bit_equal(_group(a0, "start"), b0)
    _bit_equal(_group(a1, "start"), b0)


def test_dist_async_equals_dist_sync(run):
    results, arrays, _ = run
    for r, (sync, asyn) in enumerate(zip(arrays("mlp_dist_sync_none"),
                                         arrays("mlp_dist_async_none"))):
        _bit_equal(_group(asyn, "end"), _group(sync, "end"))
        assert results[r]["mlp_dist_async_none"]["fallback"] == \
            "kvstore_dist"


def _quantised(g, kind):
    if kind == "fp16":
        return g.astype(np.float16).astype(np.float32)
    packed, _ = quantize_2bit(jnp.asarray(g), jnp.zeros(g.shape), 0.5)
    return np.asarray(dequantize_2bit(packed, g.shape, 0.5))


@pytest.mark.parametrize("kind", ["2bit", "fp16"])
def test_compressed_store_wire_and_first_update(run, kind):
    results, arrays, _ = run
    name = "mlp_dist_sync_%s" % kind
    a0, a1 = arrays(name)
    _bit_equal(_group(a0, "end"), _group(a1, "end"))
    _bit_equal(_group(a0, "step1"), _group(a1, "step1"))
    start = _group(a0, "start")
    sizes = [v.size for v in start.values()]
    info = results[0][name]
    assert info["fallback"] == "kvstore_dist"
    assert info["wire_raw"] == 4 * sum(sizes)
    assert info["wire"] == (4 * sum(-(-n // 16) for n in sizes)
                            if kind == "2bit" else 2 * sum(sizes))
    g0, g1 = _group(a0, "grad1"), _group(a1, "grad1")
    for k, w0 in start.items():
        summed = _quantised(g0[k], kind) + _quantised(g1[k], kind)
        want = w0 - np.float32(0.1) * summed     # momentum state starts at 0
        got = _group(a0, "step1")[k]
        scale = max(np.abs(want - w0).max(), 1e-30)
        assert np.abs(got - want).max() <= 1e-6 * scale, k


def test_push_discipline_violation_and_switch(run):
    results, _, _ = run
    for res in results:
        assert "push discipline violated" in res["discipline"]["raised"]
        assert res["discipline"]["unchecked_sum"] == [2.0] * 4


def _close_to_largest(got, want, tol=1e-5):
    assert sorted(got) == sorted(want)
    for k in want:
        err = np.abs(got[k] - want[k]).max()
        assert err <= tol * np.abs(want[k]).max(), (k, err)


def test_batchnorm_fused_dist_sync_takes_the_global_batch(run):
    results, arrays, _ = run
    a0, a1 = arrays("bn_dist_sync_none")
    assert results[0]["bn_dist_sync_none"]["fallback"] is None
    for tag in ("end", "aux"):
        _bit_equal(_group(a0, tag), _group(a1, tag))
    want, want_aux = _jax_fit(_group(a0, "start"), bn=True)
    _close_to_largest(_group(a0, "end"), want)
    _close_to_largest(_group(a0, "aux"), want_aux)


def test_batchnorm_phase_split_dist_takes_each_workers_rows(run):
    results, arrays, _ = run
    per = arrays("bn_dist_async_none")
    assert results[0]["bn_dist_async_none"]["fallback"] == "kvstore_dist"
    _bit_equal(_group(per[0], "end"), _group(per[1], "end"))
    # each worker's moving stats come from its own rows
    assert not np.array_equal(per[0]["aux/bn1_moving_mean"],
                              per[1]["aux/bn1_moving_mean"])
    want = _jax_fit_per_worker(_group(per[0], "start"))
    for a, (ref, ref_aux) in zip(per, want):
        _close_to_largest(_group(a, "end"), ref)
        _close_to_largest(_group(a, "aux"), ref_aux)


def _jax_gluon_per_worker(start, steps=4):
    """The dist Gluon loop in the JAX package's terms: one net per worker
    on its own rows (its own batch statistics), the gradients summed into
    both before each ``Trainer.step``. Returns each worker's parameters
    (moving stats included)."""
    batches = W.gluon_batches(WORLD)[:steps]
    nets, trainers = [], []
    for _ in range(WORLD):
        net = W.gluon_net(0, pkg=mx)
        for k, p in net.collect_params().items():
            p.set_data(mx.nd.array(start[k]))
        nets.append(net)
        trainers.append(mx.gluon.Trainer(net.collect_params(), "sgd",
                                         {"learning_rate": 0.1,
                                          "momentum": 0.9}, kvstore=None))
    L = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    local = batches[0][0].shape[0] // WORLD
    for x, y in batches:
        for r, net in enumerate(nets):
            rows = slice(r * local, (r + 1) * local)
            with mx.autograd.record():
                loss = L(net(mx.nd.array(x[rows])), mx.nd.array(y[rows]))
            loss.backward()
        for k in start:
            ps = [net.collect_params()[k] for net in nets]
            if ps[0].grad_req == "null":
                continue
            total = sum(p.grad().asnumpy() for p in ps)
            for p in ps:
                p.grad()[:] = total
        for tr in trainers:
            tr.step(x.shape[0])
    return [{k: p.data().asnumpy() for k, p in net.collect_params().items()}
            for net in nets]


def test_gluon_trainer_dist_sync(run):
    results, arrays, _ = run
    a0, a1 = arrays("gluon")
    b0, b1 = _group(a0, "before"), _group(a1, "before")
    assert any(not np.array_equal(b0[k], b1[k]) for k in b0
               if k.endswith("weight"))
    _bit_equal(_group(a1, "start"), _group(a0, "start"))
    ends = [_group(a, "end") for a in (a0, a1)]
    moving = [k for k in ends[0] if "running" in k]
    assert moving
    _bit_equal({k: v for k, v in ends[0].items() if k not in moving},
               {k: v for k, v in ends[1].items() if k not in moving})
    want = _jax_gluon_per_worker(_group(a0, "start"))
    for end, ref in zip(ends, want):
        assert sorted(end) == sorted(ref)
        for k, v in end.items():
            np.testing.assert_allclose(v, ref[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    for a in (a0, a1):
        _bit_equal(_group(a, "resumed"), _group(a, "end"))
    assert results[0]["gluon"]["num_update"] == 4


def test_lm_spmd_trainer_dp_matches_jax(run):
    results, arrays, _ = run
    p0, p1 = arrays("lm")
    _bit_equal(p0, p1)
    assert results[0]["lm"]["losses"] == results[1]["lm"]["losses"]
    jmesh = jpar.make_mesh({"dp": WORLD, "sp": 1, "tp": 1},
                           devices=jax.devices()[:WORLD])
    V, E, H, S, GB = W.V, W.E, W.H, W.S, W.GB
    d = E // H

    def attn(q, k, v):
        return jpar.ulysses_attention(q, k, v, jmesh, axis_name="sp",
                                      batch_axis_name="dp", causal=True,
                                      use_pallas=True)

    def apply_fn(p, x, y):
        e = jnp.take(p["embed"], x, axis=0)

        def split(t):
            return t.reshape(GB, S, H, d).transpose(0, 2, 1, 3)
        a = attn(split(e @ p["wq"].T), split(e @ p["wk"].T),
                 split(e @ p["wv"].T))
        h = e + a.transpose(0, 2, 1, 3).reshape(GB, S, E) @ p["wo"].T
        h = h + jnp.maximum(h @ p["w1"].T, 0) @ p["w2"].T
        logp = jax.nn.log_softmax(h @ p["head"].T)
        return jnp.mean(-jnp.take_along_axis(logp, y[..., None], axis=-1))

    jtr = jpar.SPMDTrainer(apply_fn, W.lm_params(), jmesh, data_axis="dp",
                           tp_axis="tp", learning_rate=0.1, momentum=0.9,
                           batch_specs=[JP("dp", "sp"), JP("dp", "sp")])
    jl = [float(np.asarray(jtr.step(x, y))) for x, y in W.lm_batches()]
    np.testing.assert_allclose(results[0]["lm"]["losses"], jl, rtol=1e-5,
                               atol=1e-6)
    jp = jtr.get_params()
    for n in jp:
        np.testing.assert_allclose(p0[n], jp[n], rtol=1e-5, atol=1e-6,
                                   err_msg=n)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_spmd_trainer_batch_statistics_over_processes(run, n_dev):
    """ROADMAP Queue 3, fault 1, across processes: the dp mesh of the two
    workers (one Context each) and of their two Contexts each (dp 4, a
    thread per Context) gives the JAX trainer's loss and weights; the
    replicas are bit-equal."""
    from test_torch_parallel import fault1_jax_loss_and_w
    results, arrays, _ = run
    jl, jw = fault1_jax_loss_and_w(n_dev)
    name = "fault1_dp%d" % n_dev
    for res, a in zip(results, arrays(name)):
        assert abs(res[name]["loss"] - jl) <= 1e-5, (res[name], jl)
        np.testing.assert_allclose(a["w"], jw, rtol=1e-5, atol=1e-6)
    w0, w1 = (a["w"] for a in arrays(name))
    np.testing.assert_array_equal(w0, w1)


def test_launcher_timeout_kills_a_hung_worker():
    t0 = time.monotonic()
    res = _launch(["-n", "2", "--force-cpu", "--timeout", "3", "--",
                   sys.executable, "-c", "import time; time.sleep(120)"],
                  timeout=60)
    assert res.returncode == 124, res.stderr
    assert "--timeout 3s expired; killing 2 worker(s)" in res.stderr
    assert time.monotonic() - t0 < 30


def test_launcher_failed_worker_stops_the_others():
    code = ("import os, sys, time\n"
            "if os.environ['MXNET_TPU_PROCESS_ID'] == '1':\n"
            "    sys.exit(3)\n"
            "time.sleep(120)\n")
    t0 = time.monotonic()
    res = _launch(["-n", "2", "--force-cpu", "--timeout", "50", "--",
                   sys.executable, "-c", code], timeout=60)
    assert res.returncode == 3, res.stderr
    assert "worker 1 exited with 3" in res.stderr
    assert time.monotonic() - t0 < 30


def test_launcher_environment_and_ssh_commands(tmp_path):
    class A:
        num_workers, host, port, force_cpu, own_cards = 3, "10.0.0.1", 4242, \
            False, False
        hostfile, sync_dst_dir = None, None
    env = launch.build_env(2, A, base={})
    assert env == {"DMLC_ROLE": "worker", "DMLC_NUM_WORKER": "3",
                   "DMLC_WORKER_ID": "2",
                   "MXNET_TPU_COORDINATOR": "10.0.0.1:4242",
                   "MXNET_TPU_NUM_PROCESSES": "3",
                   "MXNET_TPU_PROCESS_ID": "2"}
    A.own_cards = True
    assert launch.build_env(1, A, base={})["CUDA_VISIBLE_DEVICES"] == "1"
    A.force_cpu = True
    assert launch.build_env(1, A, base={})["CUDA_VISIBLE_DEVICES"] == ""
    hosts = tmp_path / "hosts"
    hosts.write_text("h0\nh1\n")
    A.hostfile = str(hosts)
    cmds = launch.ssh_commands(A, ["python", "train.py"])
    assert [c[3] for c in cmds] == ["h0", "h1", "h0"]
    assert "MXNET_TPU_PROCESS_ID=2" in cmds[2][4]
    port = launch.free_port()
    assert 0 < port < 65536


def test_backend_rule(monkeypatch):
    monkeypatch.delenv(dist.ENV_BACKEND, raising=False)
    assert dist.choose_backend(["cpu", "cpu"])[0] == "gloo"
    assert dist.choose_backend(["cuda:a", "cuda:a"]) == \
        ("gloo", "ranks share a CUDA device")
    assert dist.choose_backend(["cuda:a", "cuda:b"])[0] == "nccl"
    monkeypatch.setenv(dist.ENV_BACKEND, "gloo")
    assert dist.choose_backend(["cuda:a", "cuda:b"])[0] == "gloo"
    monkeypatch.setenv(dist.ENV_BACKEND, "mpi")
    with pytest.raises(mt.MXNetError):
        dist.choose_backend(["cpu"])
    # outside a launched job: one process, every elastic query answers so
    assert (dist.rank(), dist.process_count(), dist.live_ranks(),
            dist.dead_ranks()) == (0, 1, (0,), ())
    # mark_member_lost records the rank (restored after the test: the
    # membership is process-global)
    monkeypatch.setitem(dist._state, "dead", frozenset())
    monkeypatch.setitem(dist._state, "live_group", None)
    dist.mark_member_lost([1])
    assert dist.dead_ranks() == (1,)
    assert dist.live_ranks() == (0,)
    assert dist.live_group() is None        # no job: nothing to re-mesh


def test_server_role_exits_at_import():
    env = dict(os.environ, PYTHONPATH=ROOT, DMLC_ROLE="server")
    res = subprocess.run([sys.executable, "-c",
                          "import mxnet_tpu_torch\nprint('worker code')"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=60)
    assert res.returncode == 0 and "worker code" not in res.stdout
