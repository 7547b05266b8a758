"""Elastic data-parallel training across worker processes: the port's
heartbeats, pre-collective gates, member loss, re-mesh and resume, over
gloo on the CPU, against the JAX package in this process.

One fixture launches four jobs of ``tests/torch_elastic_worker.py``
together (``python -m mxnet_tpu_torch.launch --force-cpu --heartbeat-dir
... --heartbeat-interval 0.2 --heartbeat-timeout 3``, each under the
launcher's ``--timeout`` and a hard limit here), the MLP of the JAX
package's dist lane (``tools/module_fit_probe.py``: D 16, 4 classes,
global batch 32, 6 batches, 3 epochs, SGD lr 0.05, momentum 0.9):

- (a) two workers, rank 1 killed at the ``kv_collective`` crossing the
  port counts for epoch 1, batch 2: the survivor finishes with each
  ``elastic.*`` counter at 1, its ``dead_worker`` postmortem names
  ``[1]`` at epoch 1, batch 2 and holds rank 1's ``worker_abort``; the
  JAX package's ``Module`` restores the survivor's epoch-1 checkpoint
  and trains epochs 1-2 on rank 0's rows to within rtol 1e-5 (atol
  1e-6) of the survivor's parameters;
- (b) three workers, rank 1 killed: survivors {0, 2} end bit-equal;
- (c) rank 1 SIGKILLed after crossing the step gate (its collectives in
  flight on rank 0): rank 0 names it (channel ``step-execution``) within
  the heartbeat timeout plus 10 s and finishes, nothing hangs;
- (d) no checkpoint: the survivor re-raises ``DeadWorkerError``.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import mxnet_tpu as mx

import torch_elastic_worker as W
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HB_TIMEOUT = 3.0
SYM = W.mlp(mx)
KILL_A = W.crossing_of(SYM, 1, 2)
CASES = {"a": (2, "kill=%d" % KILL_A), "b": (3, "kill=%d" % KILL_A),
         "c": (2, "sigkill=%d" % (W.NB + 3)),
         "d": (2, "kill=%d,nockpt" % KILL_A)}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    base = tmp_path_factory.mktemp("elastic")
    procs = {}
    for tag, (n, case) in CASES.items():
        out = base / tag
        out.mkdir()
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                   MXNET_FLIGHT_DIR=str(out / "flight"))
        env.pop("MXNET_FAULTS", None)
        cmd = [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", str(n),
               "--force-cpu", "--heartbeat-dir", str(out / "hb"),
               "--heartbeat-interval", "0.2", "--heartbeat-timeout",
               str(HB_TIMEOUT), "--timeout", "100", "--",
               sys.executable, os.path.join(ROOT, "tests",
                                            "torch_elastic_worker.py"),
               str(out), case]
        log = open(out / "launch.log", "w")
        procs[tag] = (subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                       stderr=subprocess.STDOUT), log, out)
    deadline = time.monotonic() + 120
    got = {}
    for tag, (p, log, out) in procs.items():
        try:
            rc = p.wait(max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            rc = None
        log.close()
        got[tag] = (rc, out)
    return got


def _rec(out, rank):
    with open(out / ("r%d.json" % rank)) as f:
        return json.load(f)


def _log(out):
    return (out / "launch.log").read_text()[-4000:]


def _postmortems(out, reason):
    d = out / "flight"
    return [json.load(open(d / n)) for n in sorted(os.listdir(d))
            if n.endswith(reason + ".json")]


def test_crossing_count_of_the_kill():
    """The victim's crossings: one for ``kv.init`` of every parameter,
    then one ``step`` crossing a fused step."""
    assert W.kv_init_crossings(SYM) == 1
    assert KILL_A == 1 + W.NB + 2 + 1


def test_a_survivor_recovers_and_counts(jobs):
    rc, out = jobs["a"]
    assert rc == W.FAULT_RC, _log(out)
    assert "worker 1 exited with %d" % W.FAULT_RC in _log(out)
    r0 = _rec(out, 0)
    assert r0["completed"], _log(out)
    for k in ("elastic.dead_workers", "elastic.remesh", "elastic.resumed"):
        assert r0["counters"].get(k) == 1, r0["counters"]
    assert r0["dead_ranks"] == [1] and r0["live_ranks"] == [0]
    assert r0["kv_live_ranks"] == [0]
    assert not (out / "r1.json").exists()
    assert json.load(open(out / "victim.json"))["how"] == "kv_collective"


def test_a_postmortem_names_the_dead_rank(jobs):
    _, out = jobs["a"]
    pm, = _postmortems(out, "dead_worker")
    extra = pm["extra"]
    assert extra["dead_ranks"] == [1]
    assert (extra["epoch"], extra["nbatch"]) == (1, 2)
    assert extra["channel"] == "step" and extra["survivor_rank"] == 0
    assert extra["live_ranks"] == [0]
    assert any(p["rank"] == 1 and p["reason"] == "worker_abort"
               for p in extra["peer_postmortems"]), extra["peer_postmortems"]
    assert pm["process"]["rank"] == 0
    # the victim's own dump names its killer
    abort, = _postmortems(out, "worker_abort")
    assert abort["extra"]["exit_code"] == W.FAULT_RC
    # tools/flight_view.py reads the port's dump
    view = subprocess.run([sys.executable,
                           os.path.join(ROOT, "tools", "flight_view.py"),
                           str(out / "flight" / sorted(
                               n for n in os.listdir(out / "flight")
                               if n.endswith("dead_worker.json"))[0]),
                           "--json"], capture_output=True, text=True,
                          timeout=60)
    assert view.returncode == 0, view.stderr
    assert json.loads(view.stdout)["extra"]["dead_ranks"] == [1]


def test_a_resume_matches_jax_restoring_the_checkpoint(jobs):
    """The survivor re-meshed alone and resumed from its epoch-1
    checkpoint on its own rows: the JAX package restores the same
    checkpoint and trains epochs 1-2 on rank 0's rows."""
    _, out = jobs["a"]
    got = dict(np.load(out / "r0.npz"))
    prefix = str(out / "ckpt" / "r0" / "model")
    mgr = mx.CheckpointManager(prefix, keep_last=4)
    with open("%s-%04d.meta.json" % (prefix, 1)) as f:
        meta = json.load(f)
    assert (meta["epoch"], meta.get("nbatch", 0)) == (1, 0)
    x, y, local = W.rows(0, 2)
    mod = mx.mod.Module(W.mlp(mx), context=mx.cpu())
    mod.bind(data_shapes=[("data", (local, W.D))],
             label_shapes=[("softmax_label", (local,))])
    mod.init_params(initializer=mx.initializer.Xavier())
    mod.init_optimizer(kvstore=None, optimizer="sgd",
                       optimizer_params={"learning_rate": 0.05,
                                         "momentum": 0.9})
    mgr.restore(mod, meta)
    for _ in range(1, W.EPOCHS):
        for i in range(W.NB):
            rows = slice(i * local, (i + 1) * local)
            mod.forward_backward(mx.io.DataBatch([mx.nd.array(x[rows])],
                                                 [mx.nd.array(y[rows])]))
            mod.update()
    want = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_b_three_workers_survivors_bit_equal(jobs):
    rc, out = jobs["b"]
    assert rc == W.FAULT_RC, _log(out)
    r0, r2 = _rec(out, 0), _rec(out, 2)
    for r in (r0, r2):
        assert r["completed"], _log(out)
        assert r["live_ranks"] == [0, 2] and r["dead_ranks"] == [1]
        for k in ("elastic.dead_workers", "elastic.remesh",
                  "elastic.resumed"):
            assert r["counters"].get(k) == 1, r["counters"]
    p0, p2 = np.load(out / "r0.npz"), np.load(out / "r2.npz")
    assert sorted(p0.files) == sorted(p2.files)
    for k in p0.files:
        np.testing.assert_array_equal(p0[k], p2[k], err_msg=k)
    # the survivors stepped over the survivors' group: two workers' rows
    # summed after the loss, as before it
    assert r0["counters"]["kvstore.dist.fused_steps"] \
        == r2["counters"]["kvstore.dist.fused_steps"]


def test_c_death_in_flight_is_named_in_bounded_time(jobs):
    rc, out = jobs["c"]
    assert rc is not None and rc != 0, _log(out)     # rank 1 SIGKILLed
    r0 = _rec(out, 0)
    assert r0["completed"], _log(out)
    dead = [e for e in r0["events"] if e["kind"] == "elastic.dead_worker"]
    assert len(dead) == 1, r0["events"]
    assert dead[0]["data"]["dead"] == [1]
    assert dead[0]["data"]["channel"] == "step-execution"
    victim = json.load(open(out / "victim.json"))
    assert victim["how"] == "sigkill"
    assert 0 < dead[0]["ts"] - victim["t"] <= HB_TIMEOUT + 10


def test_d_no_checkpoint_reraises(jobs):
    rc, out = jobs["d"]
    assert rc == W.FAULT_RC, _log(out)
    r0 = _rec(out, 0)
    assert not r0["completed"]
    assert r0["raised"]["type"] == "DeadWorkerError"
    assert r0["raised"]["ranks"] == [1]
    assert (r0["raised"]["epoch"], r0["raised"]["nbatch"]) == (1, 2)
    assert r0["counters"].get("elastic.dead_workers") == 1
    assert "elastic.remesh" not in r0["counters"]
    assert "elastic.resumed" not in r0["counters"]


def test_launcher_heartbeat_dir_keeps_the_others_running(tmp_path):
    """With ``--heartbeat-dir`` a worker's nonzero exit is a member
    death: the others run to their end, the launcher exits with the OR
    of the codes, the directory starts clean and every worker sees the
    ``MXTPU_HEARTBEAT_*`` environment."""
    hb = tmp_path / "hb"
    hb.mkdir()
    (hb / "worker-9").write_text("stale")
    code = ("import os, sys, time\n"
            "r = os.environ['MXNET_TPU_PROCESS_ID']\n"
            "assert not os.path.exists(os.path.join("
            "os.environ['MXTPU_HEARTBEAT_DIR'], 'worker-9'))\n"
            "if r == '1':\n"
            "    sys.exit(3)\n"
            "time.sleep(2)\n"
            "open(os.path.join(%r, 'done-' + r), 'w').write("
            "os.environ['MXTPU_HEARTBEAT_INTERVAL'] + ' ' + "
            "os.environ['MXTPU_HEARTBEAT_TIMEOUT'])\n" % str(tmp_path))
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-m", "mxnet_tpu_torch.launch",
                          "-n", "3", "--force-cpu", "--heartbeat-dir",
                          str(hb), "--heartbeat-interval", "0.5",
                          "--heartbeat-timeout", "4", "--timeout", "50",
                          "--", sys.executable, "-c", code], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=60)
    assert res.returncode == 3, res.stderr
    assert "worker 1 exited with 3; a member death" in res.stderr
    for r in (0, 2):
        assert (tmp_path / ("done-%d" % r)).read_text() == "0.5 4.0"
