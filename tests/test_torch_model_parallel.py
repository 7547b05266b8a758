"""Sequence, tensor, expert and pipeline parallelism across worker
processes: the port's collectives over mesh axes, ring and Ulysses
attention, the dp x sp x tp ``SPMDTrainer``, ``moe_ffn`` and
``pipeline_apply``, four processes over gloo on the CPU, against the JAX
package on 4 of this process's virtual CPU devices.

One launch (``python -m mxnet_tpu_torch.launch -n 4 --force-cpu``, a
free port, a 100 s hard timeout) runs ``tests/torch_mp_worker.py`` on
every rank once per module; each test reads the member blocks the ranks
wrote and holds them against the same blocks of the JAX package's
global result on the same numpy inputs (rtol 1e-5, atol 1e-6 unless
stated). Rank r is device r of the JAX mesh of the same axes.
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as JP

from mxnet_tpu import parallel as jpar
from mxnet_tpu.parallel.compat import shard_map

import torch_mp_worker as W
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mp")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", str(WORLD),
         "--force-cpu", "--timeout", "100", "--", sys.executable,
         os.path.join(ROOT, "tests", "torch_mp_worker.py"), str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-6000:]

    def arrays(name):
        return [dict(np.load(out / ("%s-r%d.npz" % (name, r))))
                for r in range(WORLD)]
    return arrays


def _mesh(axes):
    return jpar.make_mesh(dict(axes), devices=jax.devices()[:WORLD])


def _coords(axes, r):
    return dict(zip(axes, np.unravel_index(r, tuple(axes.values()))))


def _block(a, axes, r, spec):
    """Rank r's block of a global array under ``spec``."""
    c = _coords(axes, r)
    for dim, ax in enumerate(spec):
        if ax is not None:
            a = np.split(a, axes[ax], axis=dim)[c[ax]]
    return a


def _close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


# -- collectives ------------------------------------------------------------------

def _jax_collective(fn, x, w):
    """Output and input gradient of ``sum(fn(x) * w)`` under shard_map
    over a 4-device ``sp`` axis (every array split along dim 0)."""
    mesh = _mesh({"sp": W.COLL_N})
    sm = shard_map(fn, mesh=mesh, in_specs=JP("sp"), out_specs=JP("sp"))
    out, (dx,) = _out_and_grads(sm, jnp.asarray(w), jnp.asarray(x))
    return out, dx


@functools.partial(jax.jit, static_argnums=0)
def _out_and_grads(f, w, *args):
    """``f(*args)`` and the gradients of ``sum(f(*args) * w)``, one jitted
    program."""
    out, vjp = jax.vjp(f, *args)
    return out, vjp(w.astype(out.dtype))


@pytest.mark.parametrize("tag,perm", [("ring", W.RING),
                                      ("partial", W.PARTIAL)])
def test_ppermute_and_its_gradient_match_lax(run, tag, perm):
    inp = W.coll_inputs()
    want, dwant = _jax_collective(lambda x: lax.ppermute(x, "sp", perm),
                                  inp["x"], inp["w"])
    axes = {"sp": W.COLL_N}
    for r, a in enumerate(run("collectives")):
        _close(a["ppermute_" + tag], _block(np.asarray(want), axes, r,
                                            ("sp",)))
        _close(a["ppermute_%s_dx" % tag], _block(np.asarray(dwant), axes, r,
                                                 ("sp",)))


def test_all_to_all_and_its_gradient_match_lax(run):
    inp = W.coll_inputs()
    want, dwant = _jax_collective(
        lambda a: lax.all_to_all(a, "sp", 1, 0, tiled=True), inp["a"],
        inp["wa"])
    axes = {"sp": W.COLL_N}
    for r, a in enumerate(run("collectives")):
        _close(a["all_to_all"], _block(np.asarray(want), axes, r, ("sp",)))
        _close(a["all_to_all_da"], _block(np.asarray(dwant), axes, r,
                                          ("sp",)))


def test_gather_reduce_broadcast_scatter(run):
    x, a = W.coll_inputs()["x"], W.coll_inputs()["a"]
    blocks = np.split(x, W.COLL_N)
    mesh = _mesh({"sp": W.COLL_N})
    rs = shard_map(lambda t: lax.psum_scatter(t, "sp", scatter_dimension=1,
                                              tiled=True),
                   mesh=mesh, in_specs=JP("sp"), out_specs=JP("sp"))(
        jnp.asarray(a))
    for r, got in enumerate(run("collectives")):
        _close(got["all_gather"], x)
        _close(got["all_gather_stacked"], np.stack(blocks))
        _close(got["all_reduce"], sum(blocks))
        _close(got["all_reduce_max"], np.max(np.stack(blocks), 0))
        _close(got["broadcast"], blocks[2])
        _close(got["reduce_scatter"], np.split(np.asarray(rs), W.COLL_N)[r])
        assert int(got["axis_index"]) == r


# -- ring and Ulysses attention ---------------------------------------------------

def _jax_attention(kind, axes, causal):
    q, k, v, w = (jnp.asarray(t) for t in W.attn_inputs())
    mesh = _mesh(axes)
    batch_axis = "dp" if "dp" in axes else None

    def f(q, k, v):
        return getattr(jpar, kind)(q, k, v, mesh, axis_name="sp",
                                   batch_axis_name=batch_axis, causal=causal,
                                   use_pallas=False)
    out, grads = _out_and_grads(f, w, q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _check_attention(run, kind, tag, axes, causal, use_pallas):
    out, grads = _jax_attention(kind, axes, causal)
    spec = ("dp" if "dp" in axes else None, None, "sp", None)
    for r, a in enumerate(run(W.case_name(kind.split("_")[0], tag, causal,
                                          use_pallas))):
        _close(a["out"], _block(out, axes, r, spec), rtol=2e-5, atol=2e-5)
        for nm, g in zip(("dq", "dk", "dv"), grads):
            _close(a[nm], _block(g, axes, r, spec), rtol=1e-4, atol=1e-4,
                   msg="%s rank %d" % (nm, r))


@pytest.mark.parametrize("tag,axes,causal,use_pallas", W.RING_CASES)
def test_ring_attention_across_ranks_matches_jax(run, tag, axes, causal,
                                                 use_pallas):
    """sp 4 and sp 2 (rows over dp 2), causal and not, the plain ring and
    the kernel route (K2's plain version per ring step, the plain ring
    backward), forward and q/k/v gradients, against JAX's plain ring."""
    _check_attention(run, "ring_attention", tag, axes, causal, use_pallas)


@pytest.mark.parametrize("causal,use_pallas", W.ULYSSES_CASES)
def test_ulysses_across_ranks_matches_jax(run, causal, use_pallas):
    _check_attention(run, "ulysses_attention", "dp2sp2", {"dp": 2, "sp": 2},
                     causal, use_pallas)


# -- the dryrun LM over dp x sp x tp ----------------------------------------------

def _jax_lm(axes, attn_name):
    """``__graft_entry__.py:88-115`` at the worker's width on a JAX mesh
    of the same axes, 3 steps."""
    mesh = _mesh(axes)
    B, S, E, H = W.GB, W.S, W.E, W.H
    d = E // H
    attn_fn = getattr(jpar, attn_name)

    def apply_fn(p, x, y):
        e = jnp.take(p["embed"], x, axis=0)

        def split(t):
            return t.reshape(B, S, H, d).transpose(0, 2, 1, 3)
        a = attn_fn(split(e @ p["wq"].T), split(e @ p["wk"].T),
                    split(e @ p["wv"].T), mesh, axis_name="sp",
                    batch_axis_name="dp", causal=True)
        h = e + a.transpose(0, 2, 1, 3).reshape(B, S, E) @ p["wo"].T
        h = h + jnp.maximum(h @ p["w1"].T, 0) @ p["w2"].T
        logp = jax.nn.log_softmax(h @ p["head"].T)
        return jnp.mean(-jnp.take_along_axis(logp, y[..., None], axis=-1))
    tr = jpar.SPMDTrainer(apply_fn, W.lm_params(), mesh, data_axis="dp",
                          tp_axis="tp" if "tp" in axes else None,
                          learning_rate=0.1, momentum=0.9,
                          batch_specs=[JP("dp", "sp"), JP("dp", "sp")])
    losses = [float(np.asarray(tr.step(x, y))) for x, y in W.lm_batches()]
    return losses, tr.get_params()


@pytest.mark.parametrize("name,axes,attn", W.LM_CASES)
def test_lm_dp_sp_tp_three_steps_match_jax(run, name, axes, attn):
    """Losses of every step and every parameter after step 3 (rtol 1e-5,
    atol 1e-6, ``__graft_entry__.py:129-134``); every rank's whole
    parameters bit-equal; each rank stores only its tp shard (the
    default rule shards dim 0 of every matrix over ``tp``)."""
    losses, params = _jax_lm(axes, attn)
    ranks = run(name)
    for a in ranks:
        _close(a["losses"], losses)
        for k, v in params.items():
            _close(a["param/" + k], v, msg=k)
            np.testing.assert_array_equal(a["param/" + k],
                                          ranks[0]["param/" + k])
    tp = axes.get("tp", 1)
    for r, a in enumerate(ranks):
        c = _coords(axes, r)
        for k, v in params.items():
            want = np.split(a["param/" + k], tp)[c["tp"]] if tp > 1 \
                else a["param/" + k]
            np.testing.assert_array_equal(a["shard/" + k], want)


# -- MoE and the pipeline -------------------------------------------------------------

def _jax_moe(cf):
    inp = {k: jnp.asarray(v) for k, v in W.moe_inputs().items()}
    mesh = _mesh({"ep": W.MOE_N})

    def f(x, wr, w1, w2):
        return jpar.moe_ffn(x, wr, w1, w2, mesh, capacity_factor=cf)
    out, grads = _out_and_grads(f, inp["g"], inp["x"], inp["wr"], inp["w1"],
                                inp["w2"])
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name,cf", W.MOE_CASES)
def test_moe_ffn_over_ep_matches_jax(run, name, cf):
    """Top-1 routing with one expert per rank, at a capacity that drops
    nothing and at one that drops tokens (zeros for them): each rank's
    rows of the output and of dx, its expert's dw1/dw2 and the router's
    gradient summed over the ranks."""
    out, (dx, dwr, dw1, dw2) = _jax_moe(cf)
    axes = {"ep": W.MOE_N}
    ranks = run(name)
    dropped = 0
    for r, a in enumerate(ranks):
        _close(a["out"], _block(out, axes, r, ("ep",)), rtol=1e-4, atol=1e-5)
        _close(a["dx"], _block(dx, axes, r, ("ep",)), rtol=1e-4, atol=1e-5)
        _close(a["dw1"], dw1[r:r + 1], rtol=1e-4, atol=1e-5)
        _close(a["dw2"], dw2[r:r + 1], rtol=1e-4, atol=1e-5)
        _close(a["dwr"], dwr, rtol=1e-4, atol=1e-5)
        dropped += int((np.abs(a["out"]).sum(-1) == 0).sum())
    assert (dropped > 0) == (name == "moe_drop"), dropped


def test_pipeline_over_pp_matches_jax(run):
    """4 stages of tanh(x W + b), 6 microbatches: the output on every
    rank and each rank's stage gradients, against JAX's
    ``pipeline_apply`` and its gradients."""
    inp = {k: jnp.asarray(v) for k, v in W.pipe_inputs().items()}
    mesh = _mesh({"pp": W.PP_N})

    def stage(p, mb):
        return jnp.tanh(mb @ p["w"] + p["b"])

    def f(w, b):
        return jpar.pipeline_apply(stage, {"w": w, "b": b}, inp["x"], mesh)
    out, (dw, db) = _out_and_grads(f, inp["g"], inp["w"], inp["b"])
    out = np.asarray(out)
    for r, a in enumerate(run("pipeline")):
        _close(a["out"], out)
        _close(a["dw"], np.asarray(dw)[r:r + 1])
        _close(a["db"], np.asarray(db)[r:r + 1])


_STUCK = """
import time
import torch
import mxnet_tpu_torch as mt
mesh = mt.parallel.make_mesh({"sp": 2}, devices=[mt.cpu()])
if mt.dist.rank() == 1:
    time.sleep(120)              # never joins the ring
print("rank 0 enters the ppermute", flush=True)
mt.parallel.ppermute(torch.ones(4), mesh.group("sp"), [(0, 1), (1, 0)])
"""


def test_launcher_timeout_ends_a_rank_stuck_in_a_collective():
    """Rank 0 waits in a ``ppermute`` whose peer never comes: the
    launcher's ``--timeout`` ends both (exit 124) long before gloo's own
    timeout."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", "2",
         "--force-cpu", "--timeout", "12", "--", sys.executable, "-c",
         _STUCK], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=90)
    assert res.returncode == 124, res.stderr[-3000:]
    assert "rank 0 enters the ppermute" in res.stdout
    assert "--timeout 12s expired; killing 2 worker(s)" in res.stderr
