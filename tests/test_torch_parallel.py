"""The port's parallel package on one device, against the JAX package.

Plain attention, decode attention, ring and Ulysses attention (forward
and gradients, with the flash kernels' plain versions standing in for
the CUDA kernels on the CPU), the optimizers and their SPMD kernels, and
the slice as a whole: the causal-attention LM of ``__graft_entry__.py``
trained 3 steps through ``SPMDTrainer`` in both packages from the same
numpy parameters and batches, with ring and with Ulysses attention.
"""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.parallel import opt_kernels as jopt_kernels

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.kernels import flash_attention as K

from torch_dist_worker import fault1_data, fault1_apply


def _qkv(seed, shape=(2, 4, 16, 8)):
    rs = np.random.RandomState(seed)
    return [rs.normal(size=shape).astype(np.float32) for _ in range(3)]


def _jax_mesh():
    return jpar.make_mesh({"dp": 1, "sp": 1, "tp": 1},
                          devices=jax.devices()[:1])


def _port_mesh():
    return tpar.make_mesh({"dp": 1, "sp": 1, "tp": 1}, devices=[mt.cpu()])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("offsets", [(0, 0), (8, 0), (0, 8)])
def test_attention_matches_jax(causal, offsets):
    q, k, v = _qkv(0)
    qo, ko = offsets
    want = np.asarray(jpar.attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     q_offset=qo, kv_offset=ko))
    got = tpar.attention(*[torch.from_numpy(a) for a in (q, k, v)],
                         causal=causal, q_offset=qo, kv_offset=ko)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    if causal and ko > qo:       # some rows see no key: zeroed, not NaN
        assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("length", [0, 1, 7, 12])
def test_decode_attention_matches_jax(length):
    rs = np.random.RandomState(1)
    q = rs.normal(size=(4, 8)).astype(np.float32)
    kc = rs.normal(size=(4, 12, 8)).astype(np.float32)
    vc = rs.normal(size=(4, 12, 8)).astype(np.float32)
    from mxnet_tpu.parallel.ring_attention import decode_attention
    want = np.asarray(decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                       jnp.asarray(vc), length))
    got = tpar.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                torch.from_numpy(vc), length)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def _jax_fn(name, mesh, causal, use_pallas):
    fn = getattr(jpar, name)
    return lambda q, k, v: fn(q, k, v, mesh, axis_name="sp",
                              batch_axis_name="dp", causal=causal,
                              use_pallas=use_pallas)


def _port_fn(name, mesh, causal, use_pallas):
    fn = getattr(tpar, name)
    return lambda q, k, v: fn(q, k, v, mesh, axis_name="sp",
                              batch_axis_name="dp", causal=causal,
                              use_pallas=use_pallas)


_JAX_ATTENTION = {}


def _jax_attention(name, causal, q, k, v, w):
    """JAX's ``use_pallas=True`` route (Pallas in interpret mode, seconds a
    call): the output and the gradients of ``sum(out * w)``, computed once
    per (route, causal) for the three port routes that are held to it."""
    key = (name, causal)
    if key not in _JAX_ATTENTION:
        jfn = _jax_fn(name, _jax_mesh(), causal, True)

        def jloss(q, k, v):
            return jnp.sum(jfn(q, k, v) * w)
        jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
        _JAX_ATTENTION[key] = (np.asarray(jfn(jq, jk, jv)), [
            np.asarray(g) for g in jax.grad(jloss, argnums=(0, 1, 2))(
                jq, jk, jv)])
    return _JAX_ATTENTION[key]


@pytest.mark.parametrize("use_pallas", [True, False, None])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", ["ring_attention", "ulysses_attention"])
def test_sequence_parallel_attention_matches_jax(name, causal, use_pallas):
    """Forward and gradients on a one-device mesh against JAX's
    ``use_pallas=True`` route (Pallas in interpret mode): the port's
    kernel route on CPU tensors runs the kernels' plain versions, its
    plain route plain PyTorch; both must agree."""
    q, k, v = _qkv(2)
    w = np.random.RandomState(3).normal(size=q.shape).astype(np.float32)
    want_out, want_grads = _jax_attention(name, causal, q, k, v, w)

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = _port_fn(name, _port_mesh(), causal, use_pallas)(tq, tk, tv)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=2e-5,
                               atol=2e-5)
    for nm, t, g in zip("qkv", (tq, tk, tv), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4,
                                   atol=1e-4, err_msg="d" + nm)


def test_sequence_parallel_attention_takes_ndarrays():
    q, k, v = _qkv(4)
    mesh = _port_mesh()
    nds = [mt.nd.array(a, ctx=mt.cpu()) for a in (q, k, v)]
    want = tpar.attention(*[torch.from_numpy(a) for a in (q, k, v)],
                          causal=True)
    for fn in (tpar.ring_attention, tpar.ulysses_attention):
        out = fn(*nds, mesh, causal=True)
        assert isinstance(out, mt.nd.NDArray)
        np.testing.assert_allclose(out.asnumpy(), want.numpy(), rtol=2e-5,
                                   atol=2e-5)


def test_make_mesh_one_device_only(monkeypatch):
    """One-device meshes as before; any axis may span several Contexts
    (``cpu(0)`` and ``cpu(1)`` are two), each device taking the
    coordinate ``np.array(devices).reshape(sizes)`` gives it; duplicate
    Contexts raise as in the JAX package."""
    mesh = tpar.make_mesh({"dp": -1, "sp": 1}, devices=[mt.cpu()])
    assert mesh.shape == {"dp": 1, "sp": 1} and mesh.device == mt.cpu()
    assert tpar.default_mesh is not None
    two = tpar.make_mesh({"dp": 2}, devices=[mt.cpu(0), mt.cpu(1)])
    assert two.shape == {"dp": 2} and two.devices == [mt.cpu(0), mt.cpu(1)]
    assert tpar.make_mesh({"dp": -1}, devices=[mt.cpu(0), mt.cpu(1)]).size \
        == 2 and not two.is_process_spanning
    grid = tpar.make_mesh({"dp": 1, "sp": 2, "tp": 2},
                          devices=[mt.cpu(i) for i in range(4)])
    want = np.arange(4).reshape(1, 2, 2)
    got = grid.run_local(lambda j: (grid.coords(), grid.axis_index("tp"),
                                    grid.axis_index(("sp", "tp")),
                                    grid.group("sp").index, grid.device))
    for j, (coords, tpi, spt, spi, dev) in enumerate(got):
        assert want[coords["dp"], coords["sp"], coords["tp"]] == j
        assert (tpi, spt, spi, dev) == (coords["tp"], j, coords["sp"],
                                        mt.cpu(j))
    with pytest.raises(mt.MXNetError, match="run_local"):
        grid.device
    with pytest.raises(mt.MXNetError, match="duplicate devices"):
        tpar.make_mesh({"dp": 2}, devices=[mt.cpu(0), mt.cpu(0)])
    with pytest.raises(mt.MXNetError, match="at most one"):
        tpar.make_mesh({"dp": -1, "sp": -1}, devices=[mt.cpu()])
    # the default device list is [gpu(0)]: without a card it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        tpar.make_mesh({"dp": 1, "sp": 1})
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        tpar.default_mesh()


def test_ulysses_head_check_and_wide_axes_raise():
    """The head-divisibility check comes first (a stand-in mesh with an
    'sp' axis of 2, ``mxnet_tpu`` ``ulysses.py:84-89``); axes the mesh
    lacks raise; a member that fails inside ``run_local`` takes the
    others out of their collectives, and its error is the one raised."""
    q = torch.zeros(1, 3, 4, 8)
    wide = types.SimpleNamespace(shape={"dp": 1, "sp": 2})
    with pytest.raises(mt.MXNetError, match="divisible"):
        tpar.ulysses_attention(q, q, q, wide)
    q4 = torch.zeros(1, 4, 4, 8)
    with pytest.raises(mt.MXNetError, match="no axis 'dp'"):
        tpar.ring_attention(q4, q4, q4,
                            tpar.make_mesh({"sp": 1}, devices=[mt.cpu()]),
                            batch_axis_name="dp")
    mesh = tpar.make_mesh({"sp": 2}, devices=[mt.cpu(0), mt.cpu(1)])

    def member(j):
        if j == 1:
            raise ValueError("member 1 fails")
        return tpar.ring_attention(q4, q4, q4, mesh)
    with pytest.raises(ValueError, match="member 1 fails"):
        mesh.run_local(member)
    # the mesh works again afterwards
    out = mesh.run_local(lambda j: tpar.ring_attention(q4, q4, q4, mesh))
    assert all(o.shape == q4.shape for o in out)


def _in_process(axes):
    n = int(np.prod(list(axes.values())))
    return tpar.make_mesh(axes, devices=[mt.cpu(i) for i in range(n)])


def _member_block(a, mesh, spec):
    return tpar.shard_put(a, tpar.Placement(mesh, spec))


@pytest.mark.parametrize("name", ["ring_attention", "ulysses_attention"])
def test_sequence_parallel_attention_in_process_matches_jax(name):
    """sp 2 over two Contexts of this process (a thread each): the
    members' output blocks and gradients against the JAX function on a
    2-device mesh (plain routes on both sides)."""
    q, k, v = _qkv(6)
    w = np.random.RandomState(7).normal(size=q.shape).astype(np.float32)
    jmesh = jpar.make_mesh({"sp": 2}, devices=jax.devices()[:2])
    jfn = getattr(jpar, name)

    @jax.jit
    def jout_and_grads(q, k, v):
        out, vjp = jax.vjp(lambda *a: jfn(*a, jmesh, causal=True,
                                          use_pallas=False), q, k, v)
        return out, vjp(jnp.asarray(w))
    want, wgrads = jout_and_grads(*(jnp.asarray(a) for a in (q, k, v)))
    want = np.asarray(want)
    mesh = _in_process({"sp": 2})
    spec = tpar.P(None, None, "sp", None)

    def member(j):
        tq, tk, tv = (_member_block(a, mesh, spec).requires_grad_()
                      for a in (q, k, v))
        out = getattr(tpar, name)(tq, tk, tv, mesh, causal=True)
        (out * _member_block(w, mesh, spec)).sum().backward()
        return out.detach(), tq.grad, tk.grad, tv.grad
    got = mesh.run_local(member)
    np.testing.assert_allclose(torch.cat([g[0] for g in got], 2).numpy(),
                               want, rtol=2e-5, atol=2e-5)
    for i, wg in enumerate(wgrads):
        np.testing.assert_allclose(
            torch.cat([g[1 + i] for g in got], 2).numpy(), np.asarray(wg),
            rtol=1e-4, atol=1e-4)


# -- ROADMAP Queue 3, fault 1: batch statistics over the dp mesh ------------------

def fault1_jax_loss_and_w(n_dev=2):
    """The JAX trainer: ``x @ w.T`` normalised over the global batch's
    rows, one SGD step at lr 0.1 on an ``n_dev``-device dp mesh."""
    x, y, params = fault1_data()
    mesh = jpar.make_mesh({"dp": n_dev}, devices=jax.devices()[:n_dev])

    def apply_fn(p, x, y):
        h = x @ p["w"].T
        hn = (h - h.mean(0)) * jax.lax.rsqrt(h.var(0) + 1e-5)
        return jnp.mean((hn - y) ** 2)
    tr = jpar.SPMDTrainer(apply_fn, params, mesh, learning_rate=0.1)
    loss = float(np.asarray(tr.step(x, y)))
    return loss, tr.get_params()["w"]


def test_spmd_trainer_batch_statistics_over_the_mesh():
    """ROADMAP Queue 3, fault 1: an ``apply_fn`` whose statistics mix
    rows gives the JAX trainer's loss and weights on a 2-device dp mesh
    of two Contexts (each member sees its 4 rows; ``batch_stats_over``
    takes the statistics over both)."""
    jl, jw = fault1_jax_loss_and_w()
    x, y, params = fault1_data()
    mesh = _in_process({"dp": 2})
    tr = tpar.SPMDTrainer(fault1_apply(mesh), params, mesh,
                          learning_rate=0.1)
    assert abs(float(tr.step(x, y)) - jl) <= 1e-5
    np.testing.assert_allclose(tr.get_params()["w"], jw, rtol=1e-5,
                               atol=1e-6)
    reps = tr._members
    assert torch.equal(reps[0]["params"]["w"], reps[1]["params"]["w"])


def test_lm_dp_sp_tp_in_process_matches_jax():
    """The graft LM over ``{"dp": 1, "sp": 2, "tp": 2}`` on four Contexts
    of this process (``__graft_entry__.py:63-115`` at the tests' width):
    3 steps, losses and parameters against the JAX trainer on 4 devices;
    each member stores half of every matrix."""
    axes = {"dp": 1, "sp": 2, "tp": 2}
    jmesh = jpar.make_mesh(axes, devices=jax.devices()[:4])
    tmesh = _in_process(axes)
    jattn = _jax_fn("ring_attention", jmesh, True, False)
    jtr = jpar.SPMDTrainer(_jax_lm(jattn), _lm_params(), jmesh,
                           data_axis="dp", tp_axis="tp", learning_rate=0.1,
                           momentum=0.9,
                           batch_specs=[JP("dp", "sp"), JP("dp", "sp")])

    def tattn(q, k, v):
        return tpar.ring_attention(q, k, v, tmesh, axis_name="sp",
                                   batch_axis_name="dp", causal=True)
    ttr = tpar.SPMDTrainer(_port_lm(tattn, seq=S // 2), _lm_params(), tmesh,
                           data_axis="dp", tp_axis="tp", learning_rate=0.1,
                           momentum=0.9,
                           batch_specs=[tpar.P("dp", "sp"),
                                        tpar.P("dp", "sp")])
    for x, y in _batches():
        np.testing.assert_allclose(float(ttr.step(x, y)),
                                   float(np.asarray(jtr.step(x, y))),
                                   rtol=1e-5, atol=1e-6)
    jp, tp = jtr.get_params(), ttr.get_params()
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], rtol=1e-5, atol=1e-6,
                                   err_msg=n)
        assert ttr.params[n].shape[0] == jp[n].shape[0] // 2


@pytest.mark.parametrize("name,kwargs", [
    ("sgd", dict(learning_rate=0.1, momentum=0.9)),
    ("sgd", dict(learning_rate=0.05, wd=1e-4, clip_gradient=0.5,
                 rescale_grad=0.25)),
    ("nag", dict(learning_rate=0.1, momentum=0.8, wd=1e-3)),
    ("NAG", dict(learning_rate=0.2)),
])
def test_spmd_hyperparameters_match_jax(name, kwargs):
    want = jopt_kernels.hyper_from_optimizer(jmx.optimizer.create(name,
                                                                  **kwargs))
    got = tpar.opt_kernels.hyper_from_optimizer(
        mt.optimizer.create(name, **kwargs))
    assert got == want


@pytest.mark.parametrize("name,kwargs", [
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-3)),
    ("sgd", dict(learning_rate=0.1, clip_gradient=0.3, rescale_grad=0.5)),
    ("nag", dict(learning_rate=0.1, momentum=0.9, wd=1e-3,
                 clip_gradient=0.3)),
])
def test_spmd_kernels_and_eager_update_match_jax(name, kwargs):
    """Three updates of one parameter by the SPMD kernel and by the eager
    ``Optimizer.update`` (in place on NDArrays), against JAX's kernel."""
    rs = np.random.RandomState(5)
    w0 = rs.normal(size=(6, 5)).astype(np.float32)
    grads = [rs.normal(size=w0.shape).astype(np.float32) for _ in range(3)]
    kname, h = jopt_kernels.hyper_from_optimizer(
        jmx.optimizer.create(name, **kwargs))
    jinit, jupd = jopt_kernels.get_kernel(kname)
    tinit, tupd = tpar.opt_kernels.get_kernel(kname)
    jw, tw = jnp.asarray(w0), torch.from_numpy(w0.copy())
    js, ts = jinit(jw), tinit(tw)
    opt = mt.optimizer.create(name, **kwargs)
    ew = mt.nd.array(w0, ctx=mt.cpu())
    es = opt.create_state(0, ew)
    for t, g in enumerate(grads, 1):
        jw, js = jupd(jw, jnp.asarray(g), js, t, h)
        tw, ts = tupd(tw, torch.from_numpy(g), ts, t, h)
        opt.update(0, ew, mt.nd.array(g, ctx=mt.cpu()), es)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(ew.asnumpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)


def test_unported_optimizers_and_bad_inputs_raise():
    with pytest.raises(mt.MXNetError, match="no SPMD kernel"):
        tpar.opt_kernels.get_kernel("sgld")
    with pytest.raises(mt.MXNetError, match="not registered"):
        mt.optimizer.create("no_such_optimizer")
    with pytest.raises(mt.MXNetError, match="not a numeric array"):
        mt.weights.tree_from_numpy({"w": [1.0, 2.0]}, ctx=mt.cpu())
    with pytest.raises(mt.MXNetError, match="expected a dict"):
        mt.weights.tree_from_numpy([np.zeros(2)], ctx=mt.cpu())
    tree = mt.weights.tree_from_numpy(
        {"a": np.zeros((2, 3)), "b": torch.ones(2, dtype=torch.int32)},
        ctx=mt.cpu())
    assert tree["a"].dtype == torch.float32 and tree["b"].dtype == torch.int32
    mesh = _port_mesh()
    params = {"w": np.zeros((4, 4), np.float32)}
    with pytest.raises(mt.MXNetError, match="names axis 'mp'"):
        tpar.SPMDTrainer(lambda p, x, y: p["w"].sum(), params, mesh,
                         param_specs={"w": tpar.P("mp", None)})
    with pytest.raises(mt.MXNetError, match="more entries"):
        tpar.SPMDTrainer(lambda p, x, y: p["w"].sum(), params, mesh,
                         param_specs={"w": tpar.P("tp", None, None)})
    tr = tpar.SPMDTrainer(lambda p, x: p["w"].sum(), params, mesh,
                          n_batch_args=1)
    with pytest.raises(mt.MXNetError, match="2 batch args"):
        tr.step(np.zeros(2), np.zeros(2))
    assert tpar.shard_params_rule(params, mesh, "tp") == {"w": ("tp", None)}


# -- the slice as a whole: the graft LM through SPMDTrainer -------------------

V, E, H, B, S = 64, 32, 4, 2, 16
D = E // H


def _lm_params():
    """The graft LM's parameters (``__graft_entry__.py:76-86``)."""
    rng = np.random.RandomState(0)
    return {
        "embed": rng.normal(0, 0.02, (V, E)).astype(np.float32),
        "wq": rng.normal(0, 0.02, (E, E)).astype(np.float32),
        "wk": rng.normal(0, 0.02, (E, E)).astype(np.float32),
        "wv": rng.normal(0, 0.02, (E, E)).astype(np.float32),
        "wo": rng.normal(0, 0.02, (E, E)).astype(np.float32),
        "w1": rng.normal(0, 0.02, (4 * E, E)).astype(np.float32),
        "w2": rng.normal(0, 0.02, (E, 4 * E)).astype(np.float32),
        "head": rng.normal(0, 0.02, (V, E)).astype(np.float32),
    }


def _batches(n=3):
    return [(np.random.RandomState(10 + i).randint(0, V, (B, S))
             .astype(np.int32),
             np.random.RandomState(20 + i).randint(0, V, (B, S))
             .astype(np.int32)) for i in range(n)]


def _jax_lm(attn):
    """``__graft_entry__.py:88-104`` with the attention as a parameter."""
    def apply_fn(p, x, y):
        e = jnp.take(p["embed"], x, axis=0)
        q = (e @ p["wq"].T).reshape(B, S, H, D).transpose(0, 2, 1, 3)
        k = (e @ p["wk"].T).reshape(B, S, H, D).transpose(0, 2, 1, 3)
        v = (e @ p["wv"].T).reshape(B, S, H, D).transpose(0, 2, 1, 3)
        a = attn(q, k, v)
        a = a.transpose(0, 2, 1, 3).reshape(B, S, E) @ p["wo"].T
        h = e + a
        h = h + jnp.maximum(h @ p["w1"].T, 0) @ p["w2"].T
        logp = jax.nn.log_softmax(h @ p["head"].T)
        return jnp.mean(-jnp.take_along_axis(logp, y[..., None], axis=-1))
    return apply_fn


def _port_lm(attn, seq=S):
    """The same LM in PyTorch, as ``chip_smoke.py`` drives it, on a
    member's ``seq`` positions."""
    def apply_fn(p, x, y, S=seq):
        e = p["embed"][x.long()]
        q = (e @ p["wq"].T).reshape(B, S, H, D).permute(0, 2, 1, 3)
        k = (e @ p["wk"].T).reshape(B, S, H, D).permute(0, 2, 1, 3)
        v = (e @ p["wv"].T).reshape(B, S, H, D).permute(0, 2, 1, 3)
        a = attn(q, k, v)
        a = a.permute(0, 2, 1, 3).reshape(B, S, E) @ p["wo"].T
        h = e + a
        h = h + torch.relu(h @ p["w1"].T) @ p["w2"].T
        logp = torch.log_softmax(h @ p["head"].T, dim=-1)
        return (-logp.gather(-1, y.long()[..., None])).mean()
    return apply_fn


@pytest.mark.parametrize("use_pallas", [True, None])
@pytest.mark.parametrize("name", ["ring_attention", "ulysses_attention"])
def test_lm_three_spmd_steps_match_jax(name, use_pallas):
    """Losses of every step and every parameter after step 3 agree at
    the tolerance of the graft's own oracle (rtol 1e-5, atol 1e-6,
    ``__graft_entry__.py:129-134``). JAX runs its Pallas route (interpret
    mode); the port its kernel route (the kernels' plain versions on CPU
    tensors) or, with ``use_pallas=None`` on the CPU, plain PyTorch."""
    params = _lm_params()
    jmesh, tmesh = _jax_mesh(), _port_mesh()
    jattn = _jax_fn(name, jmesh, True, True)
    tattn = _port_fn(name, tmesh, True, use_pallas)
    jtr = jpar.SPMDTrainer(_jax_lm(jattn), params, jmesh, data_axis="dp",
                           tp_axis="tp", learning_rate=0.1, momentum=0.9,
                           batch_specs=[JP("dp", "sp"), JP("dp", "sp")])
    ttr = tpar.SPMDTrainer(_port_lm(tattn), params, tmesh, data_axis="dp",
                           tp_axis="tp", learning_rate=0.1, momentum=0.9,
                           batch_specs=[tpar.P("dp", "sp"),
                                        tpar.P("dp", "sp")])
    assert (ttr.lr, ttr.momentum, ttr.wd) == (jtr.lr, jtr.momentum, jtr.wd)
    launches = (K.fwd_launches, K.bwd_launches)
    for x, y in _batches():
        jl = float(np.asarray(jax.device_get(jtr.step(x, y))))
        tl = float(ttr.step(x, y))
        assert np.isfinite(tl)
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    jp, tp = jtr.get_params(), ttr.get_params()
    assert sorted(jp) == sorted(tp)
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], rtol=1e-5, atol=1e-6,
                                   err_msg=n)
    for n, m in ttr.mom.items():
        np.testing.assert_allclose(m.numpy(), np.asarray(jtr.mom[n]),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    # CPU tensors take the plain versions, which count no launch
    assert (K.fwd_launches, K.bwd_launches) == launches
