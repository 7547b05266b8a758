"""Worker of ``tests/test_torch_dist.py``: two of these run under
``python -m mxnet_tpu_torch.launch -n 2 --force-cpu`` (gloo on the CPU)
and write what they saw into the directory given as the first argument:
``results-r<rank>.json`` and one ``.npz`` of parameters per case.
Imports only the port.

    python -m mxnet_tpu_torch.launch -n 2 --force-cpu -- \\
        python tests/torch_dist_worker.py OUT_DIR

Cases (every worker runs each, in this order):
- ``identity``: rank, worker count, backend, a barrier;
- ``mlp_<kv>``: ``tests/test_module_dp.py``'s MLP through ``Module.fit``
  on a ``dist_sync``, ``dist_async``, 2-bit (threshold 0.5) and fp16
  store, 4 batches of 32 rows per worker (global 64), SGD lr 0.1,
  momentum 0.9, each worker's initial parameters drawn from its own seed
  (rank 0's must win); saved: the parameters before the store, after
  ``init_optimizer``, after step 1 and at the end, the local gradients of
  step 1 and the store's wire bytes;
- ``bn_dist_sync``/``bn_dist_async``: the same with a BatchNorm after
  ``fc1`` (``bn_mlp``): the fused step over ``dist_sync`` takes its
  statistics over both workers' rows, the phase-split ``dist_async``
  path each worker's own (saved: the aux states at the end too);
- ``discipline``: mismatched key lists raise; with
  ``MXNET_KVSTORE_CHECK_PUSH=0`` the push goes through;
- ``gluon``: Dense(8) -> BatchNorm -> relu -> Dense(3) through
  ``gluon.Trainer(kvstore="dist_sync")`` (BatchNorm over each worker's
  own rows), 4 steps of 4 rows per worker, the last two again after a
  resume from step 2 through ``save_states``/``load_states``;
- ``lm``: the causal-attention LM of ``tests/test_torch_parallel.py``
  (V 64, E 32, 4 heads, S 16) through ``SPMDTrainer`` on a ``dp`` mesh
  of the two workers, global batch 4, 3 steps;
- ``fault1_dp2``/``fault1_dp4``: ROADMAP Queue 3 fault 1's ``apply_fn``
  (``x @ w.T`` normalised over the global batch's rows through
  ``batch_stats_over``) through ``SPMDTrainer``, one SGD step, on a
  ``dp`` mesh of the two workers (one Context each) and of both workers'
  two Contexts each (``dp`` 4: lines of threads and processes).
"""
import json
import os
import sys

import numpy as np
import torch

import mxnet_tpu_torch as mt

CPU = mt.cpu()
LOCAL, NB, D_IN, C = 32, 4, 16, 4


def toy_data(n=256, d=D_IN, c=C, seed=0):
    """``tests/test_module_dp.py``'s clusters."""
    rng = np.random.RandomState(seed)
    centers = rng.normal(0, 2, (c, d)).astype(np.float32)
    y = rng.randint(0, c, n)
    x = ((centers[y] + rng.normal(0, 0.5, (n, d))) / 3.0).astype(np.float32)
    return x, y.astype(np.float32)


def mlp(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=C, name="fc2")
    return pkg.sym.SoftmaxOutput(net, pkg.sym.Variable("softmax_label"),
                                 name="softmax")


def mlp_params(seed):
    rs = np.random.RandomState(seed)
    return {"fc1_weight": rs.normal(0, 0.3, (16, D_IN)).astype(np.float32),
            "fc1_bias": rs.normal(0, 0.1, (16,)).astype(np.float32),
            "fc2_weight": rs.normal(0, 0.3, (C, 16)).astype(np.float32),
            "fc2_bias": rs.normal(0, 0.1, (C,)).astype(np.float32)}


def bn_mlp(pkg):
    """``mlp`` with a BatchNorm (gamma trained) between fc1 and relu; fc1
    has no bias (a bias ahead of BatchNorm has a zero gradient in exact
    arithmetic: its updates would be rounding noise)."""
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=16, no_bias=True,
                                 name="fc1")
    net = pkg.sym.BatchNorm(net, fix_gamma=False, name="bn1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=C, name="fc2")
    return pkg.sym.SoftmaxOutput(net, pkg.sym.Variable("softmax_label"),
                                 name="softmax")


def bn_mlp_params(seed):
    p = mlp_params(seed)
    del p["fc1_bias"]
    rs = np.random.RandomState(seed + 1)
    p["bn1_gamma"] = rs.uniform(0.5, 1.5, (16,)).astype(np.float32)
    p["bn1_beta"] = rs.normal(0, 0.1, (16,)).astype(np.float32)
    return p


BN_AUX = {"bn1_moving_mean": np.zeros(16, np.float32),
          "bn1_moving_var": np.ones(16, np.float32)}


def local_shard(rank, world):
    """This worker's rows of each global batch of ``LOCAL * world``."""
    x, y = toy_data()
    g = LOCAL * world
    idx = np.concatenate([np.arange(i * g + rank * LOCAL,
                                    i * g + (rank + 1) * LOCAL)
                          for i in range(NB)])
    return x[idx], y[idx]


def _np(arrs):
    return {k: v.asnumpy() for k, v in arrs.items()}


def mlp_case(out, rank, world, kv_type, compression, bn=False):
    x, y = local_shard(rank, world)
    mod = mt.mod.Module((bn_mlp if bn else mlp)(mt), context=CPU,
                        compression_params=compression)
    mod.bind(data_shapes=[("data", (LOCAL, D_IN))],
             label_shapes=[("softmax_label", (LOCAL,))])
    mod.init_params(arg_params={k: mt.nd.array(v, ctx=CPU) for k, v in
                                (bn_mlp_params if bn else mlp_params)(
                                    100 + rank).items()},
                    aux_params={k: mt.nd.array(v, ctx=CPU)
                                for k, v in BN_AUX.items()} if bn else None)
    before = _np(mod.get_params()[0])
    mod.init_optimizer(kvstore=kv_type, optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    start = _np(mod.get_params()[0])
    batch = mt.io.DataBatch([mt.nd.array(x[:LOCAL], ctx=CPU)],
                            [mt.nd.array(y[:LOCAL], ctx=CPU)])
    aux0 = _np(mod.get_params()[1])
    mod.forward_backward(batch)
    grads = {n: mod._exec.grad_dict[n].asnumpy() for n in start}
    for n, arr in mod._exec.aux_dict.items():   # as if it never ran
        arr[:] = mt.nd.array(aux0[n], ctx=CPU)
    seen = {}

    def after_step(param):
        if param.nbatch == 0:
            seen.update(_np(mod.get_params()[0]))

    it = mt.io.NDArrayIter(x, y, batch_size=LOCAL)
    mod.fit(it, num_epoch=1, batch_end_callback=after_step)
    end = _np(mod.get_params()[0])
    kv = mod._kvstore
    arrays = {}
    for tag, d in (("before", before), ("start", start), ("step1", seen),
                   ("grad1", grads), ("end", end),
                   ("aux", _np(mod.get_params()[1]))):
        arrays.update({"%s/%s" % (tag, k): v for k, v in d.items()})
    np.savez(os.path.join(out, "%s_%s_%s-r%d.npz"
                          % ("bn" if bn else "mlp", kv_type,
                             (compression or {}).get("type", "none"),
                             rank)), **arrays)
    reason = mod._fused_fallback_reason
    return {"wire": kv.wire_bytes_last_push,
            "wire_raw": kv.wire_bytes_last_push_raw,
            "fallback": getattr(reason, "code", None),
            "update_on_kvstore": mod._update_on_kvstore}


def discipline_case(rank):
    kv = mt.kv.create("dist_sync")
    keys = [0, 1] if rank == 0 else [0, 2]
    for k in (0, 1, 2):
        kv.init(k, mt.nd.zeros((4,), ctx=CPU))
    vals = [mt.nd.ones((4,), ctx=CPU) for _ in keys]
    res = {}
    try:
        kv.push(keys, vals)
        res["raised"] = None
    except mt.MXNetError as e:
        res["raised"] = str(e)
    os.environ["MXNET_KVSTORE_CHECK_PUSH"] = "0"
    try:
        kv.push(keys, vals)
        out = mt.nd.zeros((4,), ctx=CPU)
        kv.pull(0, out=out)
        res["unchecked_sum"] = out.asnumpy().tolist()
    finally:
        del os.environ["MXNET_KVSTORE_CHECK_PUSH"]
    return res


def gluon_net(seed, pkg=mt):
    """The Gluon case's net in ``pkg`` (the port or the JAX package), on
    its CPU."""
    ctx = pkg.cpu()
    with pkg.name.NameManager():
        net = pkg.gluon.nn.HybridSequential(prefix="g_")
        with net.name_scope():
            net.add(pkg.gluon.nn.Dense(8, in_units=5))
            net.add(pkg.gluon.nn.BatchNorm(in_channels=8))
            net.add(pkg.gluon.nn.Activation("relu"))
            net.add(pkg.gluon.nn.Dense(3, in_units=8))
    net.initialize(pkg.init.Xavier(), ctx=ctx)
    rs = np.random.RandomState(seed)
    for p in net.collect_params().values():
        if p.name.endswith(("weight", "bias")):
            p.set_data(pkg.nd.array(rs.normal(0, 0.5, p.shape)
                                    .astype(np.float32), ctx=ctx))
    return net


def gluon_batches(world, steps=4, local=4):
    rs = np.random.RandomState(7)
    return [(rs.randn(local * world, 5).astype(np.float32),
             rs.randint(0, 3, local * world).astype(np.float32))
            for _ in range(steps)]


def gluon_step(net, tr, x, y, global_batch):
    L = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    with mt.autograd.record():
        loss = L(net(mt.nd.array(x, ctx=CPU)), mt.nd.array(y, ctx=CPU))
    loss.backward()
    tr.step(global_batch)


def gluon_case(out, rank, world, tmp):
    local = 4
    batches = gluon_batches(world, local=local)
    rows = slice(rank * local, (rank + 1) * local)
    net = gluon_net(200 + rank)
    before = {k: p.data().asnumpy() for k, p in
              net.collect_params().items()}
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1, "momentum": 0.9},
                          kvstore="dist_sync")
    start = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    for i, (x, y) in enumerate(batches):
        if i == 2:
            fname = os.path.join(tmp, "gluon-r%d.states" % rank)
            tr.save_states(fname)
            mid = {k: p.data().asnumpy()
                   for k, p in net.collect_params().items()}
        gluon_step(net, tr, x[rows], y[rows], local * world)
    end = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    # resume from the state after step 2: a new net and Trainer
    net2 = gluon_net(300 + rank)
    for k, p in net2.collect_params().items():
        p.set_data(mt.nd.array(mid[k], ctx=CPU))
    tr2 = mt.gluon.Trainer(net2.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9},
                           kvstore="dist_sync")
    tr2.load_states(fname)
    for x, y in batches[2:]:
        gluon_step(net2, tr2, x[rows], y[rows], local * world)
    resumed = {k: p.data().asnumpy() for k, p in
               net2.collect_params().items()}
    arrays = {}
    for tag, d in (("before", before), ("start", start), ("end", end),
                   ("resumed", resumed)):
        arrays.update({"%s/%s" % (tag, k): v for k, v in d.items()})
    np.savez(os.path.join(out, "gluon-r%d.npz" % rank), **arrays)
    return {"num_update": tr2._optimizer.num_update}


V, E, H, S, GB = 64, 32, 4, 16, 4


def lm_params():
    """``tests/test_torch_parallel.py``'s LM parameters."""
    rng = np.random.RandomState(0)
    shapes = [("embed", (V, E)), ("wq", (E, E)), ("wk", (E, E)),
              ("wv", (E, E)), ("wo", (E, E)), ("w1", (4 * E, E)),
              ("w2", (E, 4 * E)), ("head", (V, E))]
    return {n: rng.normal(0, 0.02, s).astype(np.float32) for n, s in shapes}


def lm_batches(n=3):
    return [(np.random.RandomState(10 + i).randint(0, V, (GB, S))
             .astype(np.int32),
             np.random.RandomState(20 + i).randint(0, V, (GB, S))
             .astype(np.int32)) for i in range(n)]


def lm_apply(mesh, batch):
    d = E // H

    def attn(q, k, v):
        return mt.parallel.ulysses_attention(q, k, v, mesh, axis_name="sp",
                                             batch_axis_name="dp",
                                             causal=True)

    def apply_fn(p, x, y):
        e = p["embed"][x.long()]

        def split(t):
            return t.reshape(batch, S, H, d).permute(0, 2, 1, 3)
        a = attn(split(e @ p["wq"].T), split(e @ p["wk"].T),
                 split(e @ p["wv"].T))
        h = e + a.permute(0, 2, 1, 3).reshape(batch, S, E) @ p["wo"].T
        h = h + torch.relu(h @ p["w1"].T) @ p["w2"].T
        logp = torch.log_softmax(h @ p["head"].T, dim=-1)
        return (-logp.gather(-1, y.long()[..., None])).mean()
    return apply_fn


def lm_case(out, rank, world):
    mesh = mt.parallel.make_mesh({"dp": -1, "sp": 1, "tp": 1},
                                 devices=[CPU])
    assert mesh.shape["dp"] == world and mesh.is_process_spanning
    P = mt.parallel.P
    tr = mt.parallel.SPMDTrainer(lm_apply(mesh, GB // world), lm_params(),
                                 mesh, data_axis="dp", tp_axis="tp",
                                 learning_rate=0.1, momentum=0.9,
                                 batch_specs=[P("dp", "sp"), P("dp", "sp")])
    losses = [float(tr.step(x, y)) for x, y in lm_batches()]
    np.savez(os.path.join(out, "lm-r%d.npz" % rank), **tr.get_params())
    return {"losses": losses}


def fault1_data():
    """Global batch 8 of a 5-wide input, a 3-wide target, one weight."""
    rs = np.random.RandomState(0)
    return (rs.randn(8, 5).astype(np.float32),
            rs.randn(8, 3).astype(np.float32),
            {"w": rs.randn(3, 5).astype(np.float32)})


def fault1_apply(mesh):
    """The port's ``apply_fn``: this member's rows, the statistics taken
    over the ``dp`` axis through ``batch_stats_over``."""
    from mxnet_tpu_torch.ops import nn as tnn

    def apply_fn(p, x, y):
        h = x @ p["w"].T
        one, zero = torch.ones(3), torch.zeros(3)
        with tnn.batch_stats_over(group=mesh.group("dp")):
            hn = tnn.batch_norm(h, one, zero, zero, one, eps=1e-5,
                                fix_gamma=False, _train=True)[0]
        return ((hn - y) ** 2).mean()
    return apply_fn


def fault1_case(out, rank, devices):
    mesh = mt.parallel.make_mesh({"dp": -1}, devices=devices)
    x, y, params = fault1_data()
    tr = mt.parallel.SPMDTrainer(fault1_apply(mesh), params, mesh,
                                 learning_rate=0.1)
    loss = float(tr.step(x, y))
    name = "fault1_dp%d" % mesh.shape["dp"]
    np.savez(os.path.join(out, "%s-r%d.npz" % (name, rank)),
             **tr.get_params())
    return {"loss": loss, "dp": mesh.shape["dp"]}


def main(out):
    rank, world = mt.dist.rank(), mt.dist.process_count()
    res = {}
    kv = mt.kv.create("dist_sync")
    kv.barrier()
    mt.parallel.barrier()
    res["identity"] = {"rank": kv.rank, "num_workers": kv.num_workers,
                       "backend": mt.dist.backend(),
                       "telemetry_rank":
                           mt.telemetry.process_identity()["rank"]}
    for kv_type, comp in (("dist_sync", None), ("dist_async", None),
                          ("dist_sync", {"type": "2bit", "threshold": 0.5}),
                          ("dist_sync", {"type": "fp16"})):
        name = "mlp_%s_%s" % (kv_type, (comp or {}).get("type", "none"))
        res[name] = mlp_case(out, rank, world, kv_type, comp)
    for kv_type in ("dist_sync", "dist_async"):
        res["bn_%s_none" % kv_type] = mlp_case(out, rank, world, kv_type,
                                               None, bn=True)
    res["discipline"] = discipline_case(rank)
    res["gluon"] = gluon_case(out, rank, world, out)
    res["lm"] = lm_case(out, rank, world)
    for devices in ([CPU], [mt.cpu(0), mt.cpu(1)]):
        got = fault1_case(out, rank, devices)
        res["fault1_dp%d" % got["dp"]] = got
    with open(os.path.join(out, "results-r%d.json" % rank), "w") as f:
        json.dump(res, f)
    mt.dist.finalize()


if __name__ == "__main__":
    main(sys.argv[1])
