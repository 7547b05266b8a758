"""Worker of ``tests/test_torch_elastic.py``: N of these run under

    python -m mxnet_tpu_torch.launch -n N --force-cpu \\
        --heartbeat-dir HB --heartbeat-interval 0.2 --heartbeat-timeout 3 \\
        -- python tests/torch_elastic_worker.py OUT_DIR CASE

and train the MLP of ``tools/module_fit_probe.py``'s dist lane (D 16, a
hidden layer of 32, 4 classes) through ``Module.fit`` on ``dist_sync``:
a global batch of 32 split over the workers, 6 batches an epoch, 3
epochs, SGD lr 0.05, momentum 0.9. Every worker keeps its own slice of
the global batch after a member loss. Rank 1 is the victim:

- ``kill=N``: its ``kv_collective`` fault site raises at gate crossing N
  and it dies through ``dist.abort(FAULT_RC)``;
- ``sigkill=N``: it SIGKILLs itself just after its N-th crossing of the
  ``step`` gate, with that step's collectives still ahead;
- ``nockpt``: no checkpoint manager (the survivors must re-raise).

Writes ``r<rank>.json`` (the ``elastic.*`` counters, the events, the
membership, the outcome) and ``r<rank>.npz`` (the parameters at the
end) under ``OUT_DIR``; the victim writes ``victim.json`` with the time
of its death. Imports only the port.
"""
import json
import os
import signal
import sys
import time

import numpy as np

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import heartbeat

D, H, C = 16, 32, 4
GLOBAL, NB, EPOCHS, SEED = 32, 6, 3, 1234
FAULT_RC = 17
VICTIM = 1


def mlp(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=H, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=C, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def global_batches():
    rs = np.random.RandomState(SEED)
    return [(rs.uniform(-1, 1, (GLOBAL, D)).astype(np.float32),
             rs.randint(0, C, GLOBAL).astype(np.float32))
            for _ in range(NB)]


def rows(rank, nproc):
    """This worker's rows of every global batch (x, y) stacked in batch
    order, and its local batch size."""
    local = GLOBAL // nproc
    sl = slice(rank * local, (rank + 1) * local)
    bs = global_batches()
    return (np.concatenate([x[sl] for x, _ in bs]),
            np.concatenate([y[sl] for _, y in bs]), local)


def kv_init_crossings(sym):
    """Gate crossings before the first step: ``Module.init_optimizer``
    calls ``kv.init`` once with every parameter's key, and a call with
    new keys crosses the store's gate once before its broadcasts."""
    return 1


def crossing_of(sym, epoch, nbatch):
    """The victim's gate crossing (1-based, the ``kv_collective`` site's
    call number) at the step of ``(epoch, nbatch)``: the ``kv.init``
    crossings, then one ``step`` crossing a fused step."""
    return kv_init_crossings(sym) + epoch * NB + nbatch + 1


def _sigkill_after(n):
    """SIGKILL this process right after its ``n``-th ``step``-gate
    crossing (the step's collectives not yet entered)."""
    orig = heartbeat.CollectiveGate.arrive_and_wait
    seen = [0]

    def arrive_and_wait(self):
        gen = orig(self)
        if self.channel == "step":
            seen[0] += 1
            if seen[0] == n:
                _victim_note("sigkill")
                os.kill(os.getpid(), signal.SIGKILL)
        return gen
    heartbeat.CollectiveGate.arrive_and_wait = arrive_and_wait


def _victim_note(how):
    with open(os.path.join(OUT, "victim.json"), "w") as f:
        json.dump({"how": how, "t": time.time()}, f)


def main(out, case):
    rank, nproc = mt.dist.rank(), mt.dist.process_count()
    opts = dict(kv.split("=") for kv in case.split(",") if "=" in kv)
    sym = mlp(mt)
    x, y, local = rows(rank, nproc)
    it = mt.io.NDArrayIter(x, y, batch_size=local)
    mgr = None
    if "nockpt" not in case:
        mgr = mt.CheckpointManager(
            os.path.join(out, "ckpt", "r%d" % rank, "model"), keep_last=4)
    if rank == VICTIM and "kill" in opts:
        mt.faults.configure("kv_collective:raise:n=%d" % int(opts["kill"]))
    if rank == VICTIM and "sigkill" in opts:
        _sigkill_after(int(opts["sigkill"]))
    mt.telemetry.enable()
    mt.telemetry.reset()
    np.random.seed(SEED)
    mod = mt.mod.Module(sym, context=mt.cpu())
    res = {"rank": rank, "nproc": nproc, "completed": False}
    try:
        mod.fit(it, num_epoch=EPOCHS, kvstore="dist_sync",
                initializer=mt.initializer.Xavier(), optimizer="sgd",
                optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
                checkpoint=mgr)
        res["completed"] = True
    except mt.faults.InjectedFault:
        _victim_note("kv_collective")
        mt.dist.abort(FAULT_RC)
    except heartbeat.DeadWorkerError as e:
        res["raised"] = {"type": "DeadWorkerError", "ranks": list(e.ranks),
                         "channel": e.channel, "epoch": e.epoch,
                         "nbatch": e.nbatch, "t": time.time()}
    snap = mt.telemetry.counters()
    res["counters"] = {k: v for k, v in snap.items()
                       if k.startswith(("elastic.", "heartbeat.",
                                        "kvstore.dist"))}
    res["events"] = [{"kind": e["kind"], "data": e.get("data"),
                      "ts": e["ts"]}
                     for e in mt.telemetry.events()
                     if e["kind"].startswith("elastic.")]
    res["dead_ranks"] = list(mt.dist.dead_ranks())
    res["live_ranks"] = list(mt.dist.live_ranks())
    res["kv_live_ranks"] = list(mod._kvstore.live_ranks) \
        if mod._kvstore is not None else None
    res["kv_init_crossings"] = kv_init_crossings(sym)
    res["t_end"] = time.time()
    if res["completed"]:
        arg, _ = mod.get_params()
        np.savez(os.path.join(out, "r%d.npz" % rank),
                 **{k: v.asnumpy() for k, v in arg.items()})
    with open(os.path.join(out, "r%d.json" % rank), "w") as f:
        json.dump(res, f)
    mt.dist.finalize()


if __name__ == "__main__":
    OUT = sys.argv[1]
    main(OUT, sys.argv[2])
