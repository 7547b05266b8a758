"""Worker of ``tests/test_torch_engine_mesh.py``: one rank of ``python -m
mxnet_tpu_torch.launch -n 4 --force-cpu``.

Every rank builds the same engines and module, in the same order, from
fixed numpy seeds (the test process makes the same weights and inputs
for its one-process runs) and writes ``<leg>-r<rank>.npz`` under the
output directory:

- ``serve_mp4``/``serve_dp2mp2``: an ``InferenceEngine`` over ``{"dp": 1,
  "mp": 4}`` and ``{"dp": 2, "mp": 2}`` with the rules of
  ``SERVE_RULES``: rank 0 serves ``serve_requests()`` and writes the
  outputs; the followers check that ``submit`` raises and follow until
  rank 0 closes; every rank writes its members' parameter bytes;
- ``decode_mp4``: a ``DecodeEngine`` over ``{"dp": 1, "mp": 4}`` under
  ``DECODE_PARTITION_RULES``, then the same cache replicated
  (``partition_rules=[]``): rank 0 generates ``decode_prompts()``; every
  rank writes its ``kv_cache_bytes`` of both;
- ``module_dp2mp2``: the MLP ``Module`` over ``{"dp": 2, "mp": 2}`` (one
  context a process), three fused steps of ``module_batches()``: the
  gathered parameters and the member's shards.
"""
import os
import sys

import numpy as np
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.decode import AttentionDecodeCell, DecodeEngine
from mxnet_tpu_torch.io import DataBatch, DataDesc
from mxnet_tpu_torch.parallel import PartitionRules, P
from mxnet_tpu_torch.parallel.ring_attention import DECODE_PARTITION_RULES
from mxnet_tpu_torch.serving import InferenceEngine

CPU = mt.cpu()
SERVE_RULES = [(r"fc\d_weight$", P("mp", None)), (r"fc\d_bias$", P("mp"))]
SERVE_CASES = (("serve_mp4", {"dp": 1, "mp": 4}, None),
               ("serve_dp2mp2", {"dp": 2, "mp": 2}, [2, 4, 8]))
DECODE_AXES = {"dp": 1, "mp": 4}
MODULE_AXES = {"dp": 2, "mp": 2}


def serve_net(sym):
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=64, name="fc1")
    net = sym.Activation(net, act_type="relu")
    return sym.FullyConnected(net, num_hidden=8, name="fc2")


def serve_params():
    rs = np.random.RandomState(3)
    return {"fc1_weight": rs.uniform(-1, 1, (64, 16)).astype(np.float32),
            "fc1_bias": rs.uniform(-1, 1, (64,)).astype(np.float32),
            "fc2_weight": rs.uniform(-1, 1, (8, 64)).astype(np.float32),
            "fc2_bias": rs.uniform(-1, 1, (8,)).astype(np.float32)}


def serve_requests():
    rs = np.random.RandomState(4)
    return [rs.uniform(-1, 1, (n, 16)).astype(np.float32)
            for n in (1, 3, 8, 2, 6)]


def decode_cell():
    return AttentionDecodeCell(64, 32, 8, 8, 48)


def decode_prompts():
    rs = np.random.RandomState(5)
    return [rs.randint(0, 64, n).astype(np.int32) for n in (3, 5, 1, 7)]


def mlp(sym):
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=64, name="fc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=4, name="fc2")
    return sym.SoftmaxOutput(net, name="softmax")


MODULE_RULES = [(r"fc\d+_weight$", P("mp", None)), (r"fc\d+_bias$", P("mp"))]
MODULE_OPT = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}


def module_init():
    rs = np.random.RandomState(11)
    return {"fc1_weight": rs.uniform(-.3, .3, (64, 16)).astype(np.float32),
            "fc1_bias": np.zeros(64, np.float32),
            "fc2_weight": rs.uniform(-.3, .3, (4, 64)).astype(np.float32),
            "fc2_bias": np.zeros(4, np.float32)}


def module_batches(n=3, batch=32):
    rs = np.random.RandomState(7)
    return [(rs.uniform(-1, 1, (batch, 16)).astype(np.float32),
             rs.randint(0, 4, batch).astype(np.float32)) for _ in range(n)]


def train_module(mod, batches):
    """Bind, set ``module_init()``, SGD, one fused step a batch."""
    mod.bind(data_shapes=[DataDesc("data", (32, 16))],
             label_shapes=[DataDesc("softmax_label", (32,))])
    mod.init_params(arg_params={k: mt.nd.array(v, ctx=CPU)
                                for k, v in module_init().items()})
    mod.init_optimizer(kvstore="device", optimizer="sgd",
                       optimizer_params=MODULE_OPT)
    for x, y in batches:
        b = DataBatch(data=[mt.nd.array(x, ctx=CPU)],
                      label=[mt.nd.array(y, ctx=CPU)])
        assert mod._fused_batch_step(b), mod._fused_fallback_reason
    return mod


def main(out):
    torch.set_num_threads(1)
    rank = mt.dist.rank()
    assert mt.dist.process_count() == 4, mt.dist.process_count()

    def save(name, arrays):
        np.savez(os.path.join(out, "%s-r%d.npz" % (name, rank)), **arrays)
    params = {k: mt.nd.array(v, ctx=CPU) for k, v in serve_params().items()}
    for name, axes, buckets in SERVE_CASES:
        eng = InferenceEngine(serve_net(mt.sym), params, {"data": (8, 16)},
                              max_batch=8, buckets=buckets,
                              partition_rules=PartitionRules(SERVE_RULES),
                              mesh_axes=axes, contexts=[CPU])
        got = {"param_bytes": np.int64(sum(
            t.nbytes for m in eng._members for t in m["params"].values()))}
        if rank == 0:
            outs = [eng.predict(data=x)[0] for x in serve_requests()]
            got.update({"out%d" % i: o for i, o in enumerate(outs)})
        else:
            try:
                eng.submit(data=serve_requests()[0])
            except mt.MXNetError as e:
                got["follower_refused"] = np.array("rank 0" in str(e))
        eng.close()
        save(name, got)
    cell = decode_cell()
    got = {}
    for tag, rules in (("sharded", DECODE_PARTITION_RULES), ("repl", [])):
        eng = DecodeEngine(cell, cell.init_params(1), slots=4,
                           max_new_tokens=8, partition_rules=rules,
                           mesh_axes=DECODE_AXES, contexts=[CPU])
        got["kv_%s" % tag] = np.int64(eng.stats()["kv_cache_bytes"])
        if rank == 0:
            futs = [eng.submit(p) for p in decode_prompts()]
            for i, f in enumerate(futs):
                got["%s_tokens%d" % (tag, i)] = np.array(f.result().tokens)
        else:
            try:
                eng.generate(decode_prompts()[0])
            except mt.MXNetError as e:
                got["follower_refused"] = np.array("rank 0" in str(e))
        eng.close()
    save("decode_mp4", got)
    mod = train_module(mt.mod.Module(mlp(mt.sym), context=[CPU],
                                     partition_rules=MODULE_RULES,
                                     mesh_axes=MODULE_AXES),
                       module_batches())
    arg, _ = mod.get_params()
    got = {k: v.asnumpy() for k, v in arg.items()}
    got.update({"shard_" + k: mod._exec.arg_dict[k].asnumpy()
                for k in module_init()})
    save("module_dp2mp2", got)
    mt.dist.finalize()


if __name__ == "__main__":
    main(sys.argv[1])
