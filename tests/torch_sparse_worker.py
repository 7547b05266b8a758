"""Worker of ``tests/test_torch_sparse_dist.py``: two of these run under
``python -m mxnet_tpu_torch.launch -n 2 --force-cpu`` (gloo on the CPU)
and write what they saw into the directory given as the first argument:
``results-r<rank>.json`` and ``arrays-r<rank>.npz``. Imports only the
port.

    python -m mxnet_tpu_torch.launch -n 2 --force-cpu -- \\
        python tests/torch_sparse_worker.py OUT_DIR

Cases (every worker runs each, in this order):
- ``union``: a ``dist_sync`` store without an optimizer; each rank pushes
  the row_sparse value of :func:`rank_rows` (rows both ranks touch, a row
  whose sum is exactly zero, a zero row only rank 1 pushes), then a key
  list of a dense value and that row_sparse value; saved: the stored
  values and the wire bytes of each push;
- ``pull``: ``row_sparse_pull`` of the union value and of a dense value;
- ``sgd``: a ``dist_sync`` store with SGD (momentum 0.9, wd 0.01) inside,
  each rank's initial weight its own (rank 0's must win), three pushes of
  :func:`step_rows`, then one of :func:`rank_rows` (its zero-sum and
  zero rows must reach the optimizer); saved: the weight after each
  push;
- ``csr``: a csr value through the store's exchange (summed dense, cast
  back to csr);
- ``discipline``: rank 0 pushes a row_sparse value, rank 1 a dense one
  for the same key: both raise.
"""
import json
import os
import sys

import numpy as np

import mxnet_tpu_torch as mt

CPU = mt.cpu()
SHAPE = (20, 3)


def rank_rows(rank):
    """``(rows, ids)`` rank ``rank`` pushes: rows 5 and 7 on both ranks,
    row 7's sum exactly zero, row 11 an explicit zero row on rank 1
    only."""
    rng = np.random.RandomState(10 + rank)
    if rank == 0:
        ids = [1, 5, 7]
    else:
        ids = [5, 9, 7, 11]
    rows = rng.randn(len(ids), SHAPE[1]).astype(np.float32)
    if rank == 1:
        rows[2] = -rank_rows(0)[0][2]
        rows[3] = 0.0
    return rows, ids


def dense_value(rank):
    return np.random.RandomState(20 + rank).randn(4, 2).astype(np.float32)


def step_rows(rank, step):
    rng = np.random.RandomState(100 * step + rank)
    ids = np.sort(rng.choice(SHAPE[0], 4 + rank, replace=False))
    return rng.randn(len(ids), SHAPE[1]).astype(np.float32), ids


def start_weight(rank):
    return np.random.RandomState(30 + rank).randn(*SHAPE).astype(np.float32)


def csr_value(rank):
    d = np.random.RandomState(40 + rank).randn(5, 4).astype(np.float32)
    d[np.random.RandomState(50 + rank).rand(5, 4) < 0.6] = 0
    return d


def _rsp(rows, ids):
    return mt.nd.sparse.row_sparse_array((rows, ids), shape=SHAPE, ctx=CPU)


def main(out):
    rank = mt.dist.rank()
    res, arr = {}, {}

    kv = mt.kv.create("dist_sync")
    kv.init("emb", mt.nd.zeros(SHAPE, ctx=CPU))
    kv.init("d", mt.nd.zeros((4, 2), ctx=CPU))
    kv.push("emb", _rsp(*rank_rows(rank)))
    stored = kv._store["emb"]
    res["union"] = {"stype": stored.stype,
                    "wire": kv.wire_bytes_last_push,
                    "wire_raw": kv.wire_bytes_last_push_raw}
    arr["union/indices"] = stored.indices.asnumpy()
    arr["union/data"] = stored.data.asnumpy()
    kv.push(["d", "emb"], [mt.nd.array(dense_value(rank), ctx=CPU),
                           _rsp(*rank_rows(rank))])
    res["union"]["list_wire"] = kv.wire_bytes_last_push
    arr["union/list_d"] = kv._store["d"].asnumpy()
    arr["union/list_emb_indices"] = kv._store["emb"].indices.asnumpy()
    arr["union/list_emb_data"] = kv._store["emb"].data.asnumpy()

    ids = mt.nd.array([11, 7, 1, 3], ctx=CPU)
    got = mt.nd.sparse.zeros("row_sparse", SHAPE, ctx=CPU)
    kv.row_sparse_pull("emb", out=got, row_ids=ids)
    arr["pull/rsp_indices"] = got.indices.asnumpy()
    arr["pull/rsp_data"] = got.data.asnumpy()
    dense_out = mt.nd.zeros((4, 2), ctx=CPU)
    kv.row_sparse_pull("d", out=dense_out, row_ids=mt.nd.array([0, 2],
                                                               ctx=CPU))
    arr["pull/dense"] = dense_out.asnumpy()

    kv = mt.kv.create("dist_sync")
    kv.init(3, mt.nd.array(start_weight(rank), ctx=CPU))
    kv.set_optimizer(mt.optimizer.create("sgd", learning_rate=0.1,
                                         momentum=0.9, wd=0.01))
    wires = []
    for step in range(4):
        g = _rsp(*(step_rows(rank, step) if step < 3 else rank_rows(rank)))
        kv.push(3, g)
        wires.append(kv.wire_bytes_last_push)
        arr["sgd/w%d" % step] = kv._store[3].asnumpy()
    res["sgd"] = {"wire": wires}

    kv = mt.kv.create("dist_sync")
    c = mt.nd.sparse.csr_matrix(csr_value(rank), ctx=CPU)
    (summed,) = kv._global_reduce_batch(["c"], [c])
    res["csr"] = {"stype": summed.stype, "wire": kv.wire_bytes_last_push}
    arr["csr/dense"] = summed.asnumpy()
    arr["csr/indptr"] = summed.indptr.asnumpy()

    kv = mt.kv.create("dist_sync")
    kv.init("m", mt.nd.zeros(SHAPE, ctx=CPU))
    value = _rsp(*rank_rows(0)) if rank == 0 \
        else mt.nd.zeros(SHAPE, ctx=CPU)
    try:
        kv.push("m", value)
        res["discipline"] = "pushed"
    except mt.MXNetError as e:
        res["discipline"] = str(e)
    kv.barrier()

    np.savez(os.path.join(out, "arrays-r%d.npz" % rank), **arr)
    with open(os.path.join(out, "results-r%d.json" % rank), "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1])
