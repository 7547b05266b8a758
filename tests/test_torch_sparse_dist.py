"""Row-sparse pushes and pulls across worker processes: the port's
``dist_sync`` store over gloo on the CPU, two workers of
``tests/torch_sparse_worker.py`` launched once per module
(``python -m mxnet_tpu_torch.launch -n 2 --force-cpu``, a 60 s hard
timeout), against the JAX package's ``device`` store in this process
pushing both workers' values as one list (its ``add_n``).

- the union of the rows any worker pushed, summed: ids exact, values
  within 1e-6 (relative, atol 1e-7), a row whose sum is exactly zero and
  a zero row one worker pushed both kept;
- ``wire_bytes_last_push``: per row_sparse value the padded bucket
  (``max(8, next power of two of the largest count)``) of int32 ids and
  rows, plus a dense value's bytes (``mxnet_tpu/kvstore.py:392-437``);
- ``row_sparse_pull`` of a row_sparse and of a dense value;
- SGD inside the store (momentum, wd) over four pushes: ranks
  bit-equal, rank 0's start, within 1e-6 of the JAX store, untouched
  rows bit-unchanged and the zero-sum rows updated;
- a csr value summed dense and cast back to csr (indptr exact);
- a push whose storage types differ across workers raises the
  discipline error on both.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.ndarray import sparse as jsp

import torch_sparse_worker as W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
RTOL, ATOL = 1e-6, 1e-7


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("sparse_dist")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", str(WORLD),
         "--force-cpu", "--timeout", "60", "--", sys.executable,
         os.path.join(ROOT, "tests", "torch_sparse_worker.py"), str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=75)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-6000:]
    results, arrays = [], []
    for r in range(WORLD):
        with open(out / ("results-r%d.json" % r)) as f:
            results.append(json.load(f))
        arrays.append(dict(np.load(out / ("arrays-r%d.npz" % r))))
    return results, arrays


def _bucket(n):
    return max(8, 1 << (max(int(n), 1) - 1).bit_length())


def _rsp_wire(counts, width, itemsize=4):
    b = _bucket(max(counts))
    return b * 4 + b * width * itemsize


def _jax_sum(values):
    kv = mx.kv.create("device")
    kv.init("emb", mx.nd.zeros(W.SHAPE))
    kv.push("emb", [jsp.row_sparse_array(v, shape=W.SHAPE) for v in values])
    return kv._store["emb"]


def _ranks_equal(arrays, prefix):
    for k in arrays[0]:
        if k.startswith(prefix):
            np.testing.assert_array_equal(arrays[0][k], arrays[1][k],
                                          err_msg=k)


def test_union_sum_keeps_zero_sum_rows(run):
    results, arrays = run
    _ranks_equal(arrays, "union/")
    want = _jax_sum([W.rank_rows(r) for r in range(WORLD)])
    for a in arrays:
        for pre in ("union/", "union/list_emb_"):
            np.testing.assert_array_equal(a[pre + "indices"],
                                          want.indices.asnumpy())
            assert a[pre + "indices"].dtype == np.int32
            np.testing.assert_allclose(a[pre + "data"],
                                       want.data.asnumpy(), rtol=RTOL,
                                       atol=ATOL)
        assert {7, 11} <= set(a["union/indices"].tolist())
        row7 = list(a["union/indices"]).index(7)
        np.testing.assert_array_equal(a["union/data"][row7], 0.0)
        np.testing.assert_allclose(
            a["union/list_d"], W.dense_value(0) + W.dense_value(1),
            rtol=RTOL, atol=ATOL)
    for res in results:
        assert res["union"]["stype"] == "row_sparse"


def test_wire_bytes_follow_the_formula(run):
    results, _ = run
    counts = [len(W.rank_rows(r)[1]) for r in range(WORLD)]
    rsp = _rsp_wire(counts, W.SHAPE[1])
    for res in results:
        assert res["union"]["wire"] == res["union"]["wire_raw"] == rsp
        assert res["union"]["list_wire"] == rsp + 4 * 2 * 4
        steps = [[len(W.step_rows(r, s)[1]) for r in range(WORLD)]
                 for s in range(3)] + [counts]
        assert res["sgd"]["wire"] == [_rsp_wire(c, W.SHAPE[1])
                                      for c in steps]
        assert all(w < 20 * 3 * 4 * 2 for w in res["sgd"]["wire"])
        assert res["csr"]["wire"] == 5 * 4 * 4


def test_row_sparse_pull_across_workers(run):
    _, arrays = run
    _ranks_equal(arrays, "pull/")
    kv = mx.kv.create("device")
    kv.init("emb", mx.nd.zeros(W.SHAPE))
    kv.push("emb", [jsp.row_sparse_array(W.rank_rows(r), shape=W.SHAPE)
                    for r in range(WORLD)])
    kv.init("d", mx.nd.array(W.dense_value(0) + W.dense_value(1)))
    got = jsp.zeros("row_sparse", W.SHAPE)
    kv.row_sparse_pull("emb", out=got, row_ids=mx.nd.array([11, 7, 1, 3]))
    dense = mx.nd.zeros((4, 2))
    kv.row_sparse_pull("d", out=dense, row_ids=mx.nd.array([0, 2]))
    for a in arrays:
        np.testing.assert_array_equal(a["pull/rsp_indices"],
                                      got.indices.asnumpy())
        np.testing.assert_allclose(a["pull/rsp_data"], got.data.asnumpy(),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(a["pull/dense"], dense.asnumpy(),
                                   rtol=RTOL, atol=ATOL)


def test_lazy_sgd_in_the_dist_store(run):
    _, arrays = run
    _ranks_equal(arrays, "sgd/")
    kv = mx.kv.create("device")
    kv.init(3, mx.nd.array(W.start_weight(0)))
    kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1,
                                         momentum=0.9, wd=0.01))
    before = W.start_weight(0)
    touched = set()
    for step in range(4):
        vals = [W.step_rows(r, step) if step < 3 else W.rank_rows(r)
                for r in range(WORLD)]
        kv.push(3, [jsp.row_sparse_array(v, shape=W.SHAPE) for v in vals])
        want = kv._store[3].asnumpy()
        got = arrays[0]["sgd/w%d" % step]
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        touched |= {int(i) for _, ids in vals for i in ids}
        untouched = sorted(set(range(W.SHAPE[0])) - touched)
        np.testing.assert_array_equal(got[untouched],
                                      W.start_weight(0)[untouched])
        if step == 3:
            # rows 7 (a zero sum) and 11 (a zero row of one worker)
            # reached the optimizer: momentum and wd moved them
            assert not np.array_equal(got[[7, 11]], before[[7, 11]])
        before = got


def test_csr_value_summed_dense(run):
    results, arrays = run
    _ranks_equal(arrays, "csr/")
    want = jsp.cast_storage(mx.nd.array(W.csr_value(0) + W.csr_value(1)),
                            "csr")
    for res, a in zip(results, arrays):
        assert res["csr"]["stype"] == "csr"
        np.testing.assert_array_equal(a["csr/indptr"], want.indptr.asnumpy())
        np.testing.assert_allclose(a["csr/dense"], want.asnumpy(),
                                   rtol=RTOL, atol=ATOL)


def test_storage_type_mismatch_breaks_discipline(run):
    results, _ = run
    for res in results:
        assert "push discipline violated" in res["discipline"]
        assert "row_sparse" in res["discipline"] \
            or "default" in res["discipline"]
