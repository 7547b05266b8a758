"""Continuous-batching decode in the PyTorch port, against the JAX package.

(a) Parity at the reference tests' sizes: ``init_params`` bit-equal
    between the packages; ``lstm_decode_step``, each cell's batched
    ``step`` (n != H != D) and one-slot ``prefill`` against the JAX
    cell's (``jax.vmap`` of its per-slot step) at rtol 1e-5 / atol 1e-6;
    the whole engine's tokens and logits against JAX's ``DecodeEngine``
    on the same weights (fp32: tokens equal, logits rtol 2e-5 /
    atol 2e-6; bf16: logits within 2e-2 of the largest |logit|, tokens
    equal up to the first position whose JAX top-2 margin is under that).
(b) The engine's behaviour within the port, mirroring
    ``tests/test_decode.py``: slot-batched against one-at-a-time decode,
    retire and re-admit, warmup, the cache's bytes, deadlines, queue
    overflow, a poisoned pool, the breaker, close, validation, EOS.

Slot-batched logits (bucket 4) against one-at-a-time (bucket 1), as
measured on the CPU: bit-equal in bf16; in fp32 up to ~1e-8 apart (the
projections' GEMMs change kernels with the row count), so fp32 is held
to 1e-6 of the largest |logit|, tokens exactly.
"""
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu.decode as jdec
from mxnet_tpu.rnn.rnn_cell import lstm_decode_step as j_lstm_step

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.decode import (DecodeEngine, AttentionDecodeCell,
                                    LSTMDecodeCell, DeadlineExceeded,
                                    QueueOverflow, CircuitOpen, EngineClosed)
from mxnet_tpu_torch.rnn.rnn_cell import lstm_decode_step

PROMPTS = ([3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7, 9, 3], [2, 7])
CPU = mt.cpu()
JAX_DTYPE = {"fp32": np.float32, "bf16": jnp.bfloat16}
PORT_DTYPE = {"fp32": np.float32, "bf16": "bfloat16"}
CASES = [("attn", "fp32"), ("attn", "bf16"), ("lstm", "fp32")]
CASE_IDS = ["attn-fp32", "attn-bf16", "lstm-fp32"]


def _prompts():
    return [np.array(p, np.int32) for p in PROMPTS]


def _cells(kind, dt="fp32"):
    """(JAX cell, port cell) at the reference tests' sizes."""
    if kind == "attn":
        args = dict(vocab=29, embed=16, heads=4, head_dim=8, max_len=48)
        return (jdec.AttentionDecodeCell(dtype=JAX_DTYPE[dt], **args),
                AttentionDecodeCell(dtype=PORT_DTYPE[dt], **args))
    args = dict(vocab=23, embed=8, hidden=16, max_len=32)
    return (jdec.LSTMDecodeCell(dtype=JAX_DTYPE[dt], **args),
            LSTMDecodeCell(dtype=PORT_DTYPE[dt], **args))


def _engine(cell, **kw):
    kw.setdefault("slots", 4)
    kw.setdefault("max_prompt_len", 16)
    kw.setdefault("max_new_tokens", 10)
    kw.setdefault("keep_logits", True)
    kw.setdefault("ctx", CPU)
    return DecodeEngine(cell, cell.init_params(1), **kw)


def _f32(a):
    """numpy float32 from a numpy array (any float type) or a tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


def _run_both_ways(eng, prompts, **kw):
    """One at a time (slot bucket 1), then all at once (bucket N)
    through the same engine and pool."""
    serial = [eng.generate(p, **kw) for p in prompts]
    futs = [eng.submit(p, **kw) for p in prompts]
    return serial, [f.result(timeout=120) for f in futs]


def _margin_cut(logits, tol):
    """First position whose top-2 logit margin is under ``tol`` (the
    sequence's length when there is none): from it on a rounding-level
    difference may pick the other token. Logits rows up to and including
    it depend only on the tokens before it."""
    top2 = np.sort(logits, axis=-1)[:, -2:]
    small = np.nonzero(top2[:, 1] - top2[:, 0] < tol)[0]
    return int(small[0]) if small.size else len(logits)


# -- (a) parity with the JAX package -----------------------------------------

@pytest.mark.parametrize("kind,dt", CASES, ids=CASE_IDS)
def test_init_params_bit_equal(kind, dt):
    jcell, tcell = _cells(kind, dt)
    want, got = jcell.init_params(1), tcell.init_params(1)
    assert list(got) == list(want)
    for name in want:
        assert tuple(got[name].shape) == want[name].shape, name
        assert np.array_equal(_f32(got[name]), _f32(want[name])), name
        if dt == "bf16":
            assert got[name].dtype == torch.bfloat16


def test_lstm_decode_step_matches_jax():
    rs = np.random.RandomState(0)
    x, h, c = (rs.normal(size=(3, n)).astype(np.float32)
               for n in (8, 16, 16))
    wx, wh = (rs.normal(size=s).astype(np.float32) * 0.3
              for s in ((8, 64), (16, 64)))
    b = rs.normal(size=64).astype(np.float32)
    want = j_lstm_step(*map(jnp.asarray, (x, h, c, wx, wh, b)))
    got = lstm_decode_step(*map(torch.from_numpy, (x, h, c, wx, wh, b)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def _random_state(cell, slots, seed):
    rs = np.random.RandomState(seed)
    return {n: rs.normal(size=s).astype(np.float32)
            for n, (s, _) in cell.cache_spec(slots).items()}


@pytest.mark.parametrize("kind", ["attn", "lstm"])
def test_batched_step_matches_jax_vmap(kind):
    """Three slots (n=3, H=4, D=8) at their own positions, one of them
    the cache's last: each row as the JAX cell's per-slot step."""
    jcell, tcell = _cells(kind)
    params = jcell.init_params(1)
    state = _random_state(jcell, 3, seed=2)
    toks = np.array([4, 17, 0], np.int32)
    pos = np.array([0, 5, jcell.max_len - 1], np.int32)
    jst, jlog = jax.vmap(jcell.step, in_axes=(None, 0, 0, 0))(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in state.items()},
        jnp.asarray(toks), jnp.asarray(pos))
    tp = mt.weights.tree_from_numpy(params, ctx=CPU)
    tst, tlog = tcell.step(tp, {k: torch.from_numpy(v.copy())
                                for k, v in state.items()},
                           torch.from_numpy(toks).long(),
                           torch.from_numpy(pos).long())
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-5,
                               atol=1e-6)
    for name in state:
        np.testing.assert_allclose(tst[name].numpy(), np.asarray(jst[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("kind", ["attn", "lstm"])
def test_prefill_matches_jax(kind):
    """One slot, a prompt of 5 padded to the bucket of 8, over a stale
    state from an earlier occupant."""
    jcell, tcell = _cells(kind)
    params = jcell.init_params(1)
    state = {k: v[0] for k, v in _random_state(jcell, 1, seed=3).items()}
    toks = np.array([3, 1, 4, 1, 5, 0, 0, 0], np.int32)
    jst, jlog = jcell.prefill({k: jnp.asarray(v) for k, v in params.items()},
                              {k: jnp.asarray(v) for k, v in state.items()},
                              jnp.asarray(toks), jnp.int32(5))
    tst, tlog = tcell.prefill(mt.weights.tree_from_numpy(params, ctx=CPU),
                              {k: torch.from_numpy(v.copy())
                               for k, v in state.items()},
                              torch.from_numpy(toks).long(), 5)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-5,
                               atol=1e-6)
    for name in state:
        np.testing.assert_allclose(tst[name].numpy(), np.asarray(jst[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("kind,dt", CASES, ids=CASE_IDS)
def test_engine_matches_jax_engine(kind, dt):
    """The four prompts one at a time, then all at once, through both
    packages' engines on the same weights."""
    jcell, tcell = _cells(kind, dt)
    kw = dict(slots=4, max_prompt_len=16, max_new_tokens=10,
              keep_logits=True)
    with jdec.DecodeEngine(jcell, jcell.init_params(1), **kw) as jeng:
        jser, jbat = _run_both_ways(jeng, _prompts())
        jkeys = set(jeng.stats())
    with _engine(tcell, **kw) as teng:
        tser, tbat = _run_both_ways(teng, _prompts())
        assert set(teng.stats()) == jkeys
    for want, got in zip(jser + jbat, tser + tbat):
        wl, gl = _f32(want.logits), got.logits
        assert gl.dtype == np.float32 and gl.shape == wl.shape
        if dt == "fp32":
            assert got.tokens == want.tokens
            np.testing.assert_allclose(gl, wl, rtol=2e-5, atol=2e-6)
        else:
            tol = 2e-2 * np.abs(wl).max()
            cut = _margin_cut(wl, tol)
            assert got.tokens[:cut] == want.tokens[:cut]
            np.testing.assert_allclose(gl[:cut + 1], wl[:cut + 1], rtol=0,
                                       atol=tol)


# -- (b) the engine within the port -------------------------------------------

@pytest.mark.parametrize("kind,dt", CASES, ids=CASE_IDS)
def test_slot_batched_matches_serial(kind, dt):
    """Continuous batching never changes the math: tokens exact across
    slot buckets; logits bit-equal in bf16, within 1e-6 of the largest
    |logit| in fp32 (measured ~1e-8)."""
    with _engine(_cells(kind, dt)[1]) as eng:
        serial, batched = _run_both_ways(eng, _prompts())
    for a, b in zip(serial, batched):
        assert a.tokens == b.tokens
        if dt == "bf16":
            assert np.array_equal(a.logits, b.logits)
        else:
            np.testing.assert_allclose(b.logits, a.logits, rtol=0,
                                       atol=1e-6 * np.abs(a.logits).max())


def test_retire_readmit_no_state_bleed():
    """A slot's cache is overwritten on re-admission: the same prompt
    decodes bit-identically before and after the slot hosted a different,
    longer sequence."""
    with _engine(_cells("attn")[1], slots=1, max_new_tokens=12) as eng:
        probe = np.array([2, 7], np.int32)
        first = eng.generate(probe)
        eng.generate(np.array([5, 3, 5, 8, 9, 7, 9, 3], np.int32),
                     max_new_tokens=16)
        again = eng.generate(probe)
    assert first.tokens == again.tokens
    assert np.array_equal(first.logits, again.logits)


class _Recorder:
    """A program proxy recording each call's (slot or ids, tokens)."""

    def __init__(self, real):
        self.real, self.calls = real, []

    def __call__(self, *a):
        self.calls.append((np.asarray(a[2]).copy(), np.asarray(a[3]).copy()))
        return self.real(*a)


@pytest.mark.parametrize("kind", ["attn", "lstm"])
def test_warmup_covers_every_bucket_and_writes_nothing(kind):
    eng = _engine(_cells(kind)[1], warmup=False)
    try:
        pre = eng._prefill_prog = _Recorder(eng._prefill_prog)
        dec = eng._decode_prog = _Recorder(eng._decode_prog)
        for leaf in eng._cache.values():      # a pool with live contents
            leaf.fill_(0.5)
        eng.warmup()
        assert [len(t) for _, t in pre.calls] == eng.prompt_buckets
        assert all(int(s) == eng.slots for s, _ in pre.calls)
        assert [len(ids) for ids, _ in dec.calls] == eng.slot_buckets
        assert all((ids == eng.slots).all() for ids, _ in dec.calls)
        assert all(bool((leaf == 0.5).all()) for leaf in eng._cache.values())
    finally:
        eng.close()
    with _engine(_cells(kind)[1]) as eng:     # warmup=True: still zero
        assert all(not leaf.any() for leaf in eng._cache.values())


def test_padding_lanes_write_nothing():
    """A bucket-4 step with two live lanes (slots 2 and 0) and two padding
    lanes: slots 1 and 3 stay byte-identical, the live slots change only
    at their own positions (``tests/test_torch_gpu.py`` repeats this on
    the card)."""
    with _engine(_cells("attn")[1]) as eng:
        g = torch.Generator().manual_seed(0)
        for leaf in eng._cache.values():
            leaf.copy_(torch.randn(leaf.shape, generator=g))
        before = {n: t.clone() for n, t in eng._cache.items()}
        eng._decode_prog(eng._params, eng._cache,
                         np.array([2, 0, 4, 4], np.int32),
                         np.array([5, 6, 0, 0], np.int32),
                         np.array([7, 30, 0, 0], np.int32))
        for n, t in eng._cache.items():
            for slot in (1, 3):
                assert torch.equal(t[slot], before[n][slot]), (n, slot)
            for slot, p in ((2, 7), (0, 30)):
                changed = (t[slot] != before[n][slot]).any(-1).any(0)
                assert changed.nonzero().flatten().tolist() == [p], (n, slot)


@pytest.mark.parametrize("kind,dt", CASES, ids=CASE_IDS)
def test_kv_cache_bytes(kind, dt):
    cell = _cells(kind, dt)[1]
    with _engine(cell, slots=4) as eng:
        st = eng.stats()
    expect = sum(int(np.prod(s)) * d.itemsize
                 for s, d in cell.cache_spec(4).values())
    assert st["kv_cache_bytes"] == eng.kv_cache_bytes() == expect
    assert st["kv_cache_bytes_per_slot"] == expect // 4
    assert all(leaf.dtype == cell.dtype for leaf in eng._cache.values())


def test_deadline_shed_at_slot_saturation():
    with _engine(_cells("attn")[1], slots=1, max_new_tokens=32) as eng:
        long_fut = eng.submit(_prompts()[2], max_new_tokens=30)
        doomed = eng.submit(_prompts()[0], max_new_tokens=2,
                            deadline_ms=1.0)
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=60)
        assert long_fut.result(timeout=120).tokens
        st = eng.stats()
    assert st["shed_by_cause"].get("slot_wait") == 1
    assert st["shed_requests"] == 1
    assert st["resolved"] == 1
    assert st["request_latency_ms"] is not None


def test_queue_overflow_sheds_at_admission():
    with _engine(_cells("attn")[1], slots=1, max_queue=1) as eng:
        running = eng.submit(_prompts()[2], max_new_tokens=30)
        deadline = time.monotonic() + 30
        while eng.overload_state()["active_slots"] < 1:
            assert time.monotonic() < deadline, "admission stalled"
            time.sleep(0.001)
        queued = eng.submit(_prompts()[0], max_new_tokens=2)
        with pytest.raises(QueueOverflow):
            eng.submit(_prompts()[1], max_new_tokens=2)
        assert running.result(timeout=120).tokens
        assert queued.result(timeout=120).tokens
        assert eng.stats()["shed_by_cause"].get("admission", 0) >= 1


def test_mid_decode_deadline_shed():
    """A slotted sequence past its deadline sheds at the step boundary
    and frees the slot; a delaying step proxy makes the timing
    deterministic."""
    with _engine(_cells("attn")[1], slots=2) as eng:
        real = eng._decode_prog

        def slow(*a):
            time.sleep(0.01)
            return real(*a)

        eng._decode_prog = slow
        fut = eng.submit(_prompts()[2], max_new_tokens=30,
                         deadline_ms=50.0)
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=60)
        eng._decode_prog = real
        st = eng.stats()
        assert st["shed_by_cause"].get("decode") == 1
        assert st["active_slots"] == 0
        assert eng.generate(_prompts()[0], max_new_tokens=2).tokens


@pytest.mark.parametrize("phase", ["decode", "prefill"])
def test_dispatch_failure_poisons_pool_and_recovers(phase):
    """A terminal dispatch failure fails every in-flight sequence,
    rebuilds a zeroed pool, and the engine keeps serving with
    bit-identical results."""
    attr = "_%s_prog" % phase
    with _engine(_cells("attn")[1], slots=2, retry_budget=0,
                 breaker_threshold=0) as eng:
        before = eng.generate(_prompts()[0], max_new_tokens=4)
        old_pool = eng._cache
        real = getattr(eng, attr)

        def boom(*a):
            raise ValueError("injected: backend fell over")

        setattr(eng, attr, boom)
        fut = eng.submit(_prompts()[1], max_new_tokens=4)
        with pytest.raises(MXNetError, match="poisoned"):
            fut.result(timeout=60)
        setattr(eng, attr, real)
        assert eng._cache is not old_pool
        after = eng.generate(_prompts()[0], max_new_tokens=4)
        st = eng.stats()
    assert before.tokens == after.tokens
    assert np.array_equal(before.logits, after.logits)
    assert st["failed_requests"] == 1
    assert st["dispatch_failures"] == 1


def test_transient_failures_retry_within_budget():
    with _engine(_cells("attn")[1], retry_budget=2,
                 retry_backoff_ms=0.1) as eng:
        real, fails = eng._decode_prog, [2]

        def flaky(*a):
            if fails[0]:
                fails[0] -= 1
                err = RuntimeError("transient")
                err.transient = True
                raise err
            return real(*a)

        eng._decode_prog = flaky
        want = eng.generate(_prompts()[0], max_new_tokens=4)
        st = eng.stats()
    assert len(want.tokens) == 4
    assert st["retries"] == 2 and st["dispatch_failures"] == 0


def test_breaker_trips_and_resets():
    with _engine(_cells("attn")[1], slots=1, retry_budget=0,
                 breaker_threshold=1, breaker_reset_s=3600.0) as eng:
        real = eng._decode_prog

        def boom(*a):
            raise ValueError("injected")

        eng._decode_prog = boom
        with pytest.raises(MXNetError):
            eng.generate(_prompts()[0], max_new_tokens=4)
        eng._decode_prog = real
        with pytest.raises(CircuitOpen):
            eng.submit(_prompts()[0])
        assert eng.stats()["breaker"]["open"]
        eng.reset_breaker()
        assert eng.generate(_prompts()[0], max_new_tokens=2).tokens


def test_close_drains_admitted_sequences():
    eng = _engine(_cells("attn")[1])
    futs = [eng.submit(p, max_new_tokens=6) for p in _prompts()]
    eng.close()
    for f in futs:
        assert len(f.result(timeout=1).tokens) == 6
    with pytest.raises(EngineClosed):
        eng.submit(_prompts()[0])
    with pytest.raises(EngineClosed):
        eng.warmup()
    eng.close()      # idempotent


def test_submit_validation():
    cell = _cells("attn")[1]
    with _engine(cell) as eng:
        with pytest.raises(MXNetError, match="max_prompt_len"):
            eng.submit(np.arange(17, dtype=np.int32))
        with pytest.raises(MXNetError, match="max_len"):
            eng.submit(_prompts()[0], max_new_tokens=48)
        with pytest.raises(MXNetError, match="non-empty"):
            eng.submit(np.zeros((0,), np.int32))
        for bad in (-1, cell.vocab):
            with pytest.raises(MXNetError, match="token ids"):
                eng.submit(np.array([1, bad], np.int32))
        with pytest.raises(MXNetError, match="max_new_tokens"):
            eng.submit(_prompts()[0], max_new_tokens=0)
    with pytest.raises(MXNetError, match="overload"):
        _engine(cell, overload="panic")
    with pytest.raises(MXNetError, match="max_prompt_len"):
        _engine(cell, max_prompt_len=64)


def test_eos_stops_generation():
    with _engine(_cells("attn")[1], max_new_tokens=12) as eng:
        free = eng.generate(_prompts()[1])
        assert len(free.tokens) == 12
        eos = free.tokens[3]
        stopped = eng.generate(_prompts()[1], eos_id=eos)
        assert stopped.tokens == free.tokens[:stopped.tokens.index(eos) + 1]
        assert stopped.tokens[-1] == eos
        st = eng.stats()
    assert st["token_latency_ms"] is not None
    assert st["steps"] > 0


def test_overload_state_keys():
    with _engine(_cells("attn")[1]) as eng:
        ov = eng.overload_state()
    assert {"queued_rows", "active_slots", "slots", "breaker_open",
            "closed"} <= set(ov)


def test_no_cuda_and_no_ctx_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cell = _cells("attn")[1]
    with pytest.raises(MXNetError, match="no CUDA device"):
        DecodeEngine(cell, cell.init_params(1), slots=2)


def test_mesh_of_more_than_one_device_raises():
    """Meshes of several Contexts run (``tests/test_torch_engine_mesh.py``).
    What still raises: axes that do not cover the Contexts, and a pool
    sharded other than by its heads (DECODE_PARTITION_RULES' layout)."""
    from mxnet_tpu_torch.parallel import P
    cell = _cells("attn")[1]
    two = [mt.cpu(0), mt.cpu(1)]
    with pytest.raises(MXNetError, match="need 4 devices"):
        DecodeEngine(cell, cell.init_params(1), slots=2, contexts=two,
                     mesh_axes={"dp": 2, "mp": 2})
    with pytest.raises(MXNetError, match="heads layout"):
        DecodeEngine(cell, cell.init_params(1), slots=2, contexts=two,
                     partition_rules=[(r"cache/(k|v)$",
                                       P(None, None, "mp", None))],
                     mesh_axes={"dp": 1, "mp": 2})
    with _engine(cell, partition_rules=[], contexts=[CPU]) as eng:
        assert eng.generate(_prompts()[3], max_new_tokens=2).tokens


def test_latency_percentiles_take_the_jax_rule():
    """Token and request latency percentiles by the nearest rank, rounded
    to 4 decimals, as the JAX package's telemetry (ROADMAP Queue 3,
    fault 5)."""
    from mxnet_tpu import telemetry
    samples = [0.5, 1.25, 0.75, 3.0, 0.9, 1.1, 2.2, 0.8, 1.33333]
    _, cell = _cells("attn")
    eng = _engine(cell)
    try:
        eng._tok_lat.extend(samples)
        eng._req_lat.extend(samples[:4])
        st = eng.stats()
    finally:
        eng.close()
    for key, vals in (("token_latency_ms", samples),
                      ("request_latency_ms", samples[:4])):
        s = sorted(vals)
        assert st[key] == {"p%d_ms" % q: round(telemetry._percentile(s, q),
                                               4) for q in (50, 95, 99)}
