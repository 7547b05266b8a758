"""The port's fault-injection registry (``mxnet_tpu_torch/faults.py``)
against the JAX package's (``mxnet_tpu/faults.py``): the spec grammar
and its errors, the deterministic schedules (200 ``fire`` calls give the
same sequence in both packages), exact counts in the registry and in
telemetry, and the sites wired on the port's paths (``dispatch``,
``io_next``, ``kv_push``; ``d2h`` is in ``test_torch_observability.py``).

Not ported, with the ROADMAP item that brings it:
``test_compile_cache_load_site_degrades_to_reject`` (the executable
store, Queue 1 item 6) — the ``compile_cache.load`` site parses here
but has no call site; ``kv_collective`` and ``heartbeat`` likewise wait
for the distributed slice (item 4).
"""
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import faults as jfaults, telemetry as jtelemetry
from mxnet_tpu.base import MXNetError as JMXNetError

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401
from mxnet_tpu_torch import faults, telemetry
from mxnet_tpu_torch.base import MXNetError

CPU = mt.cpu()


@pytest.fixture(autouse=True)
def _clean_registry():
    for f in (faults, jfaults):
        f.clear()
    yield
    for f in (faults, jfaults):
        f.clear()


def _outcomes(mod, site, n=200):
    """What ``fire`` did on each of ``n`` calls: "raise", "nan" or None."""
    out = []
    for _ in range(n):
        try:
            out.append(mod.fire(site))
        except mod.InjectedFault:
            out.append("raise")
    return out


# ---------------------------------------------------------------------------
# Spec grammar
# ---------------------------------------------------------------------------

def test_sites_are_the_jax_packages():
    assert faults.SITES == jfaults.SITES


def test_parse_basic_rules():
    spec = "dispatch:raise:n=3;d2h:nan:every=2;io_next:delay=50:first=4"
    for mod in (faults, jfaults):
        rules = mod.parse_spec(spec)
        assert [r.site for r in rules] == ["dispatch", "d2h", "io_next"]
        assert rules[0].action == "raise" and rules[0].n == 3
        assert rules[1].action == "nan" and rules[1].every == 2
        assert rules[2].action == "delay" and rules[2].delay_ms == 50.0 \
            and rules[2].first == 4


def test_parse_probability_with_seed():
    (r,) = faults.parse_spec("kv_push:raise:p=0.25,seed=9")
    assert r.p == 0.25 and r.seed == 9


@pytest.mark.parametrize("bad", [
    "nosuchsite:raise",                 # unknown site
    "dispatch:explode",                 # unknown action
    "dispatch:raise:n=3:extra",         # too many fields
    "dispatch:raise:n=0",               # n < 1
    "dispatch:raise:p=1.5",             # p out of range
    "dispatch:raise:n=2,every=3",       # exclusive schedules
    "dispatch:delay=abc",               # bad delay
    "dispatch:raise:zz=1",              # unknown schedule term
])
def test_bad_specs_raise_the_same_message(bad):
    with pytest.raises(MXNetError) as got:
        faults.parse_spec(bad)
    with pytest.raises(JMXNetError) as want:
        jfaults.parse_spec(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", [
    "compile_cache.load:raise", "kv_collective:delay=5:n=2",
    "heartbeat:raise:every=3"])
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_unported_sites_parse(spec, tmp_path):
    """Every site parses alike in both packages, so a spec that parses in
    one parses in the other. ``kv_collective`` (each gate crossing) and
    ``heartbeat`` (each beat) are wired now: they fire in the port at the
    same calls as in the JAX package; ``compile_cache.load`` has no
    counterpart and only parses."""
    assert [r.site for r in faults.parse_spec(spec)] == \
        [r.site for r in jfaults.parse_spec(spec)]
    site = spec.split(":")[0]
    if site == "compile_cache.load":
        return
    from mxnet_tpu import heartbeat as jheartbeat
    from mxnet_tpu_torch import heartbeat
    got = {}
    for name, pkg, hb in (("jax", jfaults, jheartbeat),
                          ("torch", faults, heartbeat)):
        pkg.configure(spec)
        try:
            if site == "kv_collective":
                gate = hb.CollectiveGate(0, (0,), root=str(tmp_path))
                for _ in range(3):
                    gate.arrive_and_wait()
            else:       # the third beat raises and kills the beat thread
                hb.start_heartbeat(0, root=str(tmp_path / name),
                                   interval=0.01)
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline and not pkg.counts().get(
                        "heartbeat", {}).get("fired"):
                    time.sleep(0.01)
                time.sleep(0.1)
            got[name] = pkg.counts()[site]
        finally:
            pkg.clear()
            hb.stop_heartbeat()
    assert got["torch"] == got["jax"] == {"calls": 3, "fired": 1}


def test_invalid_env_spec_is_ignored_not_fatal(monkeypatch):
    monkeypatch.setenv(faults.ENV, "dispatch:bogus")
    faults._loaded = False
    assert faults.active() is False
    assert faults.fire("dispatch") is None


def test_env_spec_loads_lazily(monkeypatch):
    monkeypatch.setenv(faults.ENV, "io_next:raise:n=1")
    faults._loaded = False
    assert faults.active() is True
    assert faults.spec() == "io_next:raise:n=1"


# ---------------------------------------------------------------------------
# Schedules: the same 200-call sequence in both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "dispatch:raise:n=3",
    "dispatch:raise:every=7",
    "d2h:nan:first=5",
    "d2h:nan:every=3",
    "io_next:raise:p=0.3,seed=7",
    "kv_push:nan:p=0.5,seed=0",
    "dispatch:raise:p=0.05,seed=123",
    "dispatch:raise:n=2;dispatch:nan:every=4",
    "d2h:raise",
])
def test_schedules_match_the_jax_package(spec):
    site = spec.split(":")[0]
    faults.configure(spec)
    jfaults.configure(spec)
    got = _outcomes(faults, site)
    assert got == _outcomes(jfaults, site)
    assert faults.counts() == jfaults.counts()
    # a rewound window replays the same schedule in both
    faults.reset_counts()
    jfaults.reset_counts()
    assert _outcomes(faults, site) == got == _outcomes(jfaults, site)


def test_nth_call_schedule_exact():
    faults.configure("dispatch:raise:n=3")
    fired = [i for i, o in enumerate(_outcomes(faults, "dispatch", 5), 1)
             if o == "raise"]
    assert fired == [3]
    assert faults.counts() == {"dispatch": {"calls": 5, "fired": 1}}


def test_first_schedule_exact():
    faults.configure("d2h:nan:first=2")
    assert [faults.fire("d2h") for _ in range(5)] == \
        ["nan", "nan", None, None, None]


def test_probability_schedule_is_deterministic():
    faults.configure("dispatch:raise:p=0.5,seed=42")
    seq1 = _outcomes(faults, "dispatch", 20)
    faults.reset_counts()
    seq2 = _outcomes(faults, "dispatch", 20)
    assert seq1 == seq2
    assert 0 < seq1.count("raise") < 20
    assert faults.counts()["dispatch"]["fired"] == seq2.count("raise")


def test_delay_action_sleeps():
    faults.configure("io_next:delay=30")
    t0 = time.perf_counter()
    assert faults.fire("io_next") is None
    assert time.perf_counter() - t0 >= 0.025


def test_injections_counted_in_telemetry_as_in_jax():
    for t in (telemetry, jtelemetry):
        t.enable()
        t.reset()
    spec = "dispatch:raise:first=2;dispatch:delay=1:n=3"
    for f in (faults, jfaults):
        f.configure(spec)
        _outcomes(f, "dispatch", 4)
    c, jc = telemetry.counters(), jtelemetry.counters()
    assert c == jc
    assert c["faults.injected.dispatch"] == 3 == c["faults.injected"]
    strip = [(e["kind"], e["data"]) for e in telemetry.events()]
    assert strip == [(e["kind"], e["data"]) for e in jtelemetry.events()]
    for t in (telemetry, jtelemetry):
        t.reset()


def test_raise_rule_does_not_short_circuit_sibling_counts():
    telemetry.enable()
    base = telemetry.counters().get("faults.injected.dispatch", 0)
    faults.configure("dispatch:raise:n=1;dispatch:delay=1")
    with pytest.raises(faults.InjectedFault):
        faults.fire("dispatch")
    assert faults.counts()["dispatch"]["fired"] == 2
    assert telemetry.counters().get("faults.injected.dispatch", 0) \
        - base == 2
    assert faults.fire("dispatch") is None
    assert faults.counts()["dispatch"]["fired"] == 3
    assert telemetry.counters().get("faults.injected.dispatch", 0) \
        - base == 3


def test_injected_fault_is_transient_mxnet_error():
    err = faults.InjectedFault("dispatch")
    assert isinstance(err, MXNetError)
    assert err.transient is True and err.site == "dispatch"
    assert str(err) == str(jfaults.InjectedFault("dispatch"))


def test_poison_numpy_as_in_jax_and_fills_tensors():
    f = np.ones((2, 3), np.float32)
    i = np.ones((2,), np.int32)
    ro = np.ones((2,), np.float32)
    ro.setflags(write=False)
    out = faults.poison([f, i, ro])
    want = jfaults.poison([np.ones((2, 3), np.float32),
                           np.ones((2,), np.int32), ro])
    for a, b in zip(out, want):
        np.testing.assert_array_equal(a, b)
    assert np.isnan(out[0].reshape(-1)[0]) and not np.isnan(out[0]).all()
    assert (out[1] == 1).all()
    assert not np.isnan(ro.reshape(-1)[0])    # original untouched
    # a device payload (a launch's outputs) is filled in place
    t = torch.ones(3, 4)
    it = torch.ones(3, dtype=torch.int64)
    res = faults.poison([t, it])
    assert res[0] is t and torch.isnan(t).all()
    assert (it == 1).all()


# ---------------------------------------------------------------------------
# Wired sites
# ---------------------------------------------------------------------------

def _mlp(m):
    data = m.sym.Variable("data")
    net = m.sym.FullyConnected(data, num_hidden=8, name="fc1")
    return m.sym.SoftmaxOutput(net, name="softmax")


def test_dispatch_site_fires_in_executor():
    ex = _mlp(mt).simple_bind(ctx=CPU, data=(2, 4))
    ex.forward(is_train=False)
    faults.configure("dispatch:raise:n=1")
    with pytest.raises(faults.InjectedFault):
        ex.forward(is_train=False)
    faults.clear()
    assert np.isfinite(ex.forward(is_train=False)[0].asnumpy()).all()


@pytest.mark.parametrize("entry", ["forward", "forward_train", "fwd_bwd"])
def test_dispatch_site_counts_one_call_per_launch(entry):
    """Each executor entry point consults the ``dispatch`` site exactly
    once per launch, in both packages."""
    rs = np.random.RandomState(0)
    x = rs.normal(size=(2, 4)).astype(np.float32)
    got = {}
    for m, f in ((mt, faults), (mx, jfaults)):
        ex = _mlp(m).simple_bind(ctx=m.cpu(), data=(2, 4))
        ex.arg_dict["data"][:] = x
        f.configure("dispatch:delay=0")
        for _ in range(3):
            if entry == "forward":
                ex.forward(is_train=False)
            elif entry == "forward_train":
                ex.forward(is_train=True)
            else:
                ex.forward_backward()
        got[m] = f.counts()["dispatch"]["calls"]
    assert got[mt] == got[mx] == 3


def test_dispatch_nan_fills_the_launch_outputs():
    """``dispatch:nan`` poisons what the launch returns (the JAX package
    ignores ``nan`` at this site — ROADMAP Queue 3)."""
    ex = _mlp(mt).simple_bind(ctx=CPU, data=(2, 4))
    faults.configure("dispatch:nan:n=2")
    assert np.isfinite(ex.forward(is_train=False)[0].asnumpy()).all()
    assert np.isnan(ex.forward(is_train=False)[0].asnumpy()).all()
    assert np.isfinite(ex.forward(is_train=False)[0].asnumpy()).all()


def test_io_next_site_raises_and_poisons_as_in_jax():
    X = np.random.RandomState(0).normal(size=(8, 4)).astype(np.float32)
    got = {}
    for m, f in ((mt, faults), (mx, jfaults)):
        it = m.io.NDArrayIter(X, None, batch_size=4)
        f.configure("io_next:raise:n=1")
        it.reset()
        with pytest.raises(f.InjectedFault):
            next(iter(it))
        f.configure("io_next:nan:n=1")
        it.reset()
        got[m] = next(iter(it)).data[0].asnumpy()
    assert np.isnan(got[mt].reshape(-1)[0])
    np.testing.assert_array_equal(got[mt], got[mx])


def test_io_next_span_recorded_and_epoch_end_cancelled():
    telemetry.enable()
    telemetry.reset()
    X = np.zeros((8, 4), np.float32)
    it = mt.io.NDArrayIter(X, None, batch_size=4)
    assert len(list(it)) == 2
    assert telemetry.span_count("io_next") == 2   # StopIteration cancelled
    telemetry.reset()


def test_kv_push_site():
    got = {}
    for m, f in ((mt, faults), (mx, jfaults)):
        kv = m.kv.create("local")
        kv.init(0, m.nd.ones((4,), ctx=m.cpu()))
        f.configure("kv_push:raise:n=1")
        with pytest.raises(f.InjectedFault):
            kv.push(0, m.nd.ones((4,), ctx=m.cpu()))
        kv.push(0, m.nd.ones((4,), ctx=m.cpu()))
        f.configure("kv_push:nan:n=1")
        kv.push(0, m.nd.ones((4,), ctx=m.cpu()))
        out = m.nd.zeros((4,), ctx=m.cpu())
        kv.pull(0, out=out)
        got[m] = out.asnumpy()
    assert np.isnan(got[mt][0]) and np.isfinite(got[mt][1:]).all()
    np.testing.assert_array_equal(got[mt], got[mx])
