"""The port's partition-rule engine against the JAX package's
(``mxnet_tpu/parallel/partition.py``; the counterpart of
``tests/test_partition.py``'s rule-tree and summary cases): the same
rules and shapes resolve to the same specs, the unmatched policies,
rejected rules, ``apply``, hashing, the downgrade counter and its one
warning, per-shard ``spec_nbytes``, ``partition_summary`` equal to the
JAX package's JSON for the same mesh axes, and the ``PARTITION_RULES``
of ``moe``, ``pipeline``, ``ulysses`` and ``ring_attention``.
"""
import importlib
import json
import logging

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as JP

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.parallel import partition as jpart
from mxnet_tpu.parallel import moe as jmoe, pipeline as jpipe
from mxnet_tpu.parallel import ulysses as jul

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.parallel import partition as tpart
from mxnet_tpu_torch.parallel import moe as tmoe, pipeline as tpipe
from mxnet_tpu_torch.parallel import ulysses as tul

# the packages bind ``ring_attention`` to the function; the modules:
jring = importlib.import_module("mxnet_tpu.parallel.ring_attention")
tring = importlib.import_module("mxnet_tpu_torch.parallel.ring_attention")

AXES = {"dp": 2, "mp": 4}

RULE_SETS = {
    "fc": [(r"fc\d+_weight$", ("mp", None)), (r"fc\d+_bias$", ("mp",))],
    "first_wins": [(r"weight", ("mp", None)), (r"fc1_weight", (None, "mp")),
                   (r".*", ())],
    "flipped": [(r"fc1_weight", (None, "mp")), (r"weight", ("mp", None))],
    "catch_all": [(r".*", ("mp",))],
    "two_axes": [(r"w$", (("dp", "mp"), None)), (r"b$", "dp")],
}

SHAPES = {"fc1_weight": (8, 8), "fc2_bias": (4,), "gamma": (), "beta": (1,),
          "w": (8, 4), "b": (6,), "odd": (6,), "stray": (8,)}


def _both(rules, **kw):
    return (jpart.PartitionRules([(p, JP(*s) if isinstance(s, tuple)
                                   else s) for p, s in rules], **kw),
            tpart.PartitionRules([(p, tpar.P(*s) if isinstance(s, tuple)
                                   else s) for p, s in rules], **kw))


@pytest.mark.parametrize("name", sorted(RULE_SETS))
def test_specs_match_jax(name):
    """First match wins, scalars and one-element leaves never shard,
    unmatched names replicate; ``apply`` over arrays and shapes."""
    jr, tr = _both(RULE_SETS[name])
    for pname, shape in SHAPES.items():
        assert tuple(tr.spec_for(pname, shape)) == \
            tuple(jr.spec_for(pname, shape)), (name, pname)
    tree = {k: (np.zeros(s) if len(s) == 2 else s) for k, s in SHAPES.items()}
    assert {k: tuple(v) for k, v in tr.apply(tree).items()} == \
        {k: tuple(v) for k, v in jr.apply(tree).items()}
    assert json.dumps(tr.describe()) == json.dumps(jr.describe())


def test_unmatched_error_and_bad_rules_rejected():
    jr, tr = _both([(r"weight$", ("mp",))], unmatched="error")
    assert tuple(tr.spec_for("a_weight", (8,))) == ("mp",)
    for r, err in ((jr, jmx.base.MXNetError), (tr, mt.MXNetError)):
        with pytest.raises(err, match="no rule matches"):
            r.spec_for("stray_bias", (8,))
    for mod, err in ((jpart, jmx.base.MXNetError), (tpart, mt.MXNetError)):
        with pytest.raises(err, match="unmatched policy"):
            mod.PartitionRules([], unmatched="ignore")
        with pytest.raises(err, match="pattern, spec"):
            mod.PartitionRules(["not-a-pair"])
    with pytest.raises(mt.MXNetError, match="PartitionSpec"):
        tpart.PartitionRules([(r"x", 3)])


def test_hash_eq_and_prepended():
    a, b = (tpart.PartitionRules([(r"w$", tpar.P("mp"))]) for _ in range(2))
    c = tpart.PartitionRules([(r"w$", tpar.P("mp"))], unmatched="error")
    assert a == b and hash(a) == hash(b) and a != c
    d = a.prepended([(r"cache", tpar.P(None, "mp"))])
    jd = jpart.PartitionRules([(r"w$", JP("mp"))]).prepended(
        [(r"cache", JP(None, "mp"))])
    assert json.dumps(d.describe()) == json.dumps(jd.describe())
    assert tuple(d.spec_for("cache_w", (4, 4))) == (None, "mp")
    assert d.unmatched == a.unmatched


def _jmesh():
    return jpar.mesh_from_contexts([jmx.cpu(i) for i in range(8)], axes=AXES)


def _tmesh():
    return tpar.mesh_from_contexts([mt.cpu(i) for i in range(8)], axes=AXES)


@pytest.mark.parametrize("spec,shape", [
    (("mp",), (6,)),                 # 6 % 4: downgrade
    (("tp",), (8,)),                 # no such axis: downgrade
    (("mp", None, None), (8, 8)),    # longer than the rank: downgrade
    (("mp", None), (8, 4)),
    ((("dp", "mp"), None), (16, 4)),
    ((("dp", "mp"), None), (12, 4)),  # 12 % 8: downgrade
    ((None, "dp"), (3, 4)),
])
def test_downgrade_placement_and_spec_nbytes_match_jax(spec, shape, caplog):
    """``sharding_for`` places (or downgrades) as the JAX package does,
    counts each downgrade in ``partition.replicated_fallback`` and warns
    once per parameter and cause; ``spec_nbytes`` gives the same
    per-shard bytes as for the JAX package's ``NamedSharding``."""
    jm, tm = _jmesh(), _tmesh()
    name = "p_%s_%s" % ("_".join(map(str, spec)), "x".join(map(str, shape)))
    was = mt.telemetry.enabled()
    mt.telemetry.enable()
    try:
        mt.telemetry.reset()
        with caplog.at_level(logging.WARNING):
            got = tpart.sharding_for(tm, name, shape, tpar.P(*spec))
            again = tpart.sharding_for(tm, name, shape, tpar.P(*spec))
        want = jpart.sharding_for(jm, name, shape, JP(*spec))
        assert tuple(got.spec) == tuple(want.spec) == tuple(again.spec)
        downgraded = tuple(want.spec) == () and spec != ()
        fallbacks = mt.telemetry.counters().get(
            "partition.replicated_fallback", 0)
        assert fallbacks == (2 if downgraded else 0)
        warned = [r for r in caplog.records if name in r.getMessage()
                  and r.name.startswith("mxnet_tpu_torch")]
        assert len(warned) == (1 if downgraded else 0)
    finally:
        if not was:
            mt.telemetry.disable()
    nbytes = int(np.prod(shape)) * 4
    assert tpart.spec_nbytes(nbytes, shape, got) == \
        jpart.spec_nbytes(nbytes, shape, want)
    assert got.shard_shape(shape) == want.shard_shape(shape)
    t = torch.zeros(shape)
    assert tpart.committed_nbytes(t, got) == jpart.committed_nbytes(
        jax.device_put(np.zeros(shape, np.float32), want))


def test_partition_summary_matches_jax():
    rules = [(r"fc\d+_weight$", ("mp", None)), (r"fc\d+_bias$", ("mp",))]
    jr, tr = _both(rules)
    shapes = {"fc1_weight": (64, 16), "fc1_bias": (64,), "other": (3,)}
    js = jpart.partition_summary(jpar.rule_spec(_jmesh(), jr), shapes)
    ts = tpart.partition_summary(tpar.rule_spec(_tmesh(), tr), shapes)
    assert json.dumps(ts, sort_keys=True) == json.dumps(js, sort_keys=True)
    plain = tpart.partition_summary(tpar.dp_spec(
        tpar.mesh_from_contexts([mt.cpu(0), mt.cpu(1)])))
    assert plain == jpart.partition_summary(jpar.dp_spec(
        jpar.mesh_from_contexts([jmx.cpu(0), jmx.cpu(1)])))
    assert tpart.partition_summary(None) is None


def test_rule_spec_and_data_parallel_spec():
    spec = tpar.rule_spec(_tmesh(), _both(RULE_SETS["fc"])[1])
    jspec = jpar.rule_spec(_jmesh(), _both(RULE_SETS["fc"])[0])
    assert (spec.dp_size, spec.mp_size, spec.num_devices) == \
        (jspec.dp_size, jspec.mp_size, jspec.num_devices)
    assert tuple(spec.param_sharding("fc1_weight", (8, 8)).spec) == \
        tuple(jspec.param_sharding("fc1_weight", (8, 8)).spec)
    assert tuple(spec.data_sharding.spec) == ("dp",)
    assert spec.repl_sharding.is_fully_replicated
    assert tpar.MP_AXIS == jpar.MP_AXIS and tpar.DP_AXIS == jpar.DP_AXIS
    with pytest.raises(mt.MXNetError, match="no 'dp' data axis"):
        tpar.rule_spec(tpar.make_mesh({"mp": 1}, devices=[mt.cpu()]), None)


def test_shard_put_takes_each_members_block():
    mesh = _tmesh()
    a = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    pl = tpar.Placement(mesh, tpar.P(("dp", "mp"), None))
    got = mesh.run_local(lambda j: tpar.shard_put(a, pl))
    np.testing.assert_array_equal(torch.cat(got).numpy(), a)
    pl2 = tpar.Placement(mesh, tpar.P("mp", None))
    got2 = mesh.run_local(lambda j: tpar.shard_put(a, pl2))
    for j, g in enumerate(got2):
        np.testing.assert_array_equal(g.numpy(), np.split(a, 4)[j % 4])


def test_trainer_takes_partition_rules():
    """``param_specs`` from a ``PartitionRules``: resolved per parameter,
    downgraded where the mesh cannot place it."""
    mesh = tpar.make_mesh({"dp": 1, "mp": 2}, devices=[mt.cpu(0),
                                                       mt.cpu(1)])
    rules = tpart.PartitionRules([(r"w$", tpar.P("mp", None)),
                                  (r"odd$", tpar.P("mp"))])
    params = {"w": np.ones((4, 3), np.float32),
              "odd": np.ones((3,), np.float32)}
    tr = tpar.SPMDTrainer(lambda p, x: (p["w"].sum() + p["odd"].sum()) * x
                          .sum(), params, mesh, param_specs=rules,
                          n_batch_args=1, learning_rate=0.5)
    assert tuple(tr.param_specs["w"]) == ("mp", None)
    assert tuple(tr.param_specs["odd"]) == ()
    assert tuple(tr.params["w"].shape) == (2, 3)
    tr.step(np.ones((2,), np.float32))
    got = tr.get_params()
    np.testing.assert_allclose(got["w"], np.zeros((4, 3)))
    np.testing.assert_allclose(got["odd"], np.zeros((3,)))


@pytest.mark.parametrize("jmod,tmod,attr", [
    (jmoe, tmoe, "PARTITION_RULES"), (jpipe, tpipe, "PARTITION_RULES"),
    (jul, tul, "PARTITION_RULES"), (jring, tring, "PARTITION_RULES"),
    (jring, tring, "DECODE_PARTITION_RULES")])
def test_layer_partition_rules_equal_jax(jmod, tmod, attr):
    want = [(p, tuple(s)) for p, s in getattr(jmod, attr)]
    assert [(p, tuple(s)) for p, s in getattr(tmod, attr)] == want
    assert tpart.PartitionRules(getattr(tmod, attr)).describe() == \
        jpart.PartitionRules(getattr(jmod, attr)).describe()
