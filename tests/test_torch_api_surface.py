"""The port's user surface against the JAX package's (the counterpart of
``tests/test_api_surface.py``).

Every public name of ``mx.nd``, ``mx.sym``, ``mx.autograd``,
``mx.gluon``, ``mx.gluon.loss``, ``mx.gluon.nn``, ``mx.gluon.rnn``,
``mx.gluon.data``, ``mx.gluon.data.vision``, ``mx.gluon.model_zoo.vision``,
``mx.kvstore``, ``mx.rnn``, ``mx.mod``, ``mx.telemetry``, ``mx.faults``,
``mx.flight``, ``mx.profiler``, ``mx.log``, ``mx.tuner``,
``mx.compile_cache``, ``mx.checkpoint``, ``mx.callback``,
``mx.serving``, ``mx.metric``, ``mx.initializer``, ``mx.optimizer``,
``mx.io``, ``mx.mon`` and ``mx.parallel`` in ``mxnet_tpu``, and every public method of ``Symbol``,
``Module``, ``KVStore``, ``InferenceEngine`` and ``DecodeEngine``,
either exists in ``mxnet_tpu_torch`` or sits on the skip list below,
under the ROADMAP.md item that will port it. A name ported since must
leave the list (the test fails on a stale entry), so the list shrinks
PR by PR. Modules a namespace merely imports (``jax``, ``numpy``, the
standard library) are not names of the surface.
"""
import sys
import types

import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt

_LONG_TAIL_OPS = ["BatchNorm_v1", "Correlation", "DeformableConvolution",
                  "IdentityAttachKLSparseReg", "Proposal", "dequantize",
                  "fft", "ifft", "quantize", "BilinearSampler",
                  "GridGenerator", "SpatialTransformer",
                  "MultiProposal", "linalg_gelqf", "linalg_syevd", "Custom",
                  "MultiBoxDetection", "MultiBoxPrior", "MultiBoxTarget",
                  "ROIPooling", "ctc_loss"]
_REGISTRY = "Queue 1 item 6: registry.py (the registry helpers)"

# {namespace: {ROADMAP item: [names]}}
SKIP = {
    "nd": {
        "Queue 1 item 6: bf16 nd.save and load_frombuffer":
            ["load_frombuffer"],
        "Queue 1 item 6: long tail (contrib, spatial, ctc, rnn ops, "
        "image)": _LONG_TAIL_OPS + ["contrib", "imdecode"],
    },
    "sym": {
        "Queue 1 item 6: long tail (contrib, spatial, ctc, rnn ops)":
            _LONG_TAIL_OPS + ["contrib"],
    },
    "autograd": {},
    "gluon": {
        "Queue 1 item 6: gluon.contrib": ["contrib"],
    },
    "gluon.loss": {
        "Queue 1 item 6: CTCLoss (needs the ctc op)": ["CTCLoss"],
    },
    "gluon.nn": {},
    "gluon.data": {},
    "gluon.data.vision": {
        "Queue 1 item 6: recordio and image/": ["RecordFileDataset"],
    },
    "gluon.model_zoo.vision": {},
    "kvstore": {},
    "kvstore.KVStore": {},
    "sym.Symbol": {},
    "mod.Module": {},
    "gluon.rnn": {},
    "rnn": {
        "Queue 1 item 6: the convolutional RNN cells": [
            "BaseConvRNNCell", "ConvGRUCell", "ConvLSTMCell",
            "ConvRNNCell"],
    },
    "mod": {},
    "telemetry": {},
    "faults": {},
    "flight": {},
    "log": {},
    "callback": {},
    "profiler": {
        "Queue 1 item 6: config.py (MXNET_PROFILER_AUTOSTART)":
            ["get_env"],
    },
    "tuner": {
        "Queue 1 item 6: OperatorTuner": [
            "OperatorTuner", "get_env", "get_logger", "tuned_choice",
            "tuner"],
    },
    "compile_cache": {
        "Queue 1 item 6: the compile cache's executable store": [
            "cache_dir", "enabled", "entry_path", "faults", "index_get",
            "index_put", "load", "lowered_key", "persistable",
            "programs_record", "quick_key", "source_fingerprint",
            "store"],
    },
    "checkpoint": {},
    "serving": {
        "Queue 1 item 6: DeviceMemoryError (OOM errors enriched with "
        "the ledger)": ["DeviceMemoryError"],
    },
    "serving.InferenceEngine": {},
    "decode.DecodeEngine": {},
    "metric": {_REGISTRY: ["registry_create"]},
    "initializer": {_REGISTRY: ["init_registry", "registry_create"]},
    "optimizer": {_REGISTRY: ["registry_create", "jnp_abs",
                              "jnp_maximum"]},
    "io": {
        "Queue 1 item 6: recordio and image/": ["ImageRecordIter",
                                                "MXDataIter"],
        _REGISTRY: ["create_iterator", "register", "registry_create"],
    },
    "mon": {},
    "parallel": {
        "Queue 1 item 6: not to be ported (JAX's own shard_map and its "
        "compat module: every member runs its per-device code itself)":
            ["shard_map", "compat"],
    },
}


def _module(pkg, path):
    for part in path.split("."):
        pkg = getattr(pkg, part)
    return pkg


def _public(mod):
    out = set()
    for n in dir(mod):
        if n.startswith("_"):
            continue
        v = getattr(mod, n)
        if isinstance(v, types.ModuleType) and (
                v.__name__.split(".")[0] in ("jax", "jaxlib", "numpy")
                or v.__name__ in sys.stdlib_module_names):
            continue
        out.add(n)
    return out


@pytest.mark.parametrize("ns", sorted(SKIP))
def test_surface_is_ported_or_listed(ns):
    want = _public(_module(mx, ns))
    have = _public(_module(mt, ns))
    listed = {n: item for item, names in SKIP[ns].items() for n in names}
    missing = sorted(n for n in want - have if n not in listed)
    assert not missing, "%s: not ported and not on the skip list: %s" % (
        ns, missing)
    stale = sorted(n for n in listed if n in have or n not in want)
    assert not stale, "%s: ported (or gone), take off the list: %s" % (
        ns, stale)


def test_skip_list_names_a_roadmap_item():
    import os
    roadmap = open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "ROADMAP.md")).read()
    for items in SKIP.values():
        for item in items:
            assert item.startswith("Queue 1 item "), item
            assert "Queue 1" in roadmap
