"""The port's user surface against the JAX package's (the counterpart of
``tests/test_api_surface.py``).

Every public name of the top level ``mx``, ``mx.nd``, ``mx.sym``,
``mx.autograd``, ``mx.gluon``, ``mx.gluon.loss``, ``mx.gluon.nn``, ``mx.gluon.rnn``,
``mx.gluon.data``, ``mx.gluon.data.vision``, ``mx.gluon.model_zoo.vision``,
``mx.kvstore``, ``mx.rnn``, ``mx.mod``, ``mx.telemetry``, ``mx.faults``,
``mx.flight``, ``mx.profiler``, ``mx.log``, ``mx.tuner``,
``mx.compile_cache``, ``mx.checkpoint``, ``mx.callback``,
``mx.serving``, ``mx.metric``, ``mx.initializer``, ``mx.optimizer``,
``mx.io``, ``mx.mon``, ``mx.parallel``, ``mx.recordio``, ``mx.image``,
``mx.image.detection``, ``mx.filesystem``, ``mx.resource``,
``mx.gluon.contrib.rnn``, ``mx.engine``, ``mx.storage``, ``mx.registry``,
``mx.libinfo``, ``mx.visualization``, ``mx.test_utils`` and ``mx.contrib``
(with its ``autograd`` and ``tensorboard``) in ``mxnet_tpu``, and every public method of ``Symbol``,
``Module``, ``KVStore``, ``InferenceEngine`` and ``DecodeEngine``,
either exists in ``mxnet_tpu_torch`` or sits on the skip list below,
under the ROADMAP.md item that will port it. A name ported since must
leave the list (the test fails on a stale entry), so the list shrinks
PR by PR. Modules a namespace merely imports (``jax``, ``numpy``, the
standard library) are not names of the surface.
"""
import os
import sys
import types

import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401

# {namespace: {ROADMAP item: [names]}}; "mx" is the top level
SKIP = {
    "mx": {
        "Queue 1 item 6: not to be ported (mxnet_tpu/torch.py, mx.th)":
            ["th", "torch"],
    },
    "nd": {},
    "sym": {},
    "autograd": {},
    "gluon": {},
    "gluon.contrib.rnn": {},
    "gluon.loss": {},
    "gluon.nn": {},
    "gluon.data": {},
    "gluon.data.vision": {},
    "gluon.model_zoo.vision": {},
    "kvstore": {},
    "kvstore.KVStore": {},
    "sym.Symbol": {},
    "mod.Module": {},
    "gluon.rnn": {},
    "rnn": {},
    "mod": {},
    "telemetry": {},
    "faults": {},
    "flight": {},
    "log": {},
    "callback": {},
    "profiler": {},
    "tuner": {},
    "compile_cache": {
        "Queue 1 item 1: the compile cache's executable store (the port "
        "compiles no programs; its store keeps item 1's captured CUDA "
        "graphs)": [
            "cache_dir", "enabled", "entry_path", "faults", "index_get",
            "index_put", "load", "lowered_key", "persistable",
            "programs_record", "quick_key", "source_fingerprint",
            "store"],
    },
    "checkpoint": {},
    "serving": {},
    "serving.InferenceEngine": {},
    "decode.DecodeEngine": {},
    "metric": {},
    "initializer": {},
    "optimizer": {
        "Queue 1 item 6: not to be ported (jax.numpy wrappers, "
        "mxnet_tpu/optimizer.py:607-614)": ["jnp_abs", "jnp_maximum"]},
    "io": {},
    "mon": {},
    "recordio": {},
    "image": {},
    "image.detection": {},
    "filesystem": {},
    "resource": {},
    "engine": {},
    "storage": {},
    "registry": {},
    "libinfo": {},
    "visualization": {},
    "test_utils": {},
    "contrib": {},
    "contrib.autograd": {},
    "contrib.tensorboard": {},
    "parallel": {
        "Queue 1 item 6: not to be ported (JAX's own shard_map and its "
        "compat module: every member runs its per-device code itself)":
            ["shard_map", "compat"],
    },
}


def _module(pkg, path):
    for part in ([] if path == "mx" else path.split(".")):
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


def _top_level_of_a_fresh_import():
    """The JAX package's top-level public names right after ``import
    mxnet_tpu``, in a fresh interpreter: in this one, any subpackage a
    test imported earlier (``mxnet_tpu.pallas``, ``mxnet_tpu.analysis``)
    is an attribute of the package too."""
    import json
    import subprocess
    code = ("import json, sys, types, mxnet_tpu as m; print(json.dumps("
            "[n for n in dir(m) if not n.startswith('_') and not ("
            "isinstance(getattr(m, n), types.ModuleType) and ("
            "getattr(m, n).__name__.split('.')[0] in ('jax', 'jaxlib', "
            "'numpy') or getattr(m, n).__name__ in "
            "sys.stdlib_module_names))]))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("ns", sorted(SKIP))
def test_surface_is_ported_or_listed(ns):
    want = _top_level_of_a_fresh_import() if ns == "mx" else \
        _public(_module(mx, ns))
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


def test_top_level_device_names():
    """``mx.tpu`` raises naming ``mx.gpu`` (the port has no TPU and does
    not stand one in for the card); ``num_gpus`` counts CUDA devices;
    ``cpu_pinned`` is host memory; the classes and modules are the
    port's own."""
    import torch
    with pytest.raises(mt.MXNetError, match="mx.gpu"):
        mt.tpu(0)
    assert mt.num_gpus() == (torch.cuda.device_count()
                             if torch.cuda.is_available() else 0)
    assert mt.cpu_pinned().torch_device() == torch.device("cpu")
    assert mt.cpu_pinned() != mt.cpu()
    assert mt.NDArray is mt.nd.NDArray and mt.Symbol is mt.sym.Symbol
    assert mt.Executor is mt.executor.Executor and mt.rnd is mt.random
    assert mt.operator.CustomOp and mt.config.storage_fallback_log
