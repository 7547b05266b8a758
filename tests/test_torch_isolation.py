"""The PyTorch port stands alone: it imports no JAX and nothing of the JAX
package, and its entry points never fall back to the CPU silently."""
import ast
import os
import re
import subprocess
import sys

import pytest
import torch

import mxnet_tpu  # noqa: F401  (both packages in one process, as elsewhere)

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mxnet_tpu_torch")


def _port_modules():
    mods = []
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def _is_jax_side(name):
    return name.split(".")[0] in ("jax", "jaxlib") or name == "mxnet_tpu" \
        or name.startswith("mxnet_tpu.")


def test_import_loads_no_jax_and_no_jax_package():
    code = ("import importlib, sys\n"
            "for m in %r:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(n for n in sys.modules\n"
            "             if n.split('.')[0] in ('jax', 'jaxlib')\n"
            "             or n == 'mxnet_tpu' or n.startswith('mxnet_tpu.'))\n"
            "print(len(%r), bad)\n"
            "assert not bad, bad\n") % (_port_modules(), _port_modules())
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(_port_modules()) >= 20


@pytest.mark.parametrize("path", ["mxnet_tpu_torch", "chip_smoke.py"])
def test_sources_import_no_jax(path):
    target = os.path.join(ROOT, path)
    files = [target] if target.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(target) for f in fs
        if f.endswith(".py")]
    for fn in files:
        with open(fn) as f:
            tree = ast.parse(f.read(), fn)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert not _is_jax_side(n), "%s imports %s" % (fn, n)


def test_c_sources_import_only_port_modules():
    """The port's C library (``kernels/csrc/*.cc``) imports only
    ``mxnet_tpu_torch`` modules into its embedded interpreter: a copy of
    ``src/c_api.cc`` that kept ``mxnet_tpu.c_api_impl`` would load the
    JAX package from the port's library."""
    csrc = os.path.join(PKG, "kernels", "csrc")
    found = {}
    for f in sorted(os.listdir(csrc)):
        if not f.endswith((".cc", ".h")):
            continue
        with open(os.path.join(csrc, f)) as fh:
            src = fh.read()
        assert '"mxnet_tpu.' not in src and '"mxnet_tpu"' not in src, f
        mods = re.findall(r'PyImport_ImportModule\(\s*"([^"]+)"', src)
        for m in mods:
            assert m.split(".")[0] == "mxnet_tpu_torch", (f, m)
        found[f] = mods
    assert found["c_api.cc"] == ["mxnet_tpu_torch.c_api_impl"]
    assert found["c_predict_api.cc"] == ["mxnet_tpu_torch.c_predict"]


def test_no_cuda_and_no_ctx_raises(monkeypatch):
    """Without a CUDA device an entry point given no ctx raises instead of
    running on the CPU; an explicit cpu() works."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = mt.sym.Variable("data")
    net = mt.sym.FullyConnected(data, num_hidden=2, name="fc")
    params = {"arg:fc_weight": mt.nd.array([[1.0, 2.0], [3.0, 4.0]],
                                           ctx=mt.cpu()),
              "arg:fc_bias": mt.nd.zeros((2,), ctx=mt.cpu())}
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.serving.InferenceEngine(net, params, {"data": (1, 2)})
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.nd.zeros((2,))
    assert mt.current_context() == mt.gpu(0)
    with mt.serving.InferenceEngine(net, params, {"data": (1, 2)},
                                    ctx=mt.cpu(), max_batch=2) as eng:
        out = eng.predict(data=[[1.0, 1.0]])
    assert out[0].tolist() == [[3.0, 7.0]]
