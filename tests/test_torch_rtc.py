"""``mx.rtc`` in the port (K4's counterpart: CUDA C compiled by NVRTC and
launched through the CUDA driver) as far as the CPU can hold it: the
signature rules against ``mxnet_tpu.rtc``'s, the argument marshalling and
its refusals, the refusals without a card or a toolkit, and the C ABI's
RTC helpers (the legacy ``MXRtcCreate`` wrapper's source, the
``MXRtcCudaKernel*`` call convention). The kernels themselves run in
``tests/test_torch_gpu.py`` and ``chip_smoke.py``'s ``c_boundary`` phase."""
import ctypes
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import c_api_impl, rtc
from mxnet_tpu_torch.base import MXNetError

import torch_c_abi as abi
from torch_threads import one_torch_thread  # noqa: F401

SIGNATURES = [
    "float alpha, const float *x, float *y",
    "const __half* a, __half *b, __half s",
    "const uint8_t *x, float *y, const float *mean, int n",
    "double *d, int64_t n, int32_t m, int8_t k, char c",
    "const half *h, half v",
    "float*x",
    "const float*",
    "float",
    "  int  n  ",
    "widget *x",
    "const *x",
    "const const float *x",
    "float **x",
    "float *x, ",
    "unsigned int n",
    "float x[]",
    "",
]


def _jax_rule(sig):
    """(is_ndarray, dtypes) by the JAX package's parser, or None when it
    refuses the signature."""
    mod = mj.rtc.PallasModule("def f(*a):\n    return a\n", exports=["f"])
    try:
        k = mod.get_kernel("f", sig)
    except mj.base.MXNetError:
        return None
    return k._is_ndarray, k._dtypes


@pytest.mark.parametrize("sig", SIGNATURES)
def test_signature_rules_match_the_jax_package(sig):
    want = _jax_rule(sig)
    try:
        got = rtc.parse_signature(sig)
    except MXNetError:
        got = None
    if want is None:
        assert got is None, (sig, got)
        return
    assert got is not None, sig
    assert [p for p, _, _ in got] == want[0]
    assert [(d, p and not c) for p, c, d in got] == \
        [(str(np.dtype(d)), m) for d, m in want[1]]


def test_pallas_module_raises_naming_cuda_module():
    for cls in (mt.rtc.PallasModule, mt.rtc.PallasKernel):
        with pytest.raises(MXNetError, match="CudaModule"):
            cls("def f(x):\n    return x\n")


def test_missing_nvrtc_raises_naming_the_paths(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(rtc, "_libs", {})
    with pytest.raises(MXNetError) as e:
        mt.rtc.CudaModule('extern "C" __global__ void k() {}')
    msg = str(e.value)
    assert os.path.join(str(tmp_path), "lib64") in msg
    assert "/usr/local/cuda/lib64" in msg and "libnvrtc" in msg


def _kernel(sig):
    return rtc.CudaKernel(None, "k", "k", rtc.parse_signature(sig))


def test_cpu_context_raises_naming_gpu():
    k = _kernel("const float *x, float *y")
    x = mt.nd.ones((4,), ctx=mt.cpu())
    before = rtc.launches
    with pytest.raises(MXNetError, match=r"mx\.gpu"):
        k.launch([x, x], mt.cpu(), (1, 1, 1), (4, 1, 1))
    assert rtc.launches == before


def test_marshalling_passes_pointers_and_typed_scalars():
    k = _kernel("const float *x, float *y, float a, __half h, int n, "
                "int64_t m, double d")
    x = mt.nd.array(np.arange(4, dtype=np.float32), ctx=mt.cpu())
    y = mt.nd.zeros((4,), ctx=mt.cpu())
    vals = k._marshal([x, y, 0.5, 1.5, 7, 2 ** 40, 0.25],
                      torch.device("cpu"))
    assert vals[0].value == x._data.data_ptr()
    assert vals[1].value == y._data.data_ptr()
    assert isinstance(vals[2], ctypes.c_float) and vals[2].value == 0.5
    assert isinstance(vals[3], ctypes.c_uint16)
    assert vals[3].value == int(np.float16(1.5).view(np.uint16))
    assert isinstance(vals[4], ctypes.c_int32) and vals[4].value == 7
    assert isinstance(vals[5], ctypes.c_int64) and vals[5].value == 2 ** 40
    assert isinstance(vals[6], ctypes.c_double) and vals[6].value == 0.25


@pytest.mark.parametrize("case", ["dtype", "device", "strided", "count",
                                  "pointer_scalar", "scalar_array"])
def test_marshalling_refuses_before_any_launch(case):
    k = _kernel("const float *x, float a")
    cpu = torch.device("cpu")
    x = mt.nd.ones((4, 4), ctx=mt.cpu())
    args = {"dtype": [mt.nd.ones((4,), ctx=mt.cpu(), dtype="int32"), 1.0],
            "device": [x, 1.0],
            "strided": [mt.nd.NDArray(x._data.t()), 1.0],
            "count": [x],
            "pointer_scalar": [1.0, 1.0],
            "scalar_array": [x, x]}[case]
    dev = torch.device("meta") if case == "device" else cpu
    before = rtc.launches
    with pytest.raises(MXNetError):
        k._marshal(args, dev)
    assert rtc.launches == before


def test_legacy_wrapper_source_is_the_references():
    x = mt.nd.zeros((2, 3), ctx=mt.cpu())
    y = mt.nd.zeros((6,), ctx=mt.cpu())
    src = c_api_impl.legacy_rtc_source(
        "twice", ["x"], ["y"], [x], [y],
        "y[threadIdx.x] = 2.0f * x[threadIdx.x];")
    assert src == ('\nextern "C" __global__ void twice(const float* x,'
                   'float* y) {\n'
                   'const int x_ndim = 2;\n'
                   'const int x_dims[] = {2,3};\n'
                   'const int y_ndim = 1;\n'
                   'const int y_dims[] = {6};\n'
                   'y[threadIdx.x] = 2.0f * x[threadIdx.x];\n}\n')


class _FakeModule:
    def get_kernel(self, name, sig):
        return ("kernel", name, sig)


def test_c_kernel_create_builds_the_signature():
    k, is_nd, codes = c_api_impl.rtc_kernel_create(
        _FakeModule(), "norm", [1, 1, 0, 0], [1, 0, 0, 0], [3, 0, 2, 4])
    assert k == ("kernel", "norm",
                 "const uint8_t*, float*, half, int32_t")
    assert is_nd == [True, True, False, False] and codes == [3, 0, 2, 4]
    assert [p for p, _, _ in rtc.parse_signature(k[2])] == is_nd


def test_c_kernel_call_reads_scalars_by_their_type(monkeypatch):
    """The reference's ``void**`` convention: an NDArray argument is its
    handle, a scalar a pointer to its value (``half`` as 16 bits); the
    grid, block and shared memory pass through unchanged."""
    seen = {}

    class _K:
        def launch(self, args, ctx, grid, block, shared_mem=0):
            seen.update(args=args, ctx=ctx, grid=grid, block=block,
                        smem=shared_mem)

    monkeypatch.setattr(mt, "gpu", lambda i=0: ("gpu", i))
    x = mt.nd.ones((2,), ctx=mt.cpu())
    h = ctypes.c_uint16(int(np.float16(-2.5).view(np.uint16)))
    f = ctypes.c_float(0.75)
    n = ctypes.c_int32(9)
    addrs = [id(x), ctypes.addressof(f), ctypes.addressof(h),
             ctypes.addressof(n)]
    c_api_impl.rtc_kernel_call((_K(), [True, False, False, False],
                                [0, 0, 2, 4]), 1, addrs, 2, 3, 4, 5, 6, 7,
                               4096)
    assert seen["args"][0] is x
    assert seen["args"][1] == 0.75 and seen["args"][3] == 9
    assert float(seen["args"][2]) == -2.5
    assert seen["ctx"] == ("gpu", 1)
    assert seen["grid"] == (2, 3, 4) and seen["block"] == (5, 6, 7)
    assert seen["smem"] == 4096


def test_c_module_create_without_a_card_names_the_cause():
    L = abi.lib()
    L.MXRtcCudaModuleCreate.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_char_p),
                                        ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_char_p),
                                        ctypes.POINTER(ctypes.c_void_p)]
    mod = ctypes.c_void_p()
    assert L.MXRtcCudaModuleCreate(
        b'extern "C" __global__ void k(float* y) { y[0] = 1.0f; }', 0,
        None, 0, None, ctypes.byref(mod)) == -1
    assert b"libnvrtc not found" in L.MXGetLastError()
    assert mod.value is None
