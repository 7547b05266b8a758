"""The port's general C API (``kernels/csrc/c_api.cc`` over
``mxnet_tpu_torch/c_api_impl.py``), loaded in process on the CPU
(``dev_type`` 1): the cases of ``tests/test_c_api.py``, each result held
against the JAX package's Python API on the same inputs; the LeNet C
driver and ``cpp-package/example/train_lenet.cpp`` built against the
port's library and run as standalone programs."""
import ctypes
import os

import numpy as np
import pytest

import mxnet_tpu as mxj
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.kernels import _build

import torch_c_abi as abi
from torch_threads import one_torch_thread  # noqa: F401

vp, u, i_ = ctypes.c_void_p, ctypes.c_uint, ctypes.c_int
P, cp = ctypes.POINTER, ctypes.c_char_p


def _lib():
    L = abi.lib()
    # explicit argtypes throughout: bare python ints (a dereferenced
    # handle `outs[0]`) otherwise marshal as 32-bit c_int
    L.MXNDArrayCreateEx.argtypes = [P(u), u, i_, i_, i_, i_, P(vp)]
    L.MXNDArrayFree.argtypes = [vp]
    L.MXNDArraySyncCopyFromCPU.argtypes = [vp, vp, ctypes.c_size_t]
    L.MXNDArraySyncCopyToCPU.argtypes = [vp, vp, ctypes.c_size_t]
    L.MXNDArrayGetShape.argtypes = [vp, P(u), P(P(u))]
    L.MXNDArrayGetDType.argtypes = [vp, P(i_)]
    L.MXNDArrayWaitToRead.argtypes = [vp]
    L.MXImperativeInvoke.argtypes = [vp, i_, P(vp), P(i_), P(P(vp)), i_,
                                     P(cp), P(cp)]
    L.MXNDArraySlice.argtypes = [vp, u, u, P(vp)]
    L.MXNDArrayAt.argtypes = [vp, u, P(vp)]
    L.MXNDArrayReshape.argtypes = [vp, i_, P(i_), P(vp)]
    L.MXNDArrayGetContext.argtypes = [vp, P(i_), P(i_)]
    L.MXNDArrayGetStorageType.argtypes = [vp, P(i_)]
    L.MXNDArraySaveRawBytes.argtypes = [vp, P(ctypes.c_size_t), P(vp)]
    L.MXNDArrayLoadFromRawBytes.argtypes = [vp, ctypes.c_size_t, P(vp)]
    L.MXNDArraySyncCopyFromNDArray.argtypes = [vp, vp, i_]
    L.MXNDArrayGetGrad.argtypes = [vp, P(vp)]
    L.MXRecordIOWriterWriteRecord.argtypes = [vp, cp, ctypes.c_size_t]
    L.MXRecordIOReaderSeek.argtypes = [vp, ctypes.c_size_t]
    L.MXKVStoreSetUpdater.argtypes = [vp, vp, vp]
    L.MXKVStoreSetUpdaterEx.argtypes = [vp, vp, vp, vp]
    L.MXSymbolSaveToJSON.argtypes = [vp, P(cp)]
    L.MXSymbolGetName.argtypes = [vp, P(cp), P(i_)]
    L.MXSymbolGetAttr.argtypes = [vp, cp, P(cp), P(i_)]
    L.MXSymbolSetAttr.argtypes = [vp, cp, cp]
    L.MXKVStoreGetType.argtypes = [vp, P(cp)]
    L.MXExecutorPrint.argtypes = [vp, P(cp)]
    L.MXSymbolListAtomicSymbolCreators.argtypes = [P(u), P(P(vp))]
    L.MXSymbolGetAtomicSymbolName.argtypes = [vp, P(cp)]
    L.MXSymbolGetAtomicSymbolInfo.argtypes = [vp, P(cp), P(cp), P(u),
                                              P(P(cp)), P(P(cp)), P(P(cp)),
                                              P(cp), P(cp)]
    L.MXListDataIters.argtypes = [P(u), P(P(vp))]
    L.MXDataIterGetIterInfo.argtypes = [vp, P(cp), P(cp), P(u), P(P(cp)),
                                        P(P(cp)), P(P(cp))]
    L.MXDataIterCreateIter.argtypes = [vp, u, P(cp), P(cp), P(vp)]
    L.MXInvokeCachedOp.argtypes = [vp, i_, P(vp), P(i_), P(P(vp))]
    L.MXNDArrayCreateSparseEx.argtypes = [i_, P(u), u, i_, i_, i_, i_, u,
                                          P(i_), P(u), P(u), P(vp)]
    L.MXNDArrayGetAuxType.argtypes = [vp, u, P(i_)]
    L.MXNDArrayGetAuxNDArray.argtypes = [vp, u, P(vp)]
    L.MXNDArrayGetDataNDArray.argtypes = [vp, P(vp)]
    L.MXNDArraySyncCheckFormat.argtypes = [vp, ctypes.c_bool]
    L.MXNDArrayGetData.argtypes = [vp, P(vp)]
    L.MXGetFunction.argtypes = [cp, P(vp)]
    L.MXFuncDescribe.argtypes = [vp, P(u), P(u), P(u), P(i_)]
    L.MXFuncGetInfo.argtypes = [vp, P(cp), P(cp), P(u), P(P(cp)),
                                P(P(cp)), P(P(cp)), P(cp)]
    L.MXFuncInvoke.argtypes = [vp, P(vp), P(ctypes.c_float), P(vp)]
    L.MXExecutorSetMonitorCallback.argtypes = [vp, vp, vp]
    L.MXRtcCudaModuleCreate.argtypes = [cp, i_, P(cp), i_, P(cp), P(vp)]
    L.MXRtcCreate.argtypes = [cp, u, u, P(cp), P(cp), P(vp), P(vp), cp,
                              P(vp)]
    L.MXNDArrayGetSharedMemHandle.argtypes = [vp, P(i_), P(i_)]
    L.MXNDArrayCreateFromSharedMem.argtypes = [i_, i_, P(u), u, i_, P(vp)]
    L.MXCustomOpRegister.argtypes = [cp, vp]
    return L


def _make_nd(L, arr, dev_type=1):
    arr = np.ascontiguousarray(arr, np.float32)
    shape = (ctypes.c_uint * arr.ndim)(*arr.shape)
    h = ctypes.c_void_p()
    assert L.MXNDArrayCreateEx(shape, arr.ndim, dev_type, 0, 0, 0,
                               ctypes.byref(h)) == 0, L.MXGetLastError()
    assert L.MXNDArraySyncCopyFromCPU(h, arr.ctypes.data, arr.size) == 0
    return h


def _read_nd(L, h, n):
    got = np.zeros(n, np.float32)
    assert L.MXNDArraySyncCopyToCPU(h, got.ctypes.data, n) == 0, \
        L.MXGetLastError()
    return got


def _scaled(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_ndarray_roundtrip_and_invoke():
    L = _lib()
    x = np.arange(6, dtype=np.float32).reshape(2, 3) / 4
    h = _make_nd(L, x)
    assert L.MXNDArrayWaitToRead(h) == 0
    ndim = ctypes.c_uint()
    pdata = ctypes.POINTER(ctypes.c_uint)()
    assert L.MXNDArrayGetShape(h, ctypes.byref(ndim),
                               ctypes.byref(pdata)) == 0
    assert tuple(pdata[i] for i in range(ndim.value)) == (2, 3)
    dt = ctypes.c_int()
    assert L.MXNDArrayGetDType(h, ctypes.byref(dt)) == 0 and dt.value == 0

    op = ctypes.c_void_p()
    assert L.NNGetOpHandle(b"exp", ctypes.byref(op)) == 0
    n_out = ctypes.c_int(0)
    outs = ctypes.POINTER(ctypes.c_void_p)()
    ins = (ctypes.c_void_p * 1)(h)
    assert L.MXImperativeInvoke(op, 1, ins, ctypes.byref(n_out),
                                ctypes.byref(outs), 0, None, None) == 0, \
        L.MXGetLastError()
    assert n_out.value == 1
    want = mxj.nd.exp(mxj.nd.array(x)).asnumpy().ravel()
    np.testing.assert_allclose(_read_nd(L, outs[0], 6), want, rtol=1e-6)
    assert L.MXNDArrayFree(outs[0]) == 0
    assert L.MXNDArrayFree(h) == 0


def test_list_op_names():
    L = _lib()
    n = ctypes.c_uint()
    arr = ctypes.POINTER(ctypes.c_char_p)()
    assert L.MXListAllOpNames(ctypes.byref(n), ctypes.byref(arr)) == 0
    names = {arr[i].decode() for i in range(n.value)}
    assert n.value > 200
    assert {"Convolution", "FullyConnected", "sgd_update"} <= names


def test_c_train_driver(tmp_path):
    """The standalone C LeNet training driver of tests/test_c_api.py,
    linked with ``_build.driver_link_flags()``, on the host."""
    json_path = abi.lenet_symbol(mt, str(tmp_path / "lenet-symbol.json"))
    exe = abi.build_driver(abi.LENET_DRIVER_SRC, tmp_path, "train_driver")
    p = abi.run_driver(exe, [json_path, 1])
    assert p.returncode == 0, p.stdout + p.stderr
    assert "TRAIN_OK" in p.stdout, p.stdout
    assert float(p.stdout.split("acc=")[1].split()[0]) > 0.8, p.stdout


def test_cpp_package_train_lenet(tmp_path):
    """``cpp-package/example/train_lenet.cpp``, unchanged, built against
    the port's library and run on the host as the example asks."""
    json_path = abi.lenet_symbol(mt, str(tmp_path / "lenet-symbol.json"))
    with open(os.path.join(abi.REPO, "cpp-package", "example",
                           "train_lenet.cpp")) as f:
        src = f.read()
    exe = abi.build_driver(src, tmp_path, "train_lenet", cxx=True,
                           include=[os.path.join(abi.REPO, "cpp-package",
                                                 "include")])
    p = abi.run_driver(exe, [json_path])
    assert p.returncode == 0, p.stdout + p.stderr
    assert "CPP_TRAIN_OK" in p.stdout, p.stdout
    assert float(p.stdout.split("acc=")[1].split()[0]) > 0.8, p.stdout


def test_runtime_knobs():
    L = _lib()
    v = ctypes.c_int()
    assert L.MXGetVersion(ctypes.byref(v)) == 0 and v.value == 1201
    assert L.MXRandomSeed(42) == 0
    prev = ctypes.c_int(-1)
    assert L.MXEngineSetBulkSize(16, ctypes.byref(prev)) == 0
    assert prev.value >= 0
    assert L.MXSetNumOMPThreads(2) == 0
    worker = ctypes.c_int()
    assert L.MXKVStoreIsWorkerNode(ctypes.byref(worker)) == 0
    assert worker.value == 1


def test_ndarray_extras():
    L = _lib()
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    h = _make_nd(L, x)
    s = ctypes.c_void_p()
    assert L.MXNDArraySlice(h, 1, 3, ctypes.byref(s)) == 0
    np.testing.assert_array_equal(_read_nd(L, s, 8), x[1:3].ravel())
    a = ctypes.c_void_p()
    assert L.MXNDArrayAt(h, 2, ctypes.byref(a)) == 0
    np.testing.assert_array_equal(_read_nd(L, a, 4), x[2])
    dims = (ctypes.c_int * 2)(4, 3)
    r = ctypes.c_void_p()
    assert L.MXNDArrayReshape(h, 2, dims, ctypes.byref(r)) == 0
    ndim = ctypes.c_uint()
    pdata = ctypes.POINTER(ctypes.c_uint)()
    assert L.MXNDArrayGetShape(r, ctypes.byref(ndim),
                               ctypes.byref(pdata)) == 0
    assert tuple(pdata[i] for i in range(ndim.value)) == (4, 3)

    dev_type, dev_id = ctypes.c_int(), ctypes.c_int()
    assert L.MXNDArrayGetContext(h, ctypes.byref(dev_type),
                                 ctypes.byref(dev_id)) == 0
    assert dev_type.value == 1 and dev_id.value == 0
    st = ctypes.c_int(-2)
    assert L.MXNDArrayGetStorageType(h, ctypes.byref(st)) == 0
    assert st.value == 0

    # raw bytes: the blob records the context and loads back onto it
    size = ctypes.c_size_t()
    buf = ctypes.c_void_p()
    assert L.MXNDArraySaveRawBytes(h, ctypes.byref(size),
                                   ctypes.byref(buf)) == 0
    h2 = ctypes.c_void_p()
    assert L.MXNDArrayLoadFromRawBytes(buf, size.value,
                                       ctypes.byref(h2)) == 0, \
        L.MXGetLastError()
    np.testing.assert_array_equal(_read_nd(L, h2, 12), x.ravel())
    assert L.MXNDArrayGetContext(h2, ctypes.byref(dev_type),
                                 ctypes.byref(dev_id)) == 0
    assert dev_type.value == 1

    none_h = ctypes.c_void_p()
    assert L.MXNDArrayCreateNone(ctypes.byref(none_h)) == 0
    assert L.MXNDArraySyncCopyFromNDArray(none_h, h, -1) == 0
    np.testing.assert_array_equal(_read_nd(L, none_h, 12), x.ravel())
    for hh in (h, s, a, r, h2, none_h):
        assert L.MXNDArrayFree(hh) == 0


def test_symbol_surface_and_compose():
    L = _lib()
    data = ctypes.c_void_p()
    assert L.MXSymbolCreateVariable(b"data", ctypes.byref(data)) == 0
    op = ctypes.c_void_p()
    assert L.NNGetOpHandle(b"FullyConnected", ctypes.byref(op)) == 0
    keys = (ctypes.c_char_p * 1)(b"num_hidden")
    vals = (ctypes.c_char_p * 1)(b"8")
    fc = ctypes.c_void_p()
    assert L.MXSymbolCreateAtomicSymbol(op, 1, keys, vals,
                                        ctypes.byref(fc)) == 0, \
        L.MXGetLastError()
    args = (ctypes.c_void_p * 1)(data)
    assert L.MXSymbolCompose(fc, b"fc1", 1, None, args) == 0, \
        L.MXGetLastError()
    n = ctypes.c_uint()
    arr = ctypes.POINTER(ctypes.c_char_p)()
    assert L.MXSymbolListArguments(fc, ctypes.byref(n),
                                   ctypes.byref(arr)) == 0
    want = mxj.sym.FullyConnected(mxj.sym.Variable("data"), num_hidden=8,
                                  name="fc1").list_arguments()
    assert [arr[i].decode() for i in range(n.value)] == want
    name = ctypes.c_char_p()
    ok = ctypes.c_int()
    assert L.MXSymbolGetName(fc, ctypes.byref(name), ctypes.byref(ok)) == 0
    assert ok.value == 1 and name.value == b"fc1"
    assert L.MXSymbolSetAttr(fc, b"lr_mult", b"2.0") == 0
    got = ctypes.c_char_p()
    assert L.MXSymbolGetAttr(fc, b"lr_mult", ctypes.byref(got),
                             ctypes.byref(ok)) == 0
    assert ok.value == 1 and got.value == b"2.0"

    js = ctypes.c_char_p()
    assert L.MXSymbolSaveToJSON(fc, ctypes.byref(js)) == 0
    h2 = ctypes.c_void_p()
    assert L.MXSymbolCreateFromJSON(js.value, ctypes.byref(h2)) == 0, \
        L.MXGetLastError()
    # the JAX package reads the port's JSON
    assert mxj.sym.load_json(js.value.decode()).list_arguments() == want
    cpy = ctypes.c_void_p()
    assert L.MXSymbolCopy(fc, ctypes.byref(cpy)) == 0
    internals = ctypes.c_void_p()
    assert L.MXSymbolGetInternals(fc, ctypes.byref(internals)) == 0
    out0 = ctypes.c_void_p()
    assert L.MXSymbolGetOutput(internals, 0, ctypes.byref(out0)) == 0
    children = ctypes.c_void_p()
    assert L.MXSymbolGetChildren(fc, ctypes.byref(children)) == 0
    assert children.value is not None

    tk = (ctypes.c_char_p * 1)(b"data")
    tc = (ctypes.c_int * 1)(0)
    in_n, out_n, aux_n = ctypes.c_uint(), ctypes.c_uint(), ctypes.c_uint()
    in_t = ctypes.POINTER(ctypes.c_int)()
    out_t = ctypes.POINTER(ctypes.c_int)()
    aux_t = ctypes.POINTER(ctypes.c_int)()
    comp = ctypes.c_int()
    assert L.MXSymbolInferType(fc, 1, tk, tc, ctypes.byref(in_n),
                               ctypes.byref(in_t), ctypes.byref(out_n),
                               ctypes.byref(out_t), ctypes.byref(aux_n),
                               ctypes.byref(aux_t), ctypes.byref(comp)) == 0
    assert comp.value == 1 and out_t[0] == 0
    for h in (data, fc, h2, cpy, internals, out0, children):
        L.MXSymbolFree(h)


def test_atomic_symbol_info():
    L = _lib()
    n = ctypes.c_uint()
    creators = ctypes.POINTER(ctypes.c_void_p)()
    assert L.MXSymbolListAtomicSymbolCreators(ctypes.byref(n),
                                              ctypes.byref(creators)) == 0
    assert n.value > 200
    name = ctypes.c_char_p()
    assert L.MXSymbolGetAtomicSymbolName(creators[0],
                                         ctypes.byref(name)) == 0
    assert len(name.value) > 0
    op = ctypes.c_void_p()
    assert L.NNGetOpHandle(b"Convolution", ctypes.byref(op)) == 0
    desc = ctypes.c_char_p()
    num_args = ctypes.c_uint()
    an = ctypes.POINTER(ctypes.c_char_p)()
    at = ctypes.POINTER(ctypes.c_char_p)()
    ad = ctypes.POINTER(ctypes.c_char_p)()
    kv = ctypes.c_char_p()
    rt = ctypes.c_char_p()
    assert L.MXSymbolGetAtomicSymbolInfo(
        op, ctypes.byref(name), ctypes.byref(desc), ctypes.byref(num_args),
        ctypes.byref(an), ctypes.byref(at), ctypes.byref(ad),
        ctypes.byref(kv), ctypes.byref(rt)) == 0
    assert name.value == b"Convolution"
    names = [an[i].decode() for i in range(num_args.value)]
    assert "data" in names and "weight" in names


def _fc_params(rs):
    return (rs.rand(5, 3).astype(np.float32), rs.rand(4, 3).astype(np.float32),
            rs.rand(4).astype(np.float32))


def test_simple_bind_forward_backward():
    L = _lib()
    sym = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=4,
                                name="fc")
    h = ctypes.c_void_p()
    assert L.MXSymbolCreateFromJSON(sym.tojson().encode(),
                                    ctypes.byref(h)) == 0
    shape_names = (ctypes.c_char_p * 1)(b"data")
    shape_idx = (ctypes.c_uint * 2)(0, 2)
    shape_data = (ctypes.c_uint * 2)(5, 3)
    req_types = (ctypes.c_char_p * 1)(b"write")
    num_in = ctypes.c_uint()
    in_args = ctypes.POINTER(ctypes.c_void_p)()
    arg_grads = ctypes.POINTER(ctypes.c_void_p)()
    num_aux = ctypes.c_uint()
    aux = ctypes.POINTER(ctypes.c_void_p)()
    ex = ctypes.c_void_p()
    shared_len = ctypes.c_int(-1)
    assert L.MXExecutorSimpleBind(
        h, 1, 0, 0, None, None, None, 1, None, req_types,
        1, shape_names, shape_data, shape_idx, 0, None, None, 0, None, None,
        0, None, ctypes.byref(shared_len), None, None, None, None,
        ctypes.byref(num_in), ctypes.byref(in_args), ctypes.byref(arg_grads),
        ctypes.byref(num_aux), ctypes.byref(aux),
        None, ctypes.byref(ex)) == 0, L.MXGetLastError()
    assert num_in.value == 3
    x, w, b = _fc_params(np.random.RandomState(0))
    for k, v in enumerate((x, w, b)):
        assert L.MXNDArraySyncCopyFromCPU(ctypes.c_void_p(in_args[k]),
                                          v.ctypes.data, v.size) == 0
    assert L.MXExecutorForward(ex, 1) == 0
    n_outs = ctypes.c_uint()
    outs = ctypes.POINTER(ctypes.c_void_p)()
    assert L.MXExecutorOutputs(ex, ctypes.byref(n_outs),
                               ctypes.byref(outs)) == 0
    assert n_outs.value == 1
    og_np = np.random.RandomState(1).rand(5, 4).astype(np.float32)
    og = _make_nd(L, og_np)
    heads = (ctypes.c_void_p * 1)(og)
    assert L.MXExecutorBackwardEx(ex, 1, heads, 1) == 0, L.MXGetLastError()

    jsym = mxj.sym.FullyConnected(mxj.sym.Variable("data"), num_hidden=4,
                                  name="fc")
    jex = jsym.simple_bind(ctx=mxj.cpu(), grad_req="write", data=(5, 3))
    for arr, v in zip(jex.arg_arrays, (x, w, b)):
        arr[:] = v
    jex.forward(is_train=True)
    jex.backward(out_grads=[mxj.nd.array(og_np)])
    assert _scaled(_read_nd(L, outs[0], 20),
                   jex.outputs[0].asnumpy().ravel()) <= 1e-5
    for k in range(3):
        want = jex.grad_arrays[k].asnumpy().ravel()
        assert _scaled(_read_nd(L, arg_grads[k], want.size), want) <= 1e-5
    s = ctypes.c_char_p()
    assert L.MXExecutorPrint(ex, ctypes.byref(s)) == 0
    assert b"Executor" in s.value
    L.MXExecutorFree(ex)
    L.MXSymbolFree(h)


def test_cached_op():
    L = _lib()
    sym = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=2,
                                name="fc")
    h = ctypes.c_void_p()
    assert L.MXSymbolCreateFromJSON(sym.tojson().encode(),
                                    ctypes.byref(h)) == 0
    cop = ctypes.c_void_p()
    assert L.MXCreateCachedOp(h, ctypes.byref(cop)) == 0, L.MXGetLastError()
    rs = np.random.RandomState(1)
    jsym = mxj.sym.FullyConnected(mxj.sym.Variable("data"), num_hidden=2,
                                  name="fc")
    for _ in range(2):          # the second call reuses the bound executor
        x = rs.rand(3, 4).astype(np.float32)
        w = rs.rand(2, 4).astype(np.float32)
        b = rs.rand(2).astype(np.float32)
        ins = (ctypes.c_void_p * 3)(_make_nd(L, x), _make_nd(L, w),
                                    _make_nd(L, b))
        n_out = ctypes.c_int(0)
        outs = ctypes.POINTER(ctypes.c_void_p)()
        assert L.MXInvokeCachedOp(cop, 3, ins, ctypes.byref(n_out),
                                  ctypes.byref(outs)) == 0, L.MXGetLastError()
        assert n_out.value == 1
        jex = jsym.bind(mxj.cpu(), [mxj.nd.array(v) for v in (x, w, b)])
        want = jex.forward()[0].asnumpy().ravel()
        assert _scaled(_read_nd(L, outs[0], 6), want) <= 1e-5
    assert L.MXFreeCachedOp(cop) == 0
    L.MXSymbolFree(h)


def test_autograd_c_api():
    L = _lib()
    x = np.array([[1.0, -2.0], [3.0, 0.5]], np.float32)
    h = _make_nd(L, x)
    g = _make_nd(L, np.zeros_like(x))
    vars_ = (ctypes.c_void_p * 1)(h)
    reqs = (ctypes.c_uint * 1)(1)
    grads = (ctypes.c_void_p * 1)(g)
    assert L.MXAutogradMarkVariables(1, vars_, reqs, grads) == 0, \
        L.MXGetLastError()
    prev = ctypes.c_int(-1)
    assert L.MXAutogradSetIsRecording(1, ctypes.byref(prev)) == 0
    assert L.MXAutogradSetIsTraining(1, ctypes.byref(prev)) == 0
    rec = ctypes.c_bool(False)
    assert L.MXAutogradIsRecording(ctypes.byref(rec)) == 0
    assert rec.value
    op = ctypes.c_void_p()
    assert L.NNGetOpHandle(b"square", ctypes.byref(op)) == 0
    ins = (ctypes.c_void_p * 1)(h)
    n_out = ctypes.c_int(0)
    outs = ctypes.POINTER(ctypes.c_void_p)()
    assert L.MXImperativeInvoke(op, 1, ins, ctypes.byref(n_out),
                                ctypes.byref(outs), 0, None, None) == 0
    y = ctypes.c_void_p(outs[0])
    out_handles = (ctypes.c_void_p * 1)(y)
    assert L.MXAutogradBackward(1, out_handles, None, 0) == 0, \
        L.MXGetLastError()
    assert L.MXAutogradSetIsRecording(0, ctypes.byref(prev)) == 0
    assert L.MXAutogradSetIsTraining(0, ctypes.byref(prev)) == 0

    jx = mxj.nd.array(x)
    jx.attach_grad()
    with mxj.autograd.record():
        jy = mxj.nd.square(jx)
    jy.backward()
    assert _scaled(_read_nd(L, g, 4), jx.grad.asnumpy().ravel()) <= 1e-5
    gh = ctypes.c_void_p()
    assert L.MXNDArrayGetGrad(h, ctypes.byref(gh)) == 0
    assert gh.value is not None
    for hh in (h, g, y, gh):
        L.MXNDArrayFree(hh)


def test_data_iter_c_api(tmp_path):
    L = _lib()
    n = ctypes.c_uint()
    creators = ctypes.POINTER(ctypes.c_void_p)()
    assert L.MXListDataIters(ctypes.byref(n), ctypes.byref(creators)) == 0
    names = {}
    for i in range(n.value):
        nm = ctypes.c_char_p()
        assert L.MXSymbolGetAtomicSymbolName(creators[i],
                                             ctypes.byref(nm)) == 0
        names[nm.value.decode()] = creators[i]
    assert "CSVIter" in names and "MNISTIter" in names
    nm = ctypes.c_char_p()
    desc = ctypes.c_char_p()
    num_args = ctypes.c_uint()
    an = ctypes.POINTER(ctypes.c_char_p)()
    at = ctypes.POINTER(ctypes.c_char_p)()
    ad = ctypes.POINTER(ctypes.c_char_p)()
    assert L.MXDataIterGetIterInfo(names["CSVIter"], ctypes.byref(nm),
                                   ctypes.byref(desc), ctypes.byref(num_args),
                                   ctypes.byref(an), ctypes.byref(at),
                                   ctypes.byref(ad)) == 0
    assert nm.value == b"CSVIter"

    data = np.random.RandomState(3).rand(6, 4).astype(np.float32)
    csv = tmp_path / "d.csv"
    np.savetxt(str(csv), data, delimiter=",", fmt="%.6f")
    keys = (ctypes.c_char_p * 3)(b"data_csv", b"data_shape", b"batch_size")
    vals = (ctypes.c_char_p * 3)(str(csv).encode(), b"(4,)", b"2")
    it = ctypes.c_void_p()
    assert L.MXDataIterCreateIter(names["CSVIter"], 3, keys, vals,
                                  ctypes.byref(it)) == 0, L.MXGetLastError()
    jit = mxj.io.CSVIter(data_csv=str(csv), data_shape=(4,), batch_size=2)
    seen = 0
    has = ctypes.c_int(1)
    while True:
        assert L.MXDataIterNext(it, ctypes.byref(has)) == 0
        if not has.value:
            break
        d = ctypes.c_void_p()
        assert L.MXDataIterGetData(it, ctypes.byref(d)) == 0
        want = jit.next().data[0].asnumpy().ravel()
        np.testing.assert_array_equal(_read_nd(L, d, 8), want)
        pad = ctypes.c_int(-1)
        assert L.MXDataIterGetPadNum(it, ctypes.byref(pad)) == 0
        assert pad.value == 0
        L.MXNDArrayFree(d)
        seen += 1
    assert seen == 3
    assert L.MXDataIterBeforeFirst(it) == 0
    assert L.MXDataIterNext(it, ctypes.byref(has)) == 0 and has.value == 1
    assert L.MXDataIterFree(it) == 0


def test_kvstore_c_api():
    L = _lib()
    kv = ctypes.c_void_p()
    assert L.MXKVStoreCreate(b"local", ctypes.byref(kv)) == 0
    t = ctypes.c_char_p()
    assert L.MXKVStoreGetType(kv, ctypes.byref(t)) == 0
    assert t.value == b"local"
    r = ctypes.c_int(-1)
    assert L.MXKVStoreGetRank(kv, ctypes.byref(r)) == 0 and r.value == 0
    assert L.MXKVStoreGetGroupSize(kv, ctypes.byref(r)) == 0 and r.value == 1

    rs = np.random.RandomState(4)
    v0, v1 = rs.rand(2, 2).astype(np.float32), rs.rand(2, 2).astype(
        np.float32)
    keys = (ctypes.c_int * 1)(7)
    vals = (ctypes.c_void_p * 1)(_make_nd(L, v0))
    assert L.MXKVStoreInit(kv, 1, keys, vals) == 0, L.MXGetLastError()
    push_v = _make_nd(L, v1)
    vals2 = (ctypes.c_void_p * 1)(push_v)
    assert L.MXKVStorePush(kv, 1, keys, vals2, 0) == 0, L.MXGetLastError()
    out_v = _make_nd(L, np.zeros((2, 2), np.float32))
    vals3 = (ctypes.c_void_p * 1)(out_v)
    assert L.MXKVStorePull(kv, 1, keys, vals3, 0) == 0, L.MXGetLastError()

    jkv = mxj.kv.create("local")
    jkv.init(7, mxj.nd.array(v0))
    jkv.push(7, mxj.nd.array(v1))
    jout = mxj.nd.zeros((2, 2))
    jkv.pull(7, out=jout)
    np.testing.assert_array_equal(_read_nd(L, out_v, 4),
                                  jout.asnumpy().ravel())

    # a C-callback updater: new = local - 0.5 * recv
    calls = []
    CB = ctypes.CFUNCTYPE(None, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_void_p)

    def updater(key, recv, local, handle):
        calls.append(key)
        rb, lb = _read_nd(L, recv, 4), _read_nd(L, local, 4)
        new = lb - np.float32(0.5) * rb
        assert L.MXNDArraySyncCopyFromCPU(local, new.ctypes.data, 4) == 0
        L.MXNDArrayFree(recv)
        L.MXNDArrayFree(local)

    cb = CB(updater)
    assert L.MXKVStoreSetUpdater(kv, ctypes.cast(cb, ctypes.c_void_p),
                                 None) == 0, L.MXGetLastError()
    assert L.MXKVStorePush(kv, 1, keys, vals2, 0) == 0, L.MXGetLastError()
    assert calls == [7]
    assert L.MXKVStorePull(kv, 1, keys, vals3, 0) == 0
    jkv._set_updater(lambda k, rv, lc: lc.__setitem__(
        slice(None), lc - 0.5 * rv))
    jkv.push(7, mxj.nd.array(v1))
    jkv.pull(7, out=jout)
    np.testing.assert_array_equal(_read_nd(L, out_v, 4),
                                  jout.asnumpy().ravel())

    assert L.MXKVStoreBarrier(kv) == 0
    assert L.MXKVStoreSetBarrierBeforeExit(kv, 1) == 0
    dead = ctypes.c_int(-1)
    assert L.MXKVStoreGetNumDeadNode(kv, 0, ctypes.byref(dead), 60) == 0
    assert dead.value == 0
    assert L.MXKVStoreFree(kv) == 0


def test_recordio_c_api(tmp_path):
    L = _lib()
    path = str(tmp_path / "c.rec")
    w = ctypes.c_void_p()
    assert L.MXRecordIOWriterCreate(path.encode(), ctypes.byref(w)) == 0, \
        L.MXGetLastError()
    payloads = (b"first-record", b"second", bytes(range(256)) * 3)
    for payload in payloads:
        assert L.MXRecordIOWriterWriteRecord(w, payload, len(payload)) == 0
    pos = ctypes.c_size_t()
    assert L.MXRecordIOWriterTell(w, ctypes.byref(pos)) == 0
    assert L.MXRecordIOWriterFree(w) == 0
    assert pos.value == os.path.getsize(path)

    # the JAX package reads the port's file record for record
    jr = mxj.recordio.MXRecordIO(path, "r")
    assert [jr.read() for _ in payloads] == list(payloads)
    jr.close()
    r = ctypes.c_void_p()
    assert L.MXRecordIOReaderCreate(path.encode(), ctypes.byref(r)) == 0
    buf = ctypes.c_char_p()
    size = ctypes.c_size_t()
    for payload in payloads:
        assert L.MXRecordIOReaderReadRecord(r, ctypes.byref(buf),
                                            ctypes.byref(size)) == 0
        assert ctypes.string_at(buf, size.value) == payload
    assert L.MXRecordIOReaderReadRecord(r, ctypes.byref(buf),
                                        ctypes.byref(size)) == 0
    assert size.value == 0  # EOF
    assert L.MXRecordIOReaderFree(r) == 0


def test_kvstore_str_updater_ex():
    L = _lib()
    kv = ctypes.c_void_p()
    assert L.MXKVStoreCreate(b"local", ctypes.byref(kv)) == 0
    init_v = _make_nd(L, np.zeros((2,), np.float32))
    keys = (ctypes.c_char_p * 1)(b"weight")
    vals = (ctypes.c_void_p * 1)(init_v)
    assert L.MXKVStoreInitEx(kv, 1, keys, vals) == 0, L.MXGetLastError()
    got_keys = []
    ICB = ctypes.CFUNCTYPE(None, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p)
    SCB = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p)

    def int_updater(key, recv, local, handle):
        got_keys.append(key)
        L.MXNDArrayFree(recv)
        L.MXNDArrayFree(local)

    def str_updater(key, recv, local, handle):
        got_keys.append(key)
        buf = _read_nd(L, recv, 2)
        assert L.MXNDArraySyncCopyFromCPU(local, buf.ctypes.data, 2) == 0
        L.MXNDArrayFree(recv)
        L.MXNDArrayFree(local)

    icb, scb = ICB(int_updater), SCB(str_updater)
    assert L.MXKVStoreSetUpdaterEx(kv, ctypes.cast(icb, ctypes.c_void_p),
                                   ctypes.cast(scb, ctypes.c_void_p),
                                   None) == 0, L.MXGetLastError()
    push_v = _make_nd(L, np.array([1.5, 2.5], np.float32))
    vals2 = (ctypes.c_void_p * 1)(push_v)
    assert L.MXKVStorePushEx(kv, 1, keys, vals2, 0) == 0, L.MXGetLastError()
    assert got_keys == [b"weight"]
    out_v = _make_nd(L, np.zeros((2,), np.float32))
    vals3 = (ctypes.c_void_p * 1)(out_v)
    assert L.MXKVStorePullEx(kv, 1, keys, vals3, 0) == 0
    np.testing.assert_array_equal(_read_nd(L, out_v, 2), [1.5, 2.5])
    assert L.MXKVStoreFree(kv) == 0


def test_sparse_ndarray_c_api():
    L = _lib()
    shape = (ctypes.c_uint * 2)(4, 3)
    aux_t = (ctypes.c_int * 2)(6, 6)
    h = ctypes.c_void_p()
    assert L.MXNDArrayCreateSparseEx(2, shape, 2, 1, 0, 0, 0, 2, aux_t,
                                     None, None, ctypes.byref(h)) == 0, \
        L.MXGetLastError()
    st = ctypes.c_int(-1)
    assert L.MXNDArrayGetStorageType(h, ctypes.byref(st)) == 0
    assert st.value == 2
    assert L.MXNDArraySyncCheckFormat(h, True) == 0, L.MXGetLastError()

    dense = np.array([[0, 1, 0], [2, 0, 3], [0, 0, 0], [4, 0, 0]],
                     np.float32)
    dh = _make_nd(L, dense)
    op = ctypes.c_void_p()
    assert L.NNGetOpHandle(b"cast_storage", ctypes.byref(op)) == 0
    n_out = ctypes.c_int(0)
    outs = ctypes.POINTER(ctypes.c_void_p)()
    ins = (ctypes.c_void_p * 1)(dh)
    keys = (ctypes.c_char_p * 1)(b"stype")
    vals = (ctypes.c_char_p * 1)(b"csr")
    assert L.MXImperativeInvoke(op, 1, ins, ctypes.byref(n_out),
                                ctypes.byref(outs), 1, keys, vals) == 0, \
        L.MXGetLastError()
    csr = ctypes.c_void_p(outs[0])
    assert L.MXNDArrayGetStorageType(csr, ctypes.byref(st)) == 0
    assert st.value == 2
    assert L.MXNDArraySyncCheckFormat(csr, True) == 0, L.MXGetLastError()
    jcsr = mxj.nd.cast_storage(mxj.nd.array(dense), "csr")
    data_nd = ctypes.c_void_p()
    assert L.MXNDArrayGetDataNDArray(csr, ctypes.byref(data_nd)) == 0
    np.testing.assert_array_equal(_read_nd(L, data_nd, 4),
                                  jcsr.data.asnumpy())
    aux_nd = ctypes.c_void_p()
    assert L.MXNDArrayGetAuxNDArray(csr, 0, ctypes.byref(aux_nd)) == 0
    ndim = ctypes.c_uint()
    pdata = ctypes.POINTER(ctypes.c_uint)()
    assert L.MXNDArrayGetShape(aux_nd, ctypes.byref(ndim),
                               ctypes.byref(pdata)) == 0
    assert pdata[0] == jcsr.indptr.shape[0] == 5
    t = ctypes.c_int(-1)
    assert L.MXNDArrayGetAuxType(csr, 0, ctypes.byref(t)) == 0
    assert t.value in (4, 6)
    for hh in (h, dh, csr, data_nd, aux_nd):
        L.MXNDArrayFree(hh)


def test_ndarray_get_data_pointer():
    """The live data pointer: a write through it is seen by the array."""
    L = _lib()
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    h = _make_nd(L, x)
    ptr = ctypes.c_void_p()
    assert L.MXNDArrayGetData(h, ctypes.byref(ptr)) == 0, L.MXGetLastError()
    view = np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctypes.c_float)), shape=(6,))
    np.testing.assert_array_equal(view, x.ravel())
    view[0] = 42.0
    assert _read_nd(L, h, 6)[0] == 42.0
    L.MXNDArrayFree(h)


def test_legacy_function_api():
    L = _lib()
    n = ctypes.c_uint()
    funcs = ctypes.POINTER(ctypes.c_void_p)()
    assert L.MXListFunctions(ctypes.byref(n), ctypes.byref(funcs)) == 0
    assert n.value > 200
    f = ctypes.c_void_p()
    assert L.MXGetFunction(b"sgd_update", ctypes.byref(f)) == 0
    nu, ns, nm = ctypes.c_uint(), ctypes.c_uint(), ctypes.c_uint()
    mask = ctypes.c_int()
    assert L.MXFuncDescribe(f, ctypes.byref(nu), ctypes.byref(ns),
                            ctypes.byref(nm), ctypes.byref(mask)) == 0
    assert nu.value == 1 and nm.value == 1
    name = ctypes.c_char_p()
    desc = ctypes.c_char_p()
    na = ctypes.c_uint()
    an = ctypes.POINTER(ctypes.c_char_p)()
    at = ctypes.POINTER(ctypes.c_char_p)()
    ad = ctypes.POINTER(ctypes.c_char_p)()
    rt = ctypes.c_char_p()
    assert L.MXFuncGetInfo(f, ctypes.byref(name), ctypes.byref(desc),
                           ctypes.byref(na), ctypes.byref(an),
                           ctypes.byref(at), ctypes.byref(ad),
                           ctypes.byref(rt)) == 0
    scalar_names = [an[i].decode() for i in range(na.value)]
    assert "lr" in scalar_names
    w0 = np.random.RandomState(5).rand(4).astype(np.float32)
    g0 = np.random.RandomState(6).rand(4).astype(np.float32)
    w = _make_nd(L, w0)
    g = _make_nd(L, g0)
    scalars = (ctypes.c_float * na.value)()
    for i, s in enumerate(scalar_names):
        scalars[i] = {"lr": 0.2, "rescale_grad": 1.0, "wd": 0.0,
                      "clip_gradient": -1.0}.get(s, 0.0)
    use = (ctypes.c_void_p * 1)(g)
    mut = (ctypes.c_void_p * 1)(w)
    assert L.MXFuncInvoke(f, use, scalars, mut) == 0, L.MXGetLastError()
    jw = mxj.nd.array(w0)
    mxj.nd.sgd_update(jw, mxj.nd.array(g0), lr=0.2, out=jw)
    np.testing.assert_allclose(_read_nd(L, w, 4), jw.asnumpy(), rtol=1e-6)
    for hh in (w, g):
        L.MXNDArrayFree(hh)


def test_executor_bindx_and_monitor():
    L = _lib()
    sym = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=3,
                                name="fc")
    h = ctypes.c_void_p()
    assert L.MXSymbolCreateFromJSON(sym.tojson().encode(),
                                    ctypes.byref(h)) == 0
    rs = np.random.RandomState(0)
    vals = [rs.rand(2, 4).astype(np.float32),
            rs.rand(3, 4).astype(np.float32), np.zeros(3, np.float32)]
    args = [_make_nd(L, v) for v in vals]
    arr = (ctypes.c_void_p * 3)(*args)
    grads = (ctypes.c_void_p * 3)(None, None, None)
    reqs = (ctypes.c_uint * 3)(0, 0, 0)
    ex = ctypes.c_void_p()
    assert L.MXExecutorBindEX(h, 1, 0, 0, None, None, None, 3, arr, grads,
                              reqs, 0, None, None, ctypes.byref(ex)) == 0, \
        L.MXGetLastError()
    seen = {}
    CB = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_void_p,
                          ctypes.c_void_p)

    def monitor(nm, arr_h, _):
        seen[nm.decode()] = True
        L.MXNDArrayFree(arr_h)

    cb = CB(monitor)
    assert L.MXExecutorSetMonitorCallback(
        ex, ctypes.cast(cb, ctypes.c_void_p), None) == 0
    assert L.MXExecutorForward(ex, 0) == 0
    assert seen, "monitor callback never fired"
    n_outs = ctypes.c_uint()
    outs = ctypes.POINTER(ctypes.c_void_p)()
    assert L.MXExecutorOutputs(ex, ctypes.byref(n_outs),
                               ctypes.byref(outs)) == 0
    jsym = mxj.sym.FullyConnected(mxj.sym.Variable("data"), num_hidden=3,
                                  name="fc")
    want = jsym.bind(mxj.cpu(), [mxj.nd.array(v) for v in vals]).forward()
    assert _scaled(_read_nd(L, outs[0], 6),
                   want[0].asnumpy().ravel()) <= 1e-5
    L.MXExecutorFree(ex)
    L.MXSymbolFree(h)
    for a in args:
        L.MXNDArrayFree(a)


def test_rtc_cuda_module_c_api():
    """Without a card (and its toolkit) the NVRTC module cannot be made:
    -1, and the last error names what is missing; the legacy
    ``MXRtcCreate`` compiles the same way and fails the same way."""
    L = _lib()
    src = b'extern "C" __global__ void axpy(float a, const float* x, ' \
          b'float* y) { y[threadIdx.x] += a * x[threadIdx.x]; }'
    exports = (ctypes.c_char_p * 1)(b"axpy")
    mod = ctypes.c_void_p()
    assert L.MXRtcCudaModuleCreate(src, 0, None, 1, exports,
                                   ctypes.byref(mod)) == -1
    assert b"libnvrtc not found" in L.MXGetLastError()
    x = _make_nd(L, np.ones(4, np.float32))
    y = _make_nd(L, np.ones(4, np.float32))
    in_names = (ctypes.c_char_p * 1)(b"x")
    out_names = (ctypes.c_char_p * 1)(b"y")
    ins, outs = (ctypes.c_void_p * 1)(x), (ctypes.c_void_p * 1)(y)
    rtc = ctypes.c_void_p()
    assert L.MXRtcCreate(b"twice", 1, 1, in_names, out_names, ins, outs,
                         b"y[threadIdx.x] = 2.0f * x[threadIdx.x];",
                         ctypes.byref(rtc)) == -1
    assert b"libnvrtc not found" in L.MXGetLastError()
    for hh in (x, y):
        L.MXNDArrayFree(hh)


def test_shared_mem_c_api():
    L = _lib()
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    h = _make_nd(L, x)
    pid = ctypes.c_int()
    sid = ctypes.c_int()
    assert L.MXNDArrayGetSharedMemHandle(h, ctypes.byref(pid),
                                         ctypes.byref(sid)) == 0, \
        L.MXGetLastError()
    shape = (ctypes.c_uint * 2)(3, 4)
    h2 = ctypes.c_void_p()
    assert L.MXNDArrayCreateFromSharedMem(pid.value, sid.value, shape, 2,
                                          0, ctypes.byref(h2)) == 0, \
        L.MXGetLastError()
    np.testing.assert_array_equal(_read_nd(L, h2, 12), x.ravel())
    assert not os.path.exists(
        "/dev/shm/mxtpu_torch_%d_%d" % (pid.value, sid.value))
    for hh in (h, h2):
        L.MXNDArrayFree(hh)


def test_op_handle_rejects_nd_module_attrs():
    L = _lib()
    op = ctypes.c_void_p()
    assert L.NNGetOpHandle(b"save", ctypes.byref(op)) == -1
    assert L.NNGetOpHandle(b"cast_storage", ctypes.byref(op)) == 0


def test_custom_op_register_reports_divergence():
    L = _lib()
    assert L.MXCustomOpRegister(b"my_op", None) == -1
    msg = L.MXGetLastError().decode()
    assert "CustomOp" in msg and "Python" in msg
    assert "mxnet_tpu_torch.operator" in msg


def test_symbol_grad_matches_reference_contract():
    L = _lib()
    out = ctypes.c_void_p()
    assert L.MXSymbolGrad(None, 0, None, ctypes.byref(out)) == -1
    assert b"not implemented" in L.MXGetLastError()


@pytest.mark.parametrize("dev_type", [2, 4])
def test_device_types_without_a_card_raise(dev_type):
    """dev_type 2 is the card: with none present it raises, as the Python
    entry points do; an unknown dev_type raises too. Nothing falls back
    to the host."""
    L = _lib()
    shape = (ctypes.c_uint * 1)(3)
    h = ctypes.c_void_p()
    assert L.MXNDArrayCreateEx(shape, 1, dev_type, 0, 0, 0,
                               ctypes.byref(h)) == -1
    msg = L.MXGetLastError().decode()
    assert ("no CUDA device" in msg) if dev_type == 2 else \
        ("dev_type 4" in msg)


def test_library_is_built_from_the_port_sources():
    lib_file = _build.lib_path("mxnet")
    abi.lib()
    assert os.path.exists(lib_file)
    assert lib_file in mt.libinfo.find_lib_path()
    assert not _build._stale("mxnet")


def test_c_programs_tensor_core_knob():
    """``MXNET_CUDA_ALLOW_TENSOR_CORE=0`` turns both TF32 flags off at
    import (a C program has no Python to set them with); unset leaves
    PyTorch's defaults."""
    import subprocess
    import sys
    code = ("import mxnet_tpu_torch, torch; print(torch.backends.cudnn."
            "allow_tf32, torch.backends.cuda.matmul.allow_tf32)")
    out = {}
    for v in ("0", None):
        env = abi.driver_env()
        env.pop("MXNET_CUDA_ALLOW_TENSOR_CORE", None)
        if v is not None:
            env["MXNET_CUDA_ALLOW_TENSOR_CORE"] = v
        out[v] = subprocess.run([sys.executable, "-c", code], env=env,
                                capture_output=True, text=True,
                                check=True).stdout.split()
    assert out["0"] == ["False", "False"]
    assert out[None][0] == "True"


def test_profiler_trace_carries_kernel_launch_counts(tmp_path, monkeypatch):
    """A C program reads the wrappers' launch counts from its trace
    (``MXDumpProfile``): ``otherData.mxnet_kernel_launches``."""
    import json
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.kernels import fused_bn
    monkeypatch.setattr(rtc, "launches", 3)
    monkeypatch.setattr(fused_bn, "launches", 16)
    monkeypatch.setattr(fused_bn, "bwd_launches", 5)
    path = str(tmp_path / "trace.json")
    L = _lib()
    L.MXSetProfilerConfig.argtypes = [i_, cp]
    assert L.MXSetProfilerConfig(0, path.encode()) == 0
    assert L.MXSetProfilerState(1) == 0
    h = _make_nd(L, np.ones(4, np.float32))
    assert L.MXSetProfilerState(0) == 0, L.MXGetLastError()
    assert L.MXDumpProfile() == 0
    L.MXNDArrayFree(h)
    with open(path) as f:
        counts = json.load(f)["otherData"]["mxnet_kernel_launches"]
    assert counts == {"scale_bias_add_relu": 16,
                      "scale_bias_add_relu_backward": 5,
                      "flash_attention_fwd": 0, "flash_attention_bwd": 0,
                      "rtc": 3}
