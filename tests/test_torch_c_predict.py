"""The port's C predict API (``kernels/csrc/c_predict_api.cc`` over
``mxnet_tpu_torch/c_predict.py``) on files the JAX package exported: the
small fused-tail ResNet v1 of ``chip_smoke.py``'s rehearsal (NHWC,
[1, 1, 1, 1] blocks of [16, 32, 64, 128, 256], 32x32, batch 4, random BN
statistics), served in process at ``dev_type`` 1 and by a standalone C
driver, held against the JAX package's ``Predictor`` within 1e-4 of the
largest logit (both fp32; XLA and the port's CPU operators sum the
convolutions in different orders)."""
import ctypes

import numpy as np
import pytest

import mxnet_tpu as mj
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
from mxnet_tpu.predictor import Predictor as JaxPredictor

import torch_c_abi as abi
from torch_threads import one_torch_thread  # noqa: F401

HW, BATCH, CLASSES = 32, 4, 10
TOL = 1e-4
vp, u, i_ = ctypes.c_void_p, ctypes.c_uint, ctypes.c_int
P, cp = ctypes.POINTER, ctypes.c_char_p


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """The JAX-exported net: (symbol path, params path, json bytes,
    params bytes, one seeded batch)."""
    prefix = str(tmp_path_factory.mktemp("c_predict") / "resnet")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_FUSED_BN_ADD_RELU", "1")
        mj.layout.set_default_layout("NHWC")
        try:
            with mj.name.NameManager():
                net = jresnet.ResNetV1(jresnet.BottleneckV1, [1, 1, 1, 1],
                                       [16, 32, 64, 128, 256],
                                       classes=CLASSES)
            net.initialize(mj.init.Xavier())
            net(mj.nd.zeros((1, HW, HW, 3)))
            with mj.name.NameManager():
                net.export(prefix)
        finally:
            mj.layout.set_default_layout(None)
    rs = np.random.RandomState(0)
    params = prefix + "-0000.params"
    blob = mj.nd.load(params)
    for k, v in blob.items():
        if k.endswith(("gamma", "running_var")):
            blob[k] = mj.nd.array(rs.rand(*v.shape) + 0.5)
        elif k.endswith(("beta", "running_mean")):
            blob[k] = mj.nd.array(rs.randn(*v.shape) * 0.2)
    mj.nd.save(params, blob)
    with open(prefix + "-symbol.json", "rb") as f:
        js = f.read()
    with open(params, "rb") as f:
        pb = f.read()
    x = rs.uniform(-1, 1, (BATCH, HW, HW, 3)).astype(np.float32)
    return {"json_path": prefix + "-symbol.json", "params_path": params,
            "json": js, "params": pb, "x": x}


def _lib():
    L = abi.lib()
    L.MXPredCreate.argtypes = [cp, vp, i_, i_, i_, u, P(cp), P(u), P(u),
                               P(vp)]
    L.MXPredCreatePartialOut.argtypes = [cp, vp, i_, i_, i_, u, P(cp), P(u),
                                         P(u), u, P(cp), P(vp)]
    L.MXPredReshape.argtypes = [u, P(cp), P(u), P(u), vp, P(vp)]
    L.MXPredSetInput.argtypes = [vp, cp, vp, u]
    L.MXPredForward.argtypes = [vp]
    L.MXPredPartialForward.argtypes = [vp, i_, P(i_)]
    L.MXPredGetOutputShape.argtypes = [vp, u, P(P(u)), P(u)]
    L.MXPredGetOutput.argtypes = [vp, u, vp, u]
    L.MXPredFree.argtypes = [vp]
    L.MXNDListCreate.argtypes = [cp, i_, P(vp), P(u)]
    L.MXNDListGet.argtypes = [vp, u, P(cp), P(P(ctypes.c_float)), P(P(u)),
                              P(u)]
    L.MXNDListFree.argtypes = [vp]
    return L


def _shape_args(shape):
    keys = (ctypes.c_char_p * 1)(b"data")
    indptr = (ctypes.c_uint * 2)(0, len(shape))
    dims = (ctypes.c_uint * len(shape))(*shape)
    return keys, indptr, dims


def _create(L, model, shape, dev_type=1, outputs=()):
    keys, indptr, dims = _shape_args(shape)
    h = ctypes.c_void_p()
    if outputs:
        outs = (ctypes.c_char_p * len(outputs))(
            *[o.encode() for o in outputs])
        rc = L.MXPredCreatePartialOut(model["json"], model["params"],
                                      len(model["params"]), dev_type, 0, 1,
                                      keys, indptr, dims, len(outputs), outs,
                                      ctypes.byref(h))
    else:
        rc = L.MXPredCreate(model["json"], model["params"],
                            len(model["params"]), dev_type, 0, 1, keys,
                            indptr, dims, ctypes.byref(h))
    return rc, h


def _forward(L, h, x):
    x = np.ascontiguousarray(x, np.float32)
    assert L.MXPredSetInput(h, b"data", x.ctypes.data, x.size) == 0, \
        L.MXGetLastError()
    assert L.MXPredForward(h) == 0, L.MXGetLastError()
    shape_data = ctypes.POINTER(ctypes.c_uint)()
    ndim = ctypes.c_uint()
    assert L.MXPredGetOutputShape(h, 0, ctypes.byref(shape_data),
                                  ctypes.byref(ndim)) == 0
    shape = tuple(shape_data[i] for i in range(ndim.value))
    out = np.zeros(shape, np.float32)
    assert L.MXPredGetOutput(h, 0, out.ctypes.data, out.size) == 0, \
        L.MXGetLastError()
    return out


def _jax(model, x, symbol=None):
    sym = symbol if symbol is not None else model["json"].decode()
    p = JaxPredictor(sym, model["params"], {"data": x.shape})
    p.forward(data=x)
    return p.get_output(0).asnumpy()


def _close(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL, err
    assert np.abs(want).max() > 1e-3        # not a zero model


def test_in_process_matches_jax_predictor(model):
    L = _lib()
    rc, h = _create(L, model, model["x"].shape)
    assert rc == 0, L.MXGetLastError()
    got = _forward(L, h, model["x"])
    assert got.shape == (BATCH, CLASSES)
    _close(got, _jax(model, model["x"]))
    left = ctypes.c_int(-1)
    assert L.MXPredPartialForward(h, 0, ctypes.byref(left)) == 0
    assert left.value == 0
    assert L.MXPredFree(h) == 0


def test_partial_out_matches_jax_internal_node(model):
    L = _lib()
    internals = mj.sym.load_json(model["json"].decode()).get_internals()
    name = next(n for n in internals.list_outputs() if "pool" in n)
    rc, h = _create(L, model, model["x"].shape, outputs=[name])
    assert rc == 0, L.MXGetLastError()
    got = _forward(L, h, model["x"])
    _close(got, _jax(model, model["x"], symbol=internals[name]))
    L.MXPredFree(h)


def test_reshape_shares_the_donor(model):
    L = _lib()
    rc, h = _create(L, model, model["x"].shape)
    assert rc == 0, L.MXGetLastError()
    keys, indptr, dims = _shape_args((2, HW, HW, 3))
    h2 = ctypes.c_void_p()
    assert L.MXPredReshape(1, keys, indptr, dims, h,
                           ctypes.byref(h2)) == 0, L.MXGetLastError()
    x2 = model["x"][1:3]
    _close(_forward(L, h2, x2), _jax(model, x2))
    # the donor still serves its own shape
    _close(_forward(L, h, model["x"]), _jax(model, model["x"]))
    L.MXPredFree(h2)
    L.MXPredFree(h)


def test_ndlist_reads_the_jax_blob(model):
    L = _lib()
    h = ctypes.c_void_p()
    n = ctypes.c_uint()
    assert L.MXNDListCreate(model["params"], len(model["params"]),
                            ctypes.byref(h), ctypes.byref(n)) == 0, \
        L.MXGetLastError()
    want = mj.nd.load(model["params_path"])
    assert n.value == len(want)
    seen = {}
    for i in range(n.value):
        key = ctypes.c_char_p()
        data = ctypes.POINTER(ctypes.c_float)()
        shape = ctypes.POINTER(ctypes.c_uint)()
        ndim = ctypes.c_uint()
        assert L.MXNDListGet(h, i, ctypes.byref(key), ctypes.byref(data),
                             ctypes.byref(shape), ctypes.byref(ndim)) == 0
        shp = tuple(shape[j] for j in range(ndim.value))
        seen[key.value.decode()] = np.ctypeslib.as_array(
            data, shape=(int(np.prod(shp)),)).reshape(shp).copy()
    assert sorted(seen) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(seen[k], v.asnumpy())
    assert L.MXNDListFree(h) == 0


@pytest.mark.parametrize("dev_type", [2, 5])
def test_dev_types_without_a_card_raise(model, dev_type):
    """2 is the card (none here: it raises, nothing falls back to the
    host); an unknown dev_type raises too."""
    L = _lib()
    rc, _ = _create(L, model, model["x"].shape, dev_type=dev_type)
    assert rc == -1
    msg = L.MXGetLastError().decode()
    assert ("no CUDA device" in msg) if dev_type == 2 else \
        ("dev_type 5" in msg)


PREDICT_DRIVER_SRC = r'''
#include <stdio.h>
#include <stdlib.h>
typedef unsigned int mx_uint;
typedef void* PredictorHandle;
extern int MXPredCreate(const char*, const void*, int, int, int, mx_uint,
                        const char**, const mx_uint*, const mx_uint*,
                        PredictorHandle*);
extern int MXPredSetInput(PredictorHandle, const char*, const float*,
                          mx_uint);
extern int MXPredForward(PredictorHandle);
extern int MXPredGetOutputShape(PredictorHandle, mx_uint, mx_uint**,
                                mx_uint*);
extern int MXPredGetOutput(PredictorHandle, mx_uint, float*, mx_uint);
extern int MXPredFree(PredictorHandle);
extern const char* MXGetLastError();

static char* slurp(const char* path, long* size) {
    FILE* f = fopen(path, "rb");
    if (!f) return NULL;
    fseek(f, 0, SEEK_END); *size = ftell(f); fseek(f, 0, SEEK_SET);
    char* buf = (char*)malloc(*size + 1);
    if (fread(buf, 1, *size, f) != (size_t)*size) { fclose(f); return NULL; }
    buf[*size] = 0; fclose(f);
    return buf;
}

/* argv: symbol.json params input.f32 output.f32 n h w c */
int main(int argc, char** argv) {
    long js, ps, xs;
    char* json = slurp(argv[1], &js);
    char* params = slurp(argv[2], &ps);
    float* x = (float*)slurp(argv[3], &xs);
    if (!json || !params || !x) { printf("io error\n"); return 2; }
    mx_uint shape[4];
    for (int i = 0; i < 4; ++i) shape[i] = (mx_uint)atoi(argv[5 + i]);
    const char* keys[] = {"data"};
    mx_uint indptr[] = {0, 4};
    PredictorHandle h;
    if (MXPredCreate(json, params, (int)ps, 1, 0, 1, keys, indptr, shape,
                     &h)) {
        printf("create failed: %s\n", MXGetLastError()); return 1;
    }
    if (MXPredSetInput(h, "data", x, (mx_uint)(xs / 4)) ||
        MXPredForward(h)) {
        printf("forward failed: %s\n", MXGetLastError()); return 1;
    }
    mx_uint* oshape; mx_uint ondim;
    if (MXPredGetOutputShape(h, 0, &oshape, &ondim)) return 1;
    mx_uint n = 1;
    for (mx_uint i = 0; i < ondim; ++i) n *= oshape[i];
    float* out = (float*)malloc(n * sizeof(float));
    if (MXPredGetOutput(h, 0, out, n)) {
        printf("output failed: %s\n", MXGetLastError()); return 1;
    }
    FILE* f = fopen(argv[4], "wb");
    fwrite(out, sizeof(float), n, f);
    fclose(f);
    printf("PRED_OK %u outputs\n", n);
    MXPredFree(h);
    return 0;
}
'''


def test_standalone_c_driver(model, tmp_path):
    """A C program linked with ``_build.driver_link_flags()`` embeds the
    interpreter and serves the JAX-exported files on the host."""
    exe = abi.build_driver(PREDICT_DRIVER_SRC, tmp_path, "predict")
    xin, yout = tmp_path / "x.f32", tmp_path / "y.f32"
    model["x"].tofile(str(xin))
    p = abi.run_driver(exe, [model["json_path"], model["params_path"], xin,
                             yout] + list(model["x"].shape))
    assert p.returncode == 0, p.stdout + p.stderr
    assert "PRED_OK 40 outputs" in p.stdout, p.stdout
    got = np.fromfile(str(yout), np.float32).reshape(BATCH, CLASSES)
    _close(got, _jax(model, model["x"]))
