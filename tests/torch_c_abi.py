"""Helpers of the tests of the port's C ABI (``kernels/_build/libmxnet.so``).

Imports no JAX, so both the CPU tests and the card's tests
(``tests/test_torch_gpu.py``) use it: the library loaded in process with
the argument types set, standalone C drivers compiled with
``_build.driver_link_flags()``, and the environment such a driver needs
(its embedded interpreter sees the repo and this interpreter's
site-packages through ``PYTHONPATH``).
"""
import ctypes
import os
import shutil
import site
import subprocess

from mxnet_tpu_torch.kernels import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lib():
    """The port's C library, built at first use, with ``MXGetLastError``
    returning bytes."""
    L = _build.load("mxnet")
    L.MXGetLastError.restype = ctypes.c_char_p
    return L


def driver_env(**extra):
    """The environment of a standalone driver: the repo and this
    interpreter's site-packages on ``PYTHONPATH``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + site.getsitepackages()
        + [p for p in [env.get("PYTHONPATH")] if p])
    env.update(extra)
    return env


def build_driver(src, tmp_path, name, cxx=False, include=()):
    """Compile driver source ``src`` (C, or C++ with ``cxx``) into
    ``tmp_path/name`` linked against the port's library and libpython."""
    _build.ensure_built("mxnet")
    path = os.path.join(str(tmp_path), name + (".cpp" if cxx else ".c"))
    with open(path, "w") as f:
        f.write(src)
    exe = os.path.join(str(tmp_path), name)
    cmd = [_build.cxx_path(), "-std=c++17"] if cxx else \
        [shutil.which("cc") or shutil.which("gcc") or "cc"]
    for inc in include:
        cmd += ["-I", inc]
    subprocess.run(cmd + ["-O1", path, "-o", exe]
                   + _build.driver_link_flags(), check=True)
    return exe


def run_driver(exe, args, timeout=600, **env):
    return subprocess.run([exe] + [str(a) for a in args],
                          capture_output=True, text=True, timeout=timeout,
                          env=driver_env(**env))


def lenet_symbol(mx, path):
    """The LeNet of ``tests/test_c_api.py`` built with package ``mx`` and
    saved to ``path``."""
    data = mx.sym.Variable("data")
    net = mx.sym.Convolution(data, kernel=(3, 3), num_filter=8, pad=(1, 1),
                             name="conv1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = mx.sym.Flatten(net)
    net = mx.sym.FullyConnected(net, num_hidden=16, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=2, name="fc2")
    net = mx.sym.SoftmaxOutput(net, mx.sym.Variable("softmax_label"),
                               name="softmax", normalization="batch")
    net.save(path)
    return path


# the cpp-package-style LeNet training driver of tests/test_c_api.py over
# the general C API; argv[2] is the dev_type (1 host, 2 card)
LENET_DRIVER_SRC = r'''
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
typedef unsigned int mx_uint;
typedef void* NDArrayHandle;
typedef void* SymbolHandle;
typedef void* ExecutorHandle;
typedef void* AtomicSymbolCreator;
extern const char* MXGetLastError();
extern int MXNDArrayCreateEx(const mx_uint*, mx_uint, int, int, int, int,
                             NDArrayHandle*);
extern int MXNDArraySyncCopyFromCPU(NDArrayHandle, const void*, size_t);
extern int MXNDArraySyncCopyToCPU(NDArrayHandle, void*, size_t);
extern int MXNDArrayWaitAll();
extern int NNGetOpHandle(const char*, AtomicSymbolCreator*);
extern int MXImperativeInvoke(AtomicSymbolCreator, int, NDArrayHandle*,
                              int*, NDArrayHandle**, int, const char**,
                              const char**);
extern int MXSymbolCreateFromFile(const char*, SymbolHandle*);
extern int MXSymbolListArguments(SymbolHandle, mx_uint*, const char***);
extern int MXSymbolInferShape(SymbolHandle, mx_uint, const char**,
                              const mx_uint*, const mx_uint*, mx_uint*,
                              const mx_uint**, const mx_uint***, mx_uint*,
                              const mx_uint**, const mx_uint***, mx_uint*,
                              const mx_uint**, const mx_uint***, int*);
extern int MXExecutorBind(SymbolHandle, int, int, mx_uint, NDArrayHandle*,
                          NDArrayHandle*, mx_uint*, mx_uint,
                          NDArrayHandle*, ExecutorHandle*);
extern int MXExecutorForward(ExecutorHandle, int);
extern int MXExecutorBackward(ExecutorHandle, mx_uint, NDArrayHandle*);
extern int MXExecutorOutputs(ExecutorHandle, mx_uint*, NDArrayHandle**);

#define CHECK(x) do { if ((x) != 0) { \
    printf("FAIL %s: %s\n", #x, MXGetLastError()); exit(1); } } while (0)

#define B 32
static unsigned int seed = 7;
static float frand() { /* deterministic LCG in [0,1) */
    seed = seed * 1103515245u + 12345u;
    return (float)((seed >> 8) & 0xffffff) / (float)0x1000000;
}

/* synthetic separable task: class 1 iff left half brighter than right */
static void make_batch(float* x, float* y) {
    for (int b = 0; b < B; ++b) {
        int label = (b % 2);
        for (int i = 0; i < 64; ++i) {
            int col = i % 8;
            float base = frand() * 0.5f;
            if (label == 1 && col < 4) base += 0.8f;
            if (label == 0 && col >= 4) base += 0.8f;
            x[b * 64 + i] = base;
        }
        y[b] = (float)label;
    }
}

int main(int argc, char** argv) {
    int dev = argc > 2 ? atoi(argv[2]) : 1;
    SymbolHandle sym;
    CHECK(MXSymbolCreateFromFile(argv[1], &sym));

    mx_uint n_args; const char** arg_names;
    CHECK(MXSymbolListArguments(sym, &n_args, &arg_names));

    const char* keys[] = {"data", "softmax_label"};
    mx_uint indptr[] = {0, 4, 5};
    mx_uint sdata[] = {B, 1, 8, 8, B};
    mx_uint in_size, out_size, aux_size;
    const mx_uint *in_ndim, *out_ndim, *aux_ndim;
    const mx_uint **in_shapes, **out_shapes, **aux_shapes;
    int complete;
    CHECK(MXSymbolInferShape(sym, 2, keys, indptr, sdata, &in_size, &in_ndim,
                             &in_shapes, &out_size, &out_ndim, &out_shapes,
                             &aux_size, &aux_ndim, &aux_shapes, &complete));
    if (!complete || in_size != n_args) { printf("FAIL infer\n"); return 1; }

    /* copies of the names and shapes: the returned pointers are
       thread-local and clobbered by later API calls */
    NDArrayHandle args[64], grads[64];
    mx_uint reqs[64];
    int data_idx = -1, label_idx = -1;
    char names[64][64];
    for (mx_uint i = 0; i < n_args; ++i)
        snprintf(names[i], sizeof(names[i]), "%s", arg_names[i]);
    mx_uint ndims[64], shps[64][8];
    for (mx_uint i = 0; i < n_args; ++i) {
        ndims[i] = in_ndim[i];
        for (mx_uint j = 0; j < in_ndim[i]; ++j) shps[i][j] = in_shapes[i][j];
    }
    for (mx_uint i = 0; i < n_args; ++i) {
        long n = 1;
        for (mx_uint j = 0; j < ndims[i]; ++j) n *= shps[i][j];
        CHECK(MXNDArrayCreateEx(shps[i], ndims[i], dev, 0, 0, 0, &args[i]));
        if (strcmp(names[i], "data") == 0) data_idx = (int)i;
        if (strcmp(names[i], "softmax_label") == 0) label_idx = (int)i;
        int is_param = strcmp(names[i], "data") != 0 &&
                       strcmp(names[i], "softmax_label") != 0;
        reqs[i] = is_param ? 1 : 0;
        if (is_param) {
            CHECK(MXNDArrayCreateEx(shps[i], ndims[i], dev, 0, 0, 0,
                                    &grads[i]));
            float* w = (float*)malloc(n * sizeof(float));
            for (long k = 0; k < n; ++k) w[k] = (frand() - 0.5f) * 0.35f;
            CHECK(MXNDArraySyncCopyFromCPU(args[i], w, (size_t)n));
            free(w);
        } else {
            grads[i] = NULL;
        }
    }
    if (data_idx < 0 || label_idx < 0) { printf("FAIL names\n"); return 1; }

    ExecutorHandle ex;
    CHECK(MXExecutorBind(sym, dev, 0, n_args, args, grads, reqs, 0, NULL,
                         &ex));

    AtomicSymbolCreator sgd;
    CHECK(NNGetOpHandle("sgd_update", &sgd));
    const char* pk[] = {"lr"};
    const char* pv[] = {"0.2"};

    float x[B * 64], y[B];
    for (int step = 0; step < 60; ++step) {
        make_batch(x, y);
        CHECK(MXNDArraySyncCopyFromCPU(args[data_idx], x, B * 64));
        CHECK(MXNDArraySyncCopyFromCPU(args[label_idx], y, B));
        CHECK(MXExecutorForward(ex, 1));
        CHECK(MXExecutorBackward(ex, 0, NULL));
        for (mx_uint i = 0; i < n_args; ++i) {
            if (grads[i] == NULL) continue;
            NDArrayHandle ins[2]; ins[0] = args[i]; ins[1] = grads[i];
            NDArrayHandle* outs = &args[i];  /* in-place update */
            int n_out = 1;
            CHECK(MXImperativeInvoke(sgd, 2, ins, &n_out, &outs, 1, pk, pv));
        }
    }
    CHECK(MXNDArrayWaitAll());

    make_batch(x, y);
    CHECK(MXNDArraySyncCopyFromCPU(args[data_idx], x, B * 64));
    CHECK(MXExecutorForward(ex, 0));
    mx_uint n_outs; NDArrayHandle* outs;
    CHECK(MXExecutorOutputs(ex, &n_outs, &outs));
    float prob[B * 2];
    CHECK(MXNDArraySyncCopyToCPU(outs[0], prob, B * 2));
    int correct = 0;
    for (int b = 0; b < B; ++b) {
        int pred = prob[b * 2 + 1] > prob[b * 2] ? 1 : 0;
        if (pred == (int)y[b]) correct++;
    }
    printf("TRAIN_OK acc=%.4f\n", (float)correct / B);
    return 0;
}
'''
