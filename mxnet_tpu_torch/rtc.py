"""Runtime kernel compilation: CUDA C compiled by NVRTC, launched on the card.

Counterpart of ``mxnet_tpu/rtc.py`` (K4 of the TPU kernels: its
``PallasModule`` compiles a user's Pallas source at run time). The port
has upstream MXNet's API (``python/mxnet/rtc.py`` over
``src/common/rtc.cc``): :class:`CudaModule` compiles CUDA C source with
NVRTC when it is constructed, :meth:`CudaModule.get_kernel` takes a
kernel's C signature, and :meth:`CudaKernel.launch` runs it on NDArrays
with the grid, block and dynamic shared memory given.

* Compiling: ``libnvrtc`` from ``$CUDA_HOME/lib64``, else
  ``/usr/local/cuda/lib64`` (through ``ctypes``), straight to a CUBIN for
  ``sm_90a`` (``nvrtcGetCUBIN``: no PTX JIT at load), with the toolkit's
  ``include/`` on the path and the user's ``options`` after it. Exports
  are registered as name expressions and looked up by their lowered
  names, so a C++ (mangled) or templated kernel is exported by the
  expression that names it. A compile error raises ``MXNetError`` with
  NVRTC's log.
* Loading: ``cuModuleLoadData``/``cuModuleGetFunction`` from
  ``libcuda.so.1``, once per device, with that device's primary context
  pushed on the calling thread (a thread PyTorch never touched has no
  current context).
* Launching: ``cuLaunchKernel`` on ``torch.cuda.current_stream(device)``,
  so the launch is ordered with the executor's operators. An NDArray
  passes its tensor's ``data_ptr()`` and must have the declared type, lie
  on the launch's device and be contiguous; a scalar passes by value in
  its declared C type (``__half`` as its 16 bits). The kernel writes
  device memory in place: nothing is written back. Each launch adds one
  to :data:`launches`.

There is no CPU route and no fallback: a CPU ``ctx`` raises (naming
``mx.gpu``), and so does a missing ``libnvrtc`` or ``libcuda``, naming the
paths searched. ``PallasModule``/``PallasKernel`` take JAX source and
raise, naming :class:`CudaModule`.

The plain versions of the kernels a caller compiles are the caller's:
``chip_smoke.py`` holds each against its PyTorch version on the card.
"""
from __future__ import annotations

import ctypes
import glob
import numbers
import os
import re
import threading

import numpy as np

from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["CudaModule", "CudaKernel", "PallasModule", "PallasKernel",
           "launches", "parse_signature", "nvrtc_search_dirs"]

# kernel launches so far; callers reset it to 0
launches = 0

# the JAX package's table (mxnet_tpu/rtc.py:31-34): C type -> numpy dtype
_DTYPES = {"float": "float32", "double": "float64", "__half": "float16",
           "half": "float16", "uint8_t": "uint8", "int": "int32",
           "int32_t": "int32", "int8_t": "int8", "char": "int8",
           "int64_t": "int64"}

# a scalar argument's ctypes type by numpy dtype (float16 as its bits)
_SCALAR_CTYPES = {"float32": ctypes.c_float, "float64": ctypes.c_double,
                  "float16": ctypes.c_uint16, "uint8": ctypes.c_uint8,
                  "int32": ctypes.c_int32, "int8": ctypes.c_int8,
                  "int64": ctypes.c_int64}

_ARCH = "sm_90a"
_SIG = re.compile(r"""^\s*(const)?\s*([\w_]+)\s*(\*)?\s*([\w_]+)?\s*$""")
# above this a kernel must opt in to dynamic shared memory
_DEFAULT_SMEM = 48 * 1024
_CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8

_libs = {}
_lib_lock = threading.Lock()


def parse_signature(signature):
    """``[(is_pointer, is_const, numpy dtype name), ...]`` of a C parameter
    list, by the JAX package's rules (``mxnet_tpu/rtc.py:73-90``): each
    parameter is ``(const) type (*) (name)`` with a type of the table."""
    out = []
    for arg in signature.split(","):
        match = _SIG.match(arg)
        if not match or match.groups()[1] == "const":
            raise MXNetError(
                "Invalid function prototype \"%s\". Must be in the "
                "form of \"(const) type (*) (name)\"" % arg)
        is_const, dtype, is_pointer, _ = match.groups()
        if dtype not in _DTYPES:
            raise MXNetError("Unsupported kernel argument type %s" % arg)
        out.append((bool(is_pointer), bool(is_const), _DTYPES[dtype]))
    return out


def _cuda_home():
    return os.environ.get("CUDA_HOME") or "/usr/local/cuda"


def nvrtc_search_dirs():
    """Where ``libnvrtc`` is looked for: ``$CUDA_HOME/lib64``, then
    ``/usr/local/cuda/lib64``."""
    dirs = []
    if os.environ.get("CUDA_HOME"):
        dirs.append(os.path.join(os.environ["CUDA_HOME"], "lib64"))
    dirs.append("/usr/local/cuda/lib64")
    return dirs


def _nvrtc():
    with _lib_lock:
        if "nvrtc" in _libs:
            return _libs["nvrtc"]
        dirs = nvrtc_search_dirs()
        for d in dirs:
            cands = sorted(glob.glob(os.path.join(d, "libnvrtc.so*")))
            if not cands:
                continue
            # NVRTC opens its builtins by soname at compile time: load
            # them from the same directory first
            for b in sorted(glob.glob(os.path.join(
                    d, "libnvrtc-builtins.so*"))):
                ctypes.CDLL(b, mode=ctypes.RTLD_GLOBAL)
                break
            lib = ctypes.CDLL(cands[0])
            _bind_nvrtc(lib)
            _libs["nvrtc"] = lib
            return lib
        raise MXNetError("libnvrtc not found (looked for libnvrtc.so* in %s):"
                         " mx.rtc compiles CUDA C with NVRTC"
                         % ", ".join(dirs))


def _bind_nvrtc(lib):
    vp, cp, i, sz = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, \
        ctypes.c_size_t
    P = ctypes.POINTER
    lib.nvrtcGetErrorString.restype = cp
    lib.nvrtcGetErrorString.argtypes = [i]
    lib.nvrtcCreateProgram.argtypes = [P(vp), cp, cp, i, P(cp), P(cp)]
    lib.nvrtcAddNameExpression.argtypes = [vp, cp]
    lib.nvrtcCompileProgram.argtypes = [vp, i, P(cp)]
    lib.nvrtcGetProgramLogSize.argtypes = [vp, P(sz)]
    lib.nvrtcGetProgramLog.argtypes = [vp, cp]
    lib.nvrtcGetCUBINSize.argtypes = [vp, P(sz)]
    lib.nvrtcGetCUBIN.argtypes = [vp, cp]
    lib.nvrtcGetLoweredName.argtypes = [vp, cp, P(cp)]
    lib.nvrtcDestroyProgram.argtypes = [P(vp)]


def _cuda():
    with _lib_lock:
        if "cuda" in _libs:
            return _libs["cuda"]
        try:
            lib = ctypes.CDLL("libcuda.so.1")
        except OSError as e:
            raise MXNetError("libcuda.so.1 not found on the loader's search "
                             "path (ldconfig, LD_LIBRARY_PATH): mx.rtc loads "
                             "and launches its kernels through the CUDA "
                             "driver (%s)" % e)
        vp, i, u, cp = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, \
            ctypes.c_char_p
        P = ctypes.POINTER
        lib.cuInit.argtypes = [u]
        lib.cuDeviceGet.argtypes = [P(i), i]
        lib.cuDevicePrimaryCtxRetain.argtypes = [P(vp), i]
        lib.cuCtxPushCurrent_v2.argtypes = [vp]
        lib.cuCtxPopCurrent_v2.argtypes = [P(vp)]
        lib.cuModuleLoadData.argtypes = [P(vp), cp]
        lib.cuModuleGetFunction.argtypes = [P(vp), vp, cp]
        lib.cuFuncSetAttribute.argtypes = [vp, i, i]
        lib.cuLaunchKernel.argtypes = [vp, u, u, u, u, u, u, u, vp, P(vp),
                                       P(vp)]
        lib.cuGetErrorString.argtypes = [i, P(cp)]
        _check(lib, lib.cuInit(0), "cuInit")
        _libs["cuda"] = lib
        return lib


def _check(lib, res, what):
    if res != 0:
        msg = ctypes.c_char_p()
        lib.cuGetErrorString(res, ctypes.byref(msg))
        raise MXNetError("%s failed: CUDA driver error %d (%s)"
                         % (what, res, (msg.value or b"?").decode()))


class _PrimaryContext:
    """The device's primary context (PyTorch's) current on this thread
    for the duration of the block."""

    _retained = {}

    def __init__(self, lib, ordinal):
        self.lib = lib
        ctx = self._retained.get(ordinal)
        if ctx is None:
            dev = ctypes.c_int()
            _check(lib, lib.cuDeviceGet(ctypes.byref(dev), ordinal),
                   "cuDeviceGet")
            ctx = ctypes.c_void_p()
            _check(lib, lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx),
                                                     dev.value),
                   "cuDevicePrimaryCtxRetain")
            self._retained[ordinal] = ctx
        self.ctx = ctx

    def __enter__(self):
        _check(self.lib, self.lib.cuCtxPushCurrent_v2(self.ctx),
               "cuCtxPushCurrent")
        return self

    def __exit__(self, *exc):
        popped = ctypes.c_void_p()
        self.lib.cuCtxPopCurrent_v2(ctypes.byref(popped))


def compile_cubin(source, options=(), name_expressions=()):
    """Compile CUDA C ``source`` with NVRTC to a CUBIN for ``sm_90a``.
    Returns ``(cubin bytes, {name expression: lowered name}, log)``;
    raises ``MXNetError`` with NVRTC's log when the compile fails."""
    lib = _nvrtc()
    prog = ctypes.c_void_p()
    res = lib.nvrtcCreateProgram(ctypes.byref(prog), source.encode(),
                                 b"mx_rtc.cu", 0, None, None)
    if res != 0:
        raise MXNetError("nvrtcCreateProgram: %s"
                         % lib.nvrtcGetErrorString(res).decode())
    try:
        for expr in name_expressions:
            res = lib.nvrtcAddNameExpression(prog, expr.encode())
            if res != 0:
                raise MXNetError("nvrtcAddNameExpression(%r): %s" % (
                    expr, lib.nvrtcGetErrorString(res).decode()))
        opts = ["--gpu-architecture=" + _ARCH]
        inc = os.path.join(_cuda_home(), "include")
        if os.path.isdir(inc):
            opts.append("--include-path=" + inc)
        opts += list(options)
        arr = (ctypes.c_char_p * len(opts))(*[o.encode() for o in opts])
        res = lib.nvrtcCompileProgram(prog, len(opts), arr)
        size = ctypes.c_size_t()
        lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
        buf = ctypes.create_string_buffer(size.value + 1)
        lib.nvrtcGetProgramLog(prog, buf)
        log = buf.value.decode(errors="replace")
        if res != 0:
            raise MXNetError("NVRTC could not compile the module (%s):\n%s"
                             % (lib.nvrtcGetErrorString(res).decode(), log))
        lowered = {}
        for expr in name_expressions:
            out = ctypes.c_char_p()
            res = lib.nvrtcGetLoweredName(prog, expr.encode(),
                                          ctypes.byref(out))
            if res != 0:
                raise MXNetError("nvrtcGetLoweredName(%r): %s" % (
                    expr, lib.nvrtcGetErrorString(res).decode()))
            lowered[expr] = out.value.decode()
        lib.nvrtcGetCUBINSize(prog, ctypes.byref(size))
        cubin = ctypes.create_string_buffer(size.value)
        res = lib.nvrtcGetCUBIN(prog, cubin)
        if res != 0:
            raise MXNetError("nvrtcGetCUBIN: %s"
                             % lib.nvrtcGetErrorString(res).decode())
        return cubin.raw, lowered, log
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


class CudaModule:
    """CUDA C source compiled by NVRTC at construction (parity:
    ``mx.rtc.CudaModule``).

    Parameters
    ----------
    source : str — the CUDA C source
    options : tuple of str — NVRTC options, after the port's
        ``--gpu-architecture=sm_90a`` and the toolkit's include path
    exports : tuple of str — the name expressions of the kernels to
        export: a plain name for an ``extern "C"`` or C++ kernel,
        ``"name<T>"`` for a template instance

    Example::

        source = r'''
        extern "C" __global__ void axpy(const float *x, float *y,
                                        float alpha) {
            int i = threadIdx.x + blockIdx.x * blockDim.x;
            y[i] += alpha * x[i];
        }
        '''
        module = mx.rtc.CudaModule(source)
        k = module.get_kernel("axpy", "const float *x, float *y, float alpha")
        k.launch([x, y, 3.0], mx.gpu(0), (1, 1, 1), (10, 1, 1))
    """

    def __init__(self, source, options=(), exports=()):
        if isinstance(options, str):
            options = (options,)
        if isinstance(exports, str):
            exports = (exports,)
        self._exports = list(exports)
        self._cubin, self._lowered, self.log = compile_cubin(
            source, tuple(options), self._exports)
        self._modules = {}          # device ordinal -> CUmodule
        self._lock = threading.Lock()

    def get_kernel(self, name, signature):
        """A launchable kernel: ``name`` is an export (its lowered name is
        looked up) or, with no such export, the symbol itself (an
        ``extern "C"`` kernel); ``signature`` is its C parameter list."""
        symbol = self._lowered.get(name, name)
        return CudaKernel(self, name, symbol, parse_signature(signature))

    def _function(self, ordinal, symbol):
        lib = _cuda()
        with self._lock, _PrimaryContext(lib, ordinal):
            mod = self._modules.get(ordinal)
            if mod is None:
                mod = ctypes.c_void_p()
                _check(lib, lib.cuModuleLoadData(ctypes.byref(mod),
                                                 self._cubin),
                       "cuModuleLoadData")
                self._modules[ordinal] = mod
            fn = ctypes.c_void_p()
            _check(lib, lib.cuModuleGetFunction(ctypes.byref(fn), mod,
                                                symbol.encode()),
                   "cuModuleGetFunction(%s)" % symbol)
            return fn


class CudaKernel:
    """A kernel of a :class:`CudaModule` (parity: ``mx.rtc.CudaKernel``)."""

    def __init__(self, module, name, symbol, params):
        self._module = module
        self._name = name
        self._symbol = symbol
        self._params = params
        self._fns = {}              # device ordinal -> CUfunction

    def _marshal(self, args, device):
        if len(args) != len(self._params):
            raise MXNetError("kernel %s expects %d arguments, got %d"
                             % (self._name, len(self._params), len(args)))
        keep = []
        for i, (arg, (is_ptr, _, dtype)) in enumerate(zip(args,
                                                          self._params)):
            if is_ptr:
                if not isinstance(arg, NDArray):
                    raise MXNetError("argument %d of kernel %s must be an "
                                     "NDArray" % (i, self._name))
                t = arg._data
                try:
                    same = np.dtype(arg.dtype) == np.dtype(dtype)
                except TypeError:       # bfloat16 has no C type here
                    same = False
                if not same:
                    raise MXNetError(
                        "argument %d of kernel %s is expected to be an "
                        "NDArray of %s, got %s"
                        % (i, self._name, dtype, arg.dtype))
                if t.device != device:
                    raise MXNetError("argument %d of kernel %s lies on %s, "
                                     "the launch is on %s"
                                     % (i, self._name, t.device, device))
                if not t.is_contiguous():
                    raise MXNetError("argument %d of kernel %s is not "
                                     "contiguous" % (i, self._name))
                keep.append(ctypes.c_void_p(t.data_ptr()))
            else:
                if isinstance(arg, NDArray) or not isinstance(
                        arg, (numbers.Number, np.generic)):
                    raise MXNetError("argument %d of kernel %s must be a "
                                     "number (%s)" % (i, self._name, dtype))
                if dtype == "float16":
                    keep.append(ctypes.c_uint16(
                        int(np.float16(arg).view(np.uint16))))
                else:
                    keep.append(_SCALAR_CTYPES[dtype](
                        np.dtype(dtype).type(arg).item()))
        return keep

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch on ``ctx`` (an ``mx.gpu``) with ``grid_dims`` and
        ``block_dims`` (3-tuples) and ``shared_mem`` bytes of dynamic shared
        memory, on the device's current PyTorch stream."""
        global launches
        import torch
        if ctx.device_type != "gpu":
            raise MXNetError("CUDA kernel %s can only be launched on a "
                             "gpu context (mx.gpu(i)), got %s"
                             % (self._name, ctx))
        device = ctx.torch_device()
        grid = tuple(int(g) for g in grid_dims)
        block = tuple(int(b) for b in block_dims)
        if len(grid) != 3 or len(block) != 3:
            raise MXNetError("grid_dims and block_dims are 3-tuples")
        keep = self._marshal(args, device)
        ordinal = device.index or 0
        stream = torch.cuda.current_stream(device).cuda_stream
        lib = _cuda()
        fn = self._fns.get(ordinal)
        if fn is None:
            fn = self._fns[ordinal] = self._module._function(ordinal,
                                                             self._symbol)
        params = (ctypes.c_void_p * len(keep))(
            *[ctypes.addressof(v) for v in keep])
        with _PrimaryContext(lib, ordinal):
            if shared_mem > _DEFAULT_SMEM:
                _check(lib, lib.cuFuncSetAttribute(
                    fn, _CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES,
                    int(shared_mem)), "cuFuncSetAttribute")
            _check(lib, lib.cuLaunchKernel(
                fn, grid[0], grid[1], grid[2], block[0], block[1], block[2],
                int(shared_mem), ctypes.c_void_p(stream), params, None),
                "cuLaunchKernel(%s)" % self._name)
        launches += 1


class PallasModule:
    """The JAX package's runtime-compiled Pallas module: the port has no
    JAX, so this raises. Use :class:`CudaModule` with CUDA C source."""

    def __init__(self, *args, **kwargs):
        raise MXNetError("mx.rtc.PallasModule compiles JAX/Pallas source, "
                         "which the PyTorch port does not run; write the "
                         "kernel in CUDA C and use mx.rtc.CudaModule")


class PallasKernel(PallasModule):
    """See :class:`PallasModule`."""
