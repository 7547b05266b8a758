"""NDArray — the imperative tensor.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``: an NDArray wraps one
``torch.Tensor`` on its context's device. PyTorch's CUDA ops are already
asynchronous and stream-ordered, so ``asnumpy``/``wait_to_read`` are the
sync points, as in the reference. Basic indexing (ints, slices) returns
a view sharing storage, as the reference's write-through slices do;
in-place operators and ``a[key] = x`` write into the wrapped storage.
Under ``autograd.record`` indexing and the operators are recorded like
any op (``imperative.py`` holds the tape).
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, current_context, context_of
from ..ops.common import torch_dtype, numpy_dtype
from ..ops import registry as _registry
from .. import imperative as _imp
from .. import telemetry

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "concatenate", "moveaxis", "transpose", "waitall",
           "onehot_encode"]


class NDArray:
    """Multi-dimensional array on a device."""

    # _grad/_grad_req: a leaf's gradient buffer and request; _tape: the
    # output of a recorded op; _alias: (tensor, its requires-grad view)
    __slots__ = ("_data", "_ctx", "_grad", "_grad_req", "_tape", "_alias",
                 "__weakref__")

    __array_priority__ = 100.0      # beat numpy in mixed expressions

    def __init__(self, data, ctx=None):
        if not isinstance(data, torch.Tensor):
            raise MXNetError("NDArray wraps a torch.Tensor, got %s"
                             % type(data).__name__)
        self._data = data
        self._ctx = ctx if ctx is not None else context_of(data)
        self._grad = None
        self._grad_req = None
        self._tape = False
        self._alias = None
        # the live buffer ledger: charge this array's bytes to its
        # context until it is collected (a weakref.finalize; no cycle)
        if telemetry.enabled():
            telemetry.ledger_track(self, str(self._ctx),
                                   data.numel() * data.element_size(),
                                   shape=tuple(data.shape),
                                   dtype=str(data.dtype))

    def _assign(self, other):
        """Take ``other``'s value: rebind to a recorded result (it carries
        the tape), else copy into this array's storage (views of it see
        the write)."""
        if other._tape or other._data.shape != self._data.shape \
                or other._data.dtype != self._data.dtype:
            self._data = other._data
            self._tape = other._tape
        else:
            with torch.no_grad():
                self._data.copy_(other._data)

    # -- basic properties --------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """numpy dtype where numpy has one; ``torch.bfloat16`` otherwise."""
        if self._data.dtype == torch.bfloat16:
            return torch.bfloat16
        return numpy_dtype(self._data.dtype)

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def context(self):
        return self._ctx

    ctx = context

    @property
    def stype(self):
        return "default"

    @property
    def grad(self):
        return self._grad

    @property
    def T(self):
        return transpose(self)

    # -- sync points -------------------------------------------------------
    def wait_to_read(self):
        """Block until the value is computed (parity: WaitToRead)."""
        telemetry.record_host_sync("wait_to_read")
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    wait_to_write = wait_to_read

    def asnumpy(self):
        """Copy to a numpy array; synchronises. bfloat16 widens exactly to
        float32 (numpy has no bfloat16)."""
        telemetry.record_host_sync("asnumpy")
        telemetry.record_transfer(
            self._data.numel() * self._data.element_size(), direction="d2h")
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("the array is not scalar-sized")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size != 1:
            raise MXNetError("truth value of multi-element NDArray is "
                             "ambiguous")
        return bool(self.asscalar())

    def __len__(self):
        if not self.shape:
            raise MXNetError("len() of 0-d array")
        return self.shape[0]

    def __array__(self, dtype=None, copy=None):
        out = self.asnumpy()
        return out.astype(dtype) if dtype is not None else out

    # -- conversion / movement --------------------------------------------
    def astype(self, dtype, copy=True):
        dt = torch_dtype(dtype)
        if not copy and self._data.dtype == dt:
            return self
        return _invoke("Cast", [self], {"dtype": dt})

    def copy(self):
        return NDArray(self._data.detach().clone(), self._ctx)

    def copyto(self, other):
        """Copy into another NDArray (its dtype and device kept) or to a
        Context (parity: CopyFromTo)."""
        if isinstance(other, Context):
            dev = other.torch_device()
            src = self._data.detach()
            # a page-locked host source copies asynchronously on the
            # current stream (the pinned allocator keeps it until done)
            non_blocking = dev.type == "cuda" and src.device.type == "cpu" \
                and src.is_pinned()
            return NDArray(src.to(dev, copy=True, non_blocking=non_blocking),
                           other)
        if isinstance(other, NDArray):
            with torch.no_grad():
                other._data.copy_(self._data)
            return other
        raise TypeError("copyto: expected NDArray or Context")

    def as_in_context(self, ctx):
        """This array on ``ctx`` (itself when already there, else a copy)."""
        if ctx == self._ctx:
            return self
        return self.copyto(ctx)

    def detach(self):
        return NDArray(self._data.detach(), self._ctx)

    # -- autograd ----------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Allocate a zero gradient buffer and make this array a leaf."""
        grad = NDArray(torch.zeros_like(self._data.detach()), self._ctx)
        _imp.mark_variables([self], [grad], [grad_req])

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        _imp.backward([self], [out_grad], retain_graph=retain_graph,
                      train_mode=train_mode)

    # -- shape ops ---------------------------------------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = kwargs.get("shape", shape)
        return _invoke("Reshape", [self], {
            "shape": shape, "reverse": kwargs.get("reverse", False)})

    def flatten(self):
        return _invoke("Flatten", [self], {})

    def expand_dims(self, axis):
        return _invoke("expand_dims", [self], {"axis": axis})

    def squeeze(self, axis=None):
        return _invoke("squeeze", [self], {"axis": axis})

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return _invoke("transpose", [self], {"axes": axes})

    def swapaxes(self, dim1, dim2):
        return _invoke("SwapAxis", [self], {"dim1": dim1, "dim2": dim2})

    def broadcast_to(self, shape):
        return _invoke("broadcast_to", [self], {"shape": shape})

    def tile(self, reps):
        return _invoke("tile", [self], {"reps": reps})

    def slice_axis(self, axis, begin, end):
        return _invoke("slice_axis", [self], {"axis": axis, "begin": begin,
                                              "end": end})

    # -- reductions and math -----------------------------------------------
    def _reduce(self, name, axis, keepdims, exclude=False):
        return _invoke(name, [self], {"axis": axis, "keepdims": keepdims,
                                      "exclude": exclude})

    def sum(self, axis=None, keepdims=False, exclude=False, **kw):
        return self._reduce("sum", axis, keepdims, exclude)

    def mean(self, axis=None, keepdims=False, exclude=False, **kw):
        return self._reduce("mean", axis, keepdims, exclude)

    def max(self, axis=None, keepdims=False, exclude=False, **kw):
        return self._reduce("max", axis, keepdims, exclude)

    def min(self, axis=None, keepdims=False, exclude=False, **kw):
        return self._reduce("min", axis, keepdims, exclude)

    def prod(self, axis=None, keepdims=False, exclude=False, **kw):
        return self._reduce("prod", axis, keepdims, exclude)

    def argmax(self, axis=None, keepdims=False):
        return _invoke("argmax", [self], {"axis": axis, "keepdims": keepdims})

    def argmin(self, axis=None, keepdims=False):
        return _invoke("argmin", [self], {"axis": axis, "keepdims": keepdims})

    def norm(self):
        return _invoke("norm", [self], {})

    def clip(self, a_min, a_max):
        return _invoke("clip", [self], {"a_min": a_min, "a_max": a_max})

    def tostype(self, stype):
        if stype == "default":
            return self
        raise MXNetError("sparse storage is not ported (ROADMAP Queue 1 "
                         "item 6)")

    # -- arithmetic --------------------------------------------------------
    def _binary(self, other, op, scalar_op):
        if isinstance(other, NDArray):
            return _invoke(op, [self, other], {})
        if isinstance(other, numbers.Number):
            return _invoke(scalar_op, [self], {"scalar": other})
        return NotImplemented

    def _rscalar(self, other, scalar_op):
        if isinstance(other, numbers.Number):
            return _invoke(scalar_op, [self], {"scalar": other})
        return NotImplemented

    def __add__(self, other):
        return self._binary(other, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, other):
        return self._rscalar(other, "_rminus_scalar")

    def __mul__(self, other):
        return self._binary(other, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, other):
        return self._rscalar(other, "_rdiv_scalar")

    __div__ = __truediv__
    __rdiv__ = __rtruediv__

    def __mod__(self, other):
        return self._binary(other, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, other):
        return self._rscalar(other, "_rmod_scalar")

    def __pow__(self, other):
        return self._binary(other, "broadcast_power", "_power_scalar")

    def __rpow__(self, other):
        return self._rscalar(other, "_rpower_scalar")

    def __neg__(self):
        return _invoke("negative", [self], {})

    def __abs__(self):
        return _invoke("abs", [self], {})

    def __eq__(self, other):
        return self._binary(other, "broadcast_equal", "_equal_scalar")

    def __ne__(self, other):
        return self._binary(other, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, other):
        return self._binary(other, "broadcast_greater", "_greater_scalar")

    def __ge__(self, other):
        return self._binary(other, "broadcast_greater_equal",
                            "_greater_equal_scalar")

    def __lt__(self, other):
        return self._binary(other, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, other):
        return self._binary(other, "broadcast_lesser_equal",
                            "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    # in-place: the result written into this array (see _assign)
    def _inplace(self, res):
        if res is NotImplemented:
            return res
        self._assign(res)
        return self

    def __iadd__(self, other):
        return self._inplace(self.__add__(other))

    def __isub__(self, other):
        return self._inplace(self.__sub__(other))

    def __imul__(self, other):
        return self._inplace(self.__mul__(other))

    def __itruediv__(self, other):
        return self._inplace(self.__truediv__(other))

    __idiv__ = __itruediv__

    def __imod__(self, other):
        return self._inplace(self.__mod__(other))

    def __ipow__(self, other):
        return self._inplace(self.__pow__(other))

    # -- indexing ----------------------------------------------------------
    @staticmethod
    def _key(key):
        if isinstance(key, NDArray):
            return key._data.long()
        if isinstance(key, tuple):
            return tuple(k._data.long() if isinstance(k, NDArray) else k
                         for k in key)
        return key

    def __getitem__(self, key):
        """Ints and slices give a view sharing storage; NDArray or list
        keys gather (a copy). Recorded under ``autograd.record`` like an
        op."""
        if isinstance(key, (int, np.integer)) \
                and not isinstance(key, (bool, np.bool_)):
            n = self.shape[0] if self.ndim else 0
            if key < -n or key >= n:
                raise IndexError("index %d is out of bounds for axis 0 "
                                 "with size %d" % (key, n))
        key = self._key(key)
        record = _imp.should_record([self])
        if record:
            with torch.enable_grad():
                out = NDArray(_imp.tape_tensor(self)[key], self._ctx)
            out._tape = True
            return out
        return NDArray(_imp.plain_tensor(self)[key], self._ctx)

    def __setitem__(self, key, value):
        key = self._key(key)
        if isinstance(value, NDArray):
            value = value._data
        elif isinstance(value, np.ndarray):
            value = np.ascontiguousarray(value)
            if not value.flags.writeable:   # torch takes writable arrays
                value = value.copy()
            value = torch.from_numpy(value)
        with torch.no_grad():
            if isinstance(value, torch.Tensor):
                value = value.to(self._data.device, self._data.dtype)
            self._data[key] = value

    def __repr__(self):
        return "\n%s\n<NDArray %s @%s>" % (
            self.asnumpy(), "x".join(str(s) for s in self.shape), self._ctx)

    # pickle / deepcopy
    def __getstate__(self):
        return {"data": self.asnumpy(), "bf16":
                self._data.dtype == torch.bfloat16,
                "ctx": (self._ctx.device_type, self._ctx.device_id)}

    def __setstate__(self, st):
        ctx = Context(*st["ctx"])
        data = torch.from_numpy(st["data"]).to(ctx.torch_device())
        self.__init__(data.to(torch.bfloat16) if st["bf16"] else data, ctx)


# ---------------------------------------------------------------------------
# helpers and creation functions
# ---------------------------------------------------------------------------

def _invoke(op_name, inputs, kwargs, out=None):
    return _imp.invoke(_registry.get_op(op_name), inputs, kwargs, out=out)


def _device(ctx):
    ctx = ctx or current_context()
    return ctx, ctx.torch_device()


def _shape(shape):
    if isinstance(shape, numbers.Number):
        return (int(shape),)
    return tuple(shape)


def array(source_array, ctx=None, dtype=None):
    """Create an NDArray (always a copy) from any array-like. Python
    lists and float64 sources default to float32 (MXNet convention); a
    float64 numpy source keeps its precision when ``dtype`` asks for it."""
    if isinstance(source_array, NDArray):
        src = source_array._data
    elif isinstance(source_array, torch.Tensor):
        src = source_array
    else:
        a = np.asarray(source_array)
        if a.dtype == np.float64 and not isinstance(source_array,
                                                    np.ndarray):
            a = a.astype(np.float32)
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:       # torch takes writable arrays
            a = a.copy()
        src = torch.from_numpy(a)
    dt = torch_dtype(dtype)
    if dt is None:
        dt = torch.float32 if src.dtype == torch.float64 else src.dtype
    ctx, dev = _device(ctx)
    if dev.type == "cuda" and src.device.type == "cpu":
        telemetry.record_transfer(src.numel() * src.element_size())
    return NDArray(src.detach().to(dev, dt, copy=True), ctx)


def zeros(shape, ctx=None, dtype=None, **kwargs):
    ctx, dev = _device(ctx)
    return NDArray(torch.zeros(_shape(shape), dtype=torch_dtype(dtype)
                               or torch.float32, device=dev), ctx)


def ones(shape, ctx=None, dtype=None, **kwargs):
    ctx, dev = _device(ctx)
    return NDArray(torch.ones(_shape(shape), dtype=torch_dtype(dtype)
                              or torch.float32, device=dev), ctx)


def full(shape, val, ctx=None, dtype=None, **kwargs):
    ctx, dev = _device(ctx)
    return NDArray(torch.full(_shape(shape), val, dtype=torch_dtype(dtype)
                              or torch.float32, device=dev), ctx)


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    return _invoke("_arange", [], {"start": start, "stop": stop,
                                   "step": step, "repeat": repeat,
                                   "dtype": dtype or "float32",
                                   "ctx": ctx})


def concatenate(arrays, axis=0, always_copy=True):
    return _invoke("Concat", list(arrays), {"dim": axis})


def moveaxis(tensor, source, destination):
    return NDArray(torch.movedim(_imp.plain_tensor(tensor), source,
                                 destination), tensor.context)


def transpose(data, axes=()):
    return _invoke("transpose", [data], {"axes": axes})


def waitall():
    """Block until all queued device work is done (parity: waitall)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def onehot_encode(indices, out):
    """One-hot ``indices`` into ``out`` (depth ``out.shape[1]``)."""
    res = _invoke("one_hot", [indices], {"depth": out.shape[1]})
    out[:] = res
    return out
