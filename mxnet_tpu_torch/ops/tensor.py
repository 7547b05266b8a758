"""Shape-manipulation, indexing, creation and matrix-product operators.

Counterpart of ``mxnet_tpu/ops/tensor.py`` (parity: the reference's
``matrix_op.cc`` — Reshape with its special codes, transpose, slice,
Concat, tile, repeat, reverse —, ``indexing_op.cc`` — take, batch_take,
one_hot, Embedding, gather_nd —, ``slice_channel.cc``, ``pad.cc``,
``swapaxis.cc``, ``init_op.cc`` and ``dot.cc``). Index arguments are
read as integers; ``take`` and ``batch_take`` clip (or wrap) them as the
reference does, so no index leaves the tensor on the card.
"""
from __future__ import annotations

import ast

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..context import current_context
from .common import as_axis, as_tuple, torch_dtype
from .registry import register, alias


def infer_reshape(src_shape, target, reverse=False):
    """MXNet Reshape's special codes (parity: matrix_op.cc ReshapeShape):
    0 copies a dim, -1 infers one, -2 copies the rest, -3 merges the next
    two and -4 splits one into the two that follow (one may be -1)."""
    if isinstance(target, str):
        target = ast.literal_eval(target)
    target = [int(x) for x in target]
    src = list(src_shape)
    if reverse:
        src = src[::-1]
        target = target[::-1]
    out = []
    i = 0
    j = 0
    while j < len(target):
        t = target[j]
        if t > 0:
            out.append(t)
            i += 1
        elif t == 0:
            if i >= len(src):
                raise MXNetError("reshape: 0 with no corresponding src dim")
            out.append(src[i])
            i += 1
        elif t == -1:
            out.append(-1)
            i += 1
        elif t == -2:
            out.extend(src[i:])
            i = len(src)
        elif t == -3:
            if i + 1 >= len(src):
                raise MXNetError("reshape: -3 needs two src dims")
            out.append(src[i] * src[i + 1])
            i += 2
        elif t == -4:
            d1, d2 = target[j + 1], target[j + 2]
            j += 2
            cur = src[i]
            if d1 == -1:
                d1 = cur // d2
            if d2 == -1:
                d2 = cur // d1
            out.extend([d1, d2])
            i += 1
        else:
            raise MXNetError("reshape: invalid code %d" % t)
        j += 1
    if out.count(-1) > 1:
        raise MXNetError("reshape: more than one -1")
    known = int(np.prod([d for d in out if d != -1], dtype=np.int64)) \
        if out else 1
    total = int(np.prod(src_shape, dtype=np.int64))
    if -1 in out:
        out[out.index(-1)] = total // max(known, 1)
    if reverse:
        out = out[::-1]
    return tuple(out)


@register("Reshape", defaults={"shape": (), "reverse": False},
          aliases=("reshape",))
def reshape(data, shape=(), reverse=False, **ignored):
    return data.reshape(infer_reshape(data.shape, shape, reverse))


@register("Flatten", aliases=("flatten",))
def flatten(data):
    """(N, ...) -> (N, prod(...)) in the tensor's logical (row-major) order."""
    return data.reshape(data.shape[0], -1)


@register("reshape_like", nin=2)
def reshape_like(lhs, rhs):
    return lhs.reshape(rhs.shape)


@register("transpose", defaults={"axes": ()})
def transpose(data, axes=()):
    axes = as_tuple(axes)
    return data.permute(axes if axes else tuple(reversed(range(data.ndim))))


@register("expand_dims", defaults={"axis": 0})
def expand_dims(data, axis=0):
    return data.unsqueeze(int(axis))


@register("squeeze", defaults={"axis": None})
def squeeze(data, axis=None):
    axis = as_axis(axis)
    return data.squeeze() if axis is None else data.squeeze(axis)


def _parse_seq(v):
    if isinstance(v, str):
        v = ast.literal_eval(v)
    if v is None:
        return ()
    return tuple(v) if isinstance(v, (list, tuple)) else (v,)


@register("slice", defaults={"begin": (), "end": (), "step": ()},
          aliases=("crop",))
def slice_op(data, begin=(), end=(), step=()):
    """Slice with per-axis begin/end/step; None entries take the full
    range, and a negative step walks backwards (parity: matrix_op.cc
    Slice)."""
    begin, end, step = _parse_seq(begin), _parse_seq(end), _parse_seq(step)
    out = data
    for ax in range(data.ndim):
        b = begin[ax] if ax < len(begin) else None
        e = end[ax] if ax < len(end) else None
        s = step[ax] if ax < len(step) and step[ax] is not None else 1
        sl = slice(b, e, s)
        if s > 0:
            idx = [slice(None)] * data.ndim
            idx[ax] = sl
            out = out[tuple(idx)]
        else:
            keep = list(range(*sl.indices(data.shape[ax])))
            out = torch.index_select(out, ax, torch.tensor(
                keep, dtype=torch.long, device=data.device))
    return out


@register("slice_axis", defaults={"axis": 0, "begin": 0, "end": None})
def slice_axis(data, axis=0, begin=0, end=None):
    axis = int(axis) % data.ndim
    idx = [slice(None)] * data.ndim
    idx[axis] = slice(int(begin), None if end in (None, "None") else int(end))
    return data[tuple(idx)]


@register("slice_like", nin=2, arg_names=["data", "shape_like"],
          defaults={"axes": ()})
def slice_like(data, shape_like, axes=()):
    axes = as_tuple(axes) or tuple(range(data.ndim))
    idx = [slice(None)] * data.ndim
    for ax in axes:
        idx[ax % data.ndim] = slice(0, shape_like.shape[ax % data.ndim])
    return data[tuple(idx)]


@register("Concat", nin=-1, defaults={"dim": 1}, aliases=("concat",))
def concat(*args, dim=1, num_args=None):
    return torch.cat(args, dim=int(dim))


@register("stack", nin=-1, defaults={"axis": 0})
def stack(*args, axis=0, num_args=None):
    return torch.stack(args, dim=int(axis))


@register("SliceChannel", nout=-1,
          defaults={"num_outputs": 1, "axis": 1, "squeeze_axis": False},
          aliases=("split",))
def slice_channel(data, num_outputs=1, axis=1, squeeze_axis=False):
    """Split along ``axis`` into ``num_outputs`` equal parts (parity:
    slice_channel.cc)."""
    axis, n = int(axis), int(num_outputs)
    if data.shape[axis] % n:
        raise MXNetError("SliceChannel: axis %d of size %d does not split "
                         "into %d" % (axis, data.shape[axis], n))
    parts = torch.split(data, data.shape[axis] // n, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts) if len(parts) > 1 else parts[0]


@register("tile", defaults={"reps": ()})
def tile(data, reps=()):
    return torch.tile(data, as_tuple(reps))


@register("repeat", defaults={"repeats": 1, "axis": None})
def repeat(data, repeats=1, axis=None):
    return torch.repeat_interleave(data, int(repeats), dim=as_axis(axis))


@register("reverse", defaults={"axis": ()}, aliases=("flip",))
def reverse(data, axis=()):
    return torch.flip(data, as_tuple(axis))


@register("SwapAxis", defaults={"dim1": 0, "dim2": 0}, aliases=("swapaxes",))
def swapaxes(data, dim1=0, dim2=0):
    return torch.swapaxes(data, int(dim1), int(dim2))


@register("Pad", defaults={"mode": "constant", "pad_width": (),
                           "constant_value": 0.0}, aliases=("pad",))
def pad(data, mode="constant", pad_width=(), constant_value=0.0):
    """Pad a 4-D/5-D input (parity: pad.cc); ``pad_width`` holds flat
    (before, after) pairs per axis, and edge/reflect pad only the spatial
    axes, as in the reference."""
    pw = as_tuple(pad_width) or ()
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2)]
    pairs += [(0, 0)] * (data.ndim - len(pairs))
    if mode == "constant":
        flat = [p for pr in reversed(pairs) for p in pr]
        return F.pad(data, flat, value=float(constant_value))
    if mode not in ("edge", "reflect"):
        raise MXNetError("Pad: unknown mode %r" % mode)
    if any(pairs[0]) or any(pairs[1]):
        raise MXNetError("Pad: %s mode pads only the spatial axes" % mode)
    flat = [p for pr in reversed(pairs[2:]) for p in pr]
    return F.pad(data, flat, mode="replicate" if mode == "edge"
                 else "reflect")


@register("where", nin=3, arg_names=["condition", "x", "y"])
def where(condition, x, y):
    """Elementwise select; a 1-D condition over the batch selects whole
    rows (parity: control_flow_op.cc where)."""
    cond = condition.bool()
    if cond.ndim == 1 and x.ndim > 1 and cond.shape[0] == x.shape[0]:
        cond = cond.reshape((-1,) + (1,) * (x.ndim - 1))
    return torch.where(cond, x, y)


# ---------------------------------------------------------------------------
# Indexing ops (parity: indexing_op.cc)
# ---------------------------------------------------------------------------

@register("take", nin=2, arg_names=["a", "indices"],
          defaults={"axis": 0, "mode": "clip"})
def take(a, indices, axis=0, mode="clip"):
    axis = int(axis) % a.ndim
    n = a.shape[axis]
    idx = indices.long()
    idx = torch.remainder(idx, n) if mode == "wrap" else idx.clamp(0, n - 1)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


@register("batch_take", nin=2, arg_names=["a", "indices"])
def batch_take(a, indices):
    idx = indices.long().clamp(0, a.shape[1] - 1)
    return torch.gather(a, 1, idx.reshape(-1, 1)).reshape(idx.shape)


@register("one_hot", defaults={"depth": 1, "on_value": 1.0,
                               "off_value": 0.0, "dtype": "float32"},
          no_grad=True)
def one_hot(indices, depth=1, on_value=1.0, off_value=0.0, dtype="float32"):
    """An index outside [0, depth) gives an all-off row."""
    d = torch_dtype(dtype)
    hot = indices.long().unsqueeze(-1) == torch.arange(
        int(depth), device=indices.device)
    return torch.where(hot, torch.tensor(on_value, dtype=d,
                                         device=indices.device),
                       torch.tensor(off_value, dtype=d,
                                    device=indices.device))


@register("Embedding", nin=2, arg_names=["data", "weight"],
          defaults={"input_dim": 0, "output_dim": 0, "dtype": "float32",
                    "sparse_grad": False})
def embedding(data, weight, input_dim=0, output_dim=0, dtype="float32",
              sparse_grad=False):
    """Embedding lookup (parity: indexing_op.cc Embedding). A negative
    index counts from the end, as ``jnp.take`` in the JAX package does
    (``BucketSentenceIter`` pads with -1); the rest clip into range, as
    upstream MXNet's do (the JAX package gives NaN rows), so no index
    leaves the table on the card."""
    idx = data.long()
    n = weight.shape[0]
    idx = torch.clamp(torch.where(idx < 0, idx + n, idx), 0, n - 1)
    return F.embedding(idx, weight)


# the reference's sparse-gradient embedding; its gradient stays dense here,
# as ``sparse_grad=True`` does, in both packages
alias("Embedding", "_contrib_SparseEmbedding")


@register("gather_nd", nin=2, arg_names=["data", "indices"])
def gather_nd(data, indices):
    idx = indices.long()
    return data[tuple(idx[i] for i in range(idx.shape[0]))]


@register("scatter_nd", nin=2, arg_names=["data", "indices"],
          defaults={"shape": ()})
def scatter_nd(data, indices, shape=()):
    idx = indices.long()
    out = data.new_zeros(as_tuple(shape))
    return out.index_put(tuple(idx[i] for i in range(idx.shape[0])), data)


@register("_grad_add_nd", nin=2, arg_names=["data", "indices"],
          defaults={"shape": ()})
def _scatter_nd_acc(data, indices, shape=()):
    idx = indices.long()
    out = data.new_zeros(as_tuple(shape))
    return out.index_put(tuple(idx[i] for i in range(idx.shape[0])), data,
                         accumulate=True)


# ---------------------------------------------------------------------------
# Creation ops (nin=0; parity: init_op.cc). ``ctx`` is a Context (default
# the current one, gpu(0)) or, inside a graph, the evaluation's device.
# ---------------------------------------------------------------------------

def creation_device(ctx):
    """The ``torch.device`` a creation (or random) op makes its tensor on:
    a graph evaluation hands its own (``meta`` for inference), else a
    Context, its string form or None for the current context."""
    from ..context import Context
    if isinstance(ctx, torch.device):
        return ctx
    if isinstance(ctx, str):                # "cpu(0)" in a symbol's JSON
        name, _, dev_id = ctx.rstrip(")").partition("(")
        ctx = Context(name, int(dev_id or 0))
    return (ctx or current_context()).torch_device()


def _creation(shape, dtype, ctx):
    return (as_tuple(shape) or (), torch_dtype(dtype) or torch.float32,
            creation_device(ctx))


@register("_zeros", nin=0, defaults={"shape": (), "dtype": "float32"},
          no_grad=True)
def _zeros(shape=(), dtype="float32", ctx=None):
    shape, dtype, dev = _creation(shape, dtype, ctx)
    return torch.zeros(shape, dtype=dtype, device=dev)


@register("_ones", nin=0, defaults={"shape": (), "dtype": "float32"},
          no_grad=True)
def _ones(shape=(), dtype="float32", ctx=None):
    shape, dtype, dev = _creation(shape, dtype, ctx)
    return torch.ones(shape, dtype=dtype, device=dev)


@register("_full", nin=0, defaults={"shape": (), "dtype": "float32",
                                    "value": 0.0}, no_grad=True)
def _full(shape=(), dtype="float32", value=0.0, ctx=None):
    shape, dtype, dev = _creation(shape, dtype, ctx)
    return torch.full(shape, value, dtype=dtype, device=dev)


@register("_arange", nin=0,
          defaults={"start": 0, "stop": None, "step": 1.0, "repeat": 1,
                    "dtype": "float32"}, no_grad=True)
def _arange(start=0, stop=None, step=1.0, repeat=1, dtype="float32",
            ctx=None, infer_range=False):
    _, dt, dev = _creation((), dtype, ctx)
    if stop in (None, "None"):
        start, stop = 0, start
    # the values numpy (and jnp.arange) give, then cast
    out = torch.from_numpy(np.arange(start, stop, step)).to(dev, dt)
    if int(repeat) > 1:
        out = torch.repeat_interleave(out, int(repeat))
    return out


@register("_eye", nin=0, defaults={"N": 0, "M": 0, "k": 0,
                                   "dtype": "float32"}, no_grad=True)
def _eye(N=0, M=0, k=0, dtype="float32", ctx=None):
    _, dt, dev = _creation((), dtype, ctx)
    n, m = int(N), int(M) or int(N)
    return torch.from_numpy(np.eye(n, m, int(k))).to(dev, dt)


# ---------------------------------------------------------------------------
# Matrix products (parity: dot.cc)
# ---------------------------------------------------------------------------

@register("dot", nin=2, defaults={"transpose_a": False,
                                  "transpose_b": False})
def dot(lhs, rhs, transpose_a=False, transpose_b=False, forward_stype=None):
    """Contracts the last axis of lhs with the first axis of rhs; two
    vectors give shape (1,)."""
    a = lhs.permute(*reversed(range(lhs.ndim))) if transpose_a else lhs
    b = rhs.permute(*reversed(range(rhs.ndim))) if transpose_b else rhs
    if a.ndim == 1 and b.ndim == 1:
        return torch.dot(a, b).reshape((1,))
    return torch.tensordot(a, b, dims=1)


@register("batch_dot", nin=2, defaults={"transpose_a": False,
                                        "transpose_b": False})
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False,
              forward_stype=None):
    a = lhs.transpose(-1, -2) if transpose_a else lhs
    b = rhs.transpose(-1, -2) if transpose_b else rhs
    return torch.matmul(a, b)
