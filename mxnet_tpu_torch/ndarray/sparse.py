"""Sparse NDArrays: the ``row_sparse`` and ``csr`` storage types.

Counterpart of ``mxnet_tpu/ndarray/sparse.py`` (parity: reference
``python/mxnet/ndarray/sparse.py``). A sparse array keeps its compressed
form as tensors on its context's device: ``(data, indices)`` for
row_sparse, ``(data, indices, indptr)`` for csr, with int32 indices as
the JAX package's arrays have them. Compute runs on that form with
PyTorch's gathers and scatters (``index_select``, ``index_add``,
``torch.unique``, ``searchsorted``, ``repeat_interleave``) and never
builds the dense shape; an op without a sparse path reads the dense
view, built lazily on first access and logged as a storage fallback
(``MXNET_STORAGE_FALLBACK_LOG_VERBOSE``).

Where a row_sparse array holds one row id twice, the last stored
occurrence wins, in the dense view and in every conversion alike. Sums
over several row_sparse arrays (``add_n``) add each array's rows in
list order, so a sum on the card is the same from run to run.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..context import current_context, context_of
from ..ops.common import torch_dtype, numpy_dtype
from .. import imperative as _imp
from .ndarray import NDArray, array as _dense_array

__all__ = ["RowSparseNDArray", "CSRNDArray", "row_sparse_array", "csr_matrix",
           "empty", "array",
           "zeros", "cast_storage", "dot", "add_n", "elemwise_add",
           "elemwise_sub", "elemwise_mul", "square", "square_sum", "sum"]


def _ctx_dev(ctx):
    """``(ctx, device)``; without a card ``gpu(0)`` raises here."""
    ctx = ctx or current_context()
    return ctx, ctx.torch_device()


def _raw(x):
    """A plain tensor for an NDArray (detached from the tape) or a
    tensor."""
    return _imp.plain_tensor(x) if isinstance(x, NDArray) else x


def _index_tensor(x, device):
    """int32 indices on ``device`` from an NDArray, tensor, numpy array
    or list (float ids are truncated, as the JAX package's astype)."""
    if isinstance(x, NDArray):
        t = _raw(x)
    elif isinstance(x, torch.Tensor):
        t = x
    else:
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.int64)))
    return t.to(device=device, dtype=torch.int32)


class BaseSparseNDArray(NDArray):
    """Common base. The dense view is built lazily: ``_data`` is a
    property that materialises (and caches) it on first dense access,
    so the sparse paths (``add_n``, ``retain``, the stores' row_sparse
    push and pull, ``dot``) never allocate the dense shape."""

    __slots__ = ("_dense_cache", "_sp_shape")

    def _init_sparse(self, shape, ctx):
        self._ctx = ctx
        self._grad = None
        self._grad_req = None
        self._tape = False
        self._alias = None
        self._dense_cache = None
        self._sp_shape = tuple(int(s) for s in shape)

    @property
    def _data(self):
        if self._dense_cache is None:
            self._dense_cache = self._make_dense()
        return self._dense_cache

    @_data.setter
    def _data(self, v):
        self._dense_cache = v

    @property
    def shape(self):
        return self._sp_shape

    @property
    def ndim(self):
        return len(self._sp_shape)

    @property
    def size(self):
        n = 1
        for s in self._sp_shape:
            n *= s
        return n

    @property
    def dtype(self):
        t = self._values().dtype
        return torch.bfloat16 if t == torch.bfloat16 else numpy_dtype(t)

    def copyto(self, other):
        """A copy on a Context (same storage type), into a sparse array of
        the same type, or into a dense array (its dense view)."""
        from ..context import Context
        if isinstance(other, Context):
            return self._moved(other)
        if type(other) is type(self):
            other._take(self._moved(other.context))
            return other
        if isinstance(other, NDArray):
            with torch.no_grad():
                other._data.copy_(self._data)
            return other
        raise TypeError("copyto: expected NDArray or Context")


class RowSparseNDArray(BaseSparseNDArray):
    """Row-sparse array: stored rows by id, every other row zero."""

    __slots__ = ("_rsp_data", "_rsp_indices")

    def __init__(self, data, indices, shape, ctx=None):
        self._init_sparse(shape, ctx or context_of(data))
        self._rsp_data = data
        self._rsp_indices = _index_tensor(indices, data.device)

    @property
    def stype(self):
        return "row_sparse"

    def _values(self):
        return self._rsp_data

    def _take(self, other):
        self._rsp_data, self._rsp_indices = other._rsp_data, \
            other._rsp_indices
        self._dense_cache = None

    def _moved(self, ctx):
        dev = ctx.torch_device()
        return RowSparseNDArray(self._rsp_data.to(dev, copy=True),
                                self._rsp_indices.to(dev, copy=True),
                                self._sp_shape, ctx)

    def _make_dense(self):
        idx = self._rsp_indices.long()
        keep = _sorted_last(idx)
        out = torch.zeros(self._sp_shape, dtype=self._rsp_data.dtype,
                          device=self._rsp_data.device)
        return out.index_copy_(0, idx[keep], self._rsp_data[keep])

    @property
    def data(self):
        return NDArray(self._rsp_data, self._ctx)

    @property
    def indices(self):
        return NDArray(self._rsp_indices, self._ctx)

    def tostype(self, stype):
        if stype == "row_sparse":
            return self
        if stype == "default":
            return NDArray(self._data, self._ctx)
        if stype == "csr":
            return cast_storage(self, "csr")     # O(stored rows)
        raise MXNetError("unknown stype %r" % stype)

    def copy(self):
        return RowSparseNDArray(self._rsp_data.clone(),
                                self._rsp_indices.clone(), self.shape,
                                self._ctx)

    def retain(self, row_ids):
        """Keep only the listed rows (parity: mx.nd.sparse.retain), on
        the device; only the result's size reaches the host."""
        rows = _index_tensor(row_ids, self._rsp_indices.device)
        mask = torch.isin(self._rsp_indices, rows)
        return RowSparseNDArray(self._rsp_data[mask],
                                self._rsp_indices[mask], self.shape,
                                self._ctx)


class CSRNDArray(BaseSparseNDArray):
    """Compressed sparse row matrix."""

    __slots__ = ("_csr_data", "_csr_indices", "_csr_indptr")

    def __init__(self, data, indices, indptr, shape, ctx=None):
        if not isinstance(data, torch.Tensor):
            ctx = ctx or current_context()
            data = _dense_array(data, ctx=ctx)._data
        self._init_sparse(shape, ctx or context_of(data))
        self._csr_data = data
        self._csr_indices = _index_tensor(indices, data.device)
        self._csr_indptr = _index_tensor(indptr, data.device)

    @property
    def stype(self):
        return "csr"

    def _values(self):
        return self._csr_data

    def _take(self, other):
        self._csr_data, self._csr_indices, self._csr_indptr = \
            other._csr_data, other._csr_indices, other._csr_indptr
        self._dense_cache = None

    def _moved(self, ctx):
        dev = ctx.torch_device()
        return CSRNDArray(self._csr_data.to(dev, copy=True),
                          self._csr_indices.to(dev, copy=True),
                          self._csr_indptr.to(dev, copy=True),
                          self._sp_shape, ctx)

    def _row_ids(self):
        """One row id per stored value (the segment ids every csr path
        here consumes; one device op, no host read)."""
        counts = torch.diff(self._csr_indptr.long())
        return torch.repeat_interleave(
            torch.arange(self._sp_shape[0], device=counts.device), counts,
            output_size=int(self._csr_data.shape[0]))

    def _make_dense(self):
        """One scatter: dense[row_ids, cols] = data (a csr matrix's
        coordinates are unique, so the write is exact)."""
        out = torch.zeros(self._sp_shape, dtype=self._csr_data.dtype,
                          device=self._csr_data.device)
        out[self._row_ids(), self._csr_indices.long()] = self._csr_data
        return out

    @property
    def data(self):
        return NDArray(self._csr_data, self._ctx)

    @property
    def indices(self):
        return NDArray(self._csr_indices, self._ctx)

    @property
    def indptr(self):
        return NDArray(self._csr_indptr, self._ctx)

    def tostype(self, stype):
        if stype == "csr":
            return self
        if stype == "default":
            return NDArray(self._data, self._ctx)
        if stype == "row_sparse":
            return cast_storage(self, "row_sparse")     # O(nnz)
        raise MXNetError("unknown stype %r" % stype)

    def copy(self):
        return CSRNDArray(self._csr_data.clone(), self._csr_indices.clone(),
                          self._csr_indptr.clone(), self.shape, self._ctx)

    def asscipy(self):
        """A ``scipy.sparse.csr_matrix`` copy (parity:
        sparse.CSRNDArray.asscipy)."""
        try:
            from scipy import sparse as sps
        except ImportError:
            raise ImportError("scipy is not installed")
        return sps.csr_matrix((self.data.asnumpy(), self.indices.asnumpy(),
                               self.indptr.asnumpy()), shape=self.shape)


def _sorted_last(idx):
    """Positions of the stored rows in row-id order, a duplicated id kept
    once at its last stored occurrence (the rule the dense view and every
    conversion share)."""
    order = torch.argsort(idx, stable=True)
    if order.numel() < 2:
        return order
    s = idx[order]
    return order[torch.cat([s[1:] != s[:-1], torch.ones(
        1, dtype=torch.bool, device=idx.device)])]


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------

def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from ``(data, indices)`` with ``shape``, or from
    a dense array-like (parity: mx.nd.sparse.row_sparse_array)."""
    ctx, dev = _ctx_dev(ctx)
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        if shape is None:
            raise MXNetError("row_sparse_array: shape required")
        data = _dense_array(data, ctx=ctx, dtype=dtype)._data
        return RowSparseNDArray(data, _index_tensor(indices, dev),
                                tuple(shape), ctx)
    return cast_storage(_dense_array(arg1, ctx=ctx, dtype=dtype),
                        "row_sparse")


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from ``(data, indices, indptr)`` with ``shape``, or
    from a dense array-like (parity: mx.nd.sparse.csr_matrix)."""
    ctx, dev = _ctx_dev(ctx)
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        if shape is None:
            raise MXNetError("csr_matrix: shape required")
        data = _dense_array(data, ctx=ctx, dtype=dtype)._data
        return CSRNDArray(data, _index_tensor(indices, dev),
                          _index_tensor(indptr, dev), tuple(shape), ctx)
    return cast_storage(_dense_array(arg1, ctx=ctx, dtype=dtype), "csr")


def zeros(stype, shape, ctx=None, dtype=None):
    """An all-zero array of storage type ``stype``: no stored rows or
    values (parity: mx.nd.sparse.zeros)."""
    ctx, dev = _ctx_dev(ctx)
    dt = torch_dtype(dtype) or torch.float32
    shape = tuple(shape)
    if stype == "row_sparse":
        return RowSparseNDArray(torch.zeros((0,) + shape[1:], dtype=dt,
                                            device=dev),
                                torch.zeros((0,), dtype=torch.int32,
                                            device=dev), shape, ctx)
    if stype == "csr":
        return CSRNDArray(torch.zeros((0,), dtype=dt, device=dev),
                          torch.zeros((0,), dtype=torch.int32, device=dev),
                          torch.zeros((shape[0] + 1,), dtype=torch.int32,
                                      device=dev), shape, ctx)
    from .ndarray import zeros as _dz
    return _dz(shape, ctx=ctx, dtype=dtype)


def empty(stype, shape, ctx=None, dtype=None):
    """(parity: sparse.empty) zero-backed, like the dense ``empty``."""
    return zeros(stype, shape, ctx=ctx, dtype=dtype)


def array(source_array, ctx=None, dtype=None):
    """A sparse NDArray from sparse input: a sparse NDArray or a
    ``scipy.sparse`` matrix (parity: sparse.array, which rejects dense
    input)."""
    if isinstance(source_array, BaseSparseNDArray):
        out = cast_storage(source_array.tostype("default"),
                           source_array.stype)
        if dtype is not None:
            out = out.astype(dtype)
        return out
    try:
        import scipy.sparse as sps
        is_scipy = sps.issparse(source_array)
    except ImportError:
        is_scipy = False
    if is_scipy:
        csr = source_array.tocsr()
        data = np.asarray(csr.data, dtype or csr.dtype)
        return csr_matrix((data, np.asarray(csr.indices),
                           np.asarray(csr.indptr)), shape=csr.shape,
                          ctx=ctx)
    raise MXNetError(
        "sparse.array expects a sparse NDArray or scipy.sparse matrix; "
        "use mx.nd.array / csr_matrix / row_sparse_array for dense input "
        "(the reference rejects dense input here too)")


# ---------------------------------------------------------------------------
# cast_storage
# ---------------------------------------------------------------------------

def _indptr_of(row_counts):
    return torch.cat([torch.zeros(1, dtype=torch.int32,
                                  device=row_counts.device),
                      torch.cumsum(row_counts, 0).to(torch.int32)])


def cast_storage(arr, stype):
    """Convert between storage types (parity: mx.nd.cast_storage,
    reference cast_storage-inl.h). Sparse-to-sparse conversions work on
    the compressed form, O(stored rows × columns + nnz + rows), never
    the dense shape; dense-to-sparse scans the dense array once."""
    if arr.stype == stype:
        return arr
    if stype == "default":
        return NDArray(arr._data, arr.context)
    if isinstance(arr, RowSparseNDArray) and stype == "csr":
        if len(arr.shape) != 2:
            raise MXNetError("csr requires 2-D")
        idx = arr._rsp_indices.long()
        order = _sorted_last(idx)
        block = arr._rsp_data[order]
        mask = block != 0
        counts = mask.sum(1, dtype=torch.int32)
        row_counts = torch.zeros(arr.shape[0], dtype=torch.int32,
                                 device=block.device) \
            .index_copy_(0, idx[order], counts)
        r, c = torch.nonzero(mask, as_tuple=True)     # row-major: csr order
        return CSRNDArray(block[r, c], c.to(torch.int32),
                          _indptr_of(row_counts), arr.shape, arr.context)
    if isinstance(arr, CSRNDArray) and stype == "row_sparse":
        counts = torch.diff(arr._csr_indptr.long())
        nz_rows = torch.nonzero(counts > 0, as_tuple=True)[0]
        pos = torch.searchsorted(nz_rows, arr._row_ids())
        block = torch.zeros((int(nz_rows.numel()),) + tuple(arr.shape[1:]),
                            dtype=arr._csr_data.dtype,
                            device=arr._csr_data.device)
        block[pos, arr._csr_indices.long()] = arr._csr_data
        return RowSparseNDArray(block, nz_rows.to(torch.int32), arr.shape,
                                arr.context)
    dense = _raw(arr) if not isinstance(arr, BaseSparseNDArray) \
        else arr._data
    if stype == "row_sparse":
        nz = dense != 0
        if dense.ndim > 1:
            nz = nz.any(dim=tuple(range(1, dense.ndim)))
        nz_rows = torch.nonzero(nz, as_tuple=True)[0]
        return RowSparseNDArray(dense[nz_rows], nz_rows.to(torch.int32),
                                tuple(dense.shape), arr.context)
    if stype == "csr":
        if dense.ndim != 2:
            raise MXNetError("csr requires 2-D")
        mask = dense != 0
        rows, cols = torch.nonzero(mask, as_tuple=True)
        return CSRNDArray(dense[rows, cols], cols.to(torch.int32),
                          _indptr_of(mask.sum(1)), tuple(dense.shape),
                          arr.context)
    raise MXNetError("unknown stype %r" % stype)


# ---------------------------------------------------------------------------
# Sums and elementwise ops
# ---------------------------------------------------------------------------

def _union_sum(parts, width, dtype, device):
    """``(union of row ids, their summed rows)`` over ``parts``, a list of
    ``(int32 ids, rows)``: each part's rows are added in list order (one
    ``index_add_`` a part, free of conflicts where a part's ids are
    unique), so the sum does not depend on the card's scheduling."""
    if parts:
        uniq = torch.unique(torch.cat([i.long() for i, _ in parts]))
    else:
        uniq = torch.zeros(0, dtype=torch.long, device=device)
    summed = torch.zeros((int(uniq.numel()),) + tuple(width), dtype=dtype,
                         device=device)
    for ids, rows in parts:
        if ids.numel():
            summed.index_add_(0, torch.searchsorted(uniq, ids.long()),
                              rows.to(dtype))
    return uniq.to(torch.int32), summed


def add_n(arrays):
    """Sum row_sparse arrays without densifying (parity: reference
    ElementwiseSum's row_sparse path): the union of the row ids, each
    array's rows added in list order — the aggregation the stores use for
    row-sparse pushes."""
    if not arrays:
        raise MXNetError("add_n: empty list")
    if not all(isinstance(a, RowSparseNDArray) for a in arrays):
        raise MXNetError("add_n: all inputs must be row_sparse")
    first = arrays[0]
    uniq, summed = _union_sum(
        [(a._rsp_indices, a._rsp_data) for a in arrays], first.shape[1:],
        first._rsp_data.dtype, first._rsp_data.device)
    return RowSparseNDArray(summed, uniq, first.shape, first.context)


def _csr_merge(lhs, rhs, mode):
    """COO merge of two same-shape csr matrices on the compressed form:
    concatenate, sort the (row, col) keys, combine each key's values,
    rebuild indptr. ``add``/``sub``: the union of coordinates (a sum that
    cancels to zero stays stored); ``mul``: the intersection."""
    if lhs.shape != rhs.shape:
        raise MXNetError("elemwise %s: shape mismatch %s vs %s"
                         % (mode, lhs.shape, rhs.shape))
    nrows, ncols = lhs.shape
    r = torch.cat([lhs._row_ids(), rhs._row_ids()])
    c = torch.cat([lhs._csr_indices.long(), rhs._csr_indices.long()])
    rvals = rhs._csr_data if mode != "sub" else -rhs._csr_data
    vals = torch.cat([lhs._csr_data, rvals])
    order = torch.argsort(r * ncols + c, stable=True)
    r, c, vals = r[order], c[order], vals[order]
    changed = torch.ones(r.numel(), dtype=torch.bool, device=r.device)
    if r.numel() > 1:
        changed[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    uniq_r, uniq_c = r[changed], c[changed]
    if mode == "mul":
        # a coordinate holds one value per side: the product survives
        # only where both sides stored one
        starts = torch.nonzero(changed, as_tuple=True)[0]
        ends = torch.cat([starts[1:], torch.tensor(
            [r.numel()], device=r.device)])
        both = (ends - starts) == 2
        combined = vals[starts[both]] * vals[starts[both] + 1]
        uniq_r, uniq_c = uniq_r[both], uniq_c[both]
    else:
        seg = torch.cumsum(changed.long(), 0) - 1
        combined = torch.zeros(int(uniq_r.numel()), dtype=vals.dtype,
                               device=vals.device).index_add_(0, seg, vals)
    row_counts = torch.bincount(uniq_r, minlength=nrows)
    return CSRNDArray(combined, uniq_c.to(torch.int32),
                      _indptr_of(row_counts), lhs.shape, lhs.context)


def _rsp_pair(lhs, rhs, mode):
    """row_sparse ⊕ row_sparse on the stored blocks: add/sub over the
    union of row ids, mul over their intersection."""
    if lhs.shape != rhs.shape:
        raise MXNetError("elemwise %s: shape mismatch %s vs %s"
                         % (mode, lhs.shape, rhs.shape))
    if mode == "mul":
        li, lperm = torch.sort(lhs._rsp_indices.long())
        ri, rperm = torch.sort(rhs._rsp_indices.long())
        inl = torch.isin(li, ri)
        common = li[inl]
        lpos = lperm[inl]
        rpos = rperm[torch.searchsorted(ri, common)]
        return RowSparseNDArray(lhs._rsp_data[lpos] * rhs._rsp_data[rpos],
                                common.to(torch.int32), lhs.shape,
                                lhs.context)
    neg = rhs if mode == "add" else RowSparseNDArray(
        -rhs._rsp_data, rhs._rsp_indices, rhs.shape, rhs.context)
    return add_n([lhs, neg])


def _dense_of(x):
    return x.tostype("default") if isinstance(x, BaseSparseNDArray) else x


def _binary_sparse(lhs, rhs, mode, opname):
    """The storage table of elemwise add/sub/mul: csr·csr → csr,
    rsp·rsp → rsp, anything else dense through the logged fallback."""
    if isinstance(lhs, CSRNDArray) and isinstance(rhs, CSRNDArray):
        return _csr_merge(lhs, rhs, mode)
    if isinstance(lhs, RowSparseNDArray) and isinstance(rhs, RowSparseNDArray):
        return _rsp_pair(lhs, rhs, mode)
    from ..config import storage_fallback_log
    storage_fallback_log("%s(%s, %s)" % (opname, lhs.stype, rhs.stype))
    ld, rd = _dense_of(lhs), _dense_of(rhs)
    return {"add": ld.__add__, "sub": ld.__sub__, "mul": ld.__mul__}[mode](rd)


def elemwise_add(lhs, rhs):
    """Sparse elemwise add (reference elemwise_binary_op_basic.cc)."""
    return _binary_sparse(lhs, rhs, "add", "elemwise_add")


def elemwise_sub(lhs, rhs):
    """Sparse elemwise subtract: csr-csr → csr, rsp-rsp → rsp."""
    return _binary_sparse(lhs, rhs, "sub", "elemwise_sub")


def elemwise_mul(lhs, rhs):
    """Sparse elemwise multiply: csr*csr → csr, rsp*rsp → rsp (the
    structural intersection)."""
    return _binary_sparse(lhs, rhs, "mul", "elemwise_mul")


def _map_values(arr, fn):
    """An f(0)=0 elementwise ``fn`` on the stored values, the structure
    kept."""
    if isinstance(arr, RowSparseNDArray):
        return RowSparseNDArray(fn(arr._rsp_data), arr._rsp_indices,
                                arr.shape, arr._ctx)
    if isinstance(arr, CSRNDArray):
        return CSRNDArray(fn(arr._csr_data), arr._csr_indices,
                          arr._csr_indptr, arr.shape, arr._ctx)
    return NDArray(fn(_raw(arr)), arr.context)


def square(arr):
    """Storage-keeping square: square(rsp) = rsp, square(csr) = csr."""
    return _map_values(arr, lambda v: v * v)


def _one_axis(axis):
    return axis[0] if isinstance(axis, (tuple, list)) and len(axis) == 1 \
        else axis


def square_sum(arr, axis=None, keepdims=False):
    """Sum of squares of a row_sparse array without densifying (reference
    _square_sum, square_sum-inl.h): axis=1 with keepdims → row_sparse (a
    value per stored row); axis=1 → a dense (rows,) vector; axis=0 → a
    dense vector over the columns."""
    if not isinstance(arr, RowSparseNDArray):
        raise MXNetError("_square_sum: row_sparse input required "
                         "(reference square_sum-inl.h)")
    if isinstance(axis, (tuple, list)) and len(axis) != 1:
        raise MXNetError("_square_sum: single-axis reductions only "
                         "(got axis=%r; reference square_sum-inl.h "
                         "supports axis 0 or 1)" % (axis,))
    ax = _one_axis(axis)
    sq = arr._rsp_data * arr._rsp_data
    nrows = arr.shape[0]
    if ax == 1:
        per_row = sq.sum(dim=tuple(range(1, sq.ndim)))
        if keepdims:
            return RowSparseNDArray(per_row[:, None], arr._rsp_indices,
                                    (nrows, 1), arr._ctx)
        dense = torch.zeros(nrows, dtype=per_row.dtype,
                            device=per_row.device)
        dense[arr._rsp_indices.long()] = per_row
        return NDArray(dense, arr.context)
    if ax == 0:
        out = sq.sum(0)
        return NDArray(out[None] if keepdims else out, arr.context)
    raise MXNetError("_square_sum: axis must be 0 or 1 (got %r)" % (axis,))


def sum(arr, axis=None, keepdims=False, exclude=False):
    """Reduce a csr matrix over one axis on the compressed form, a dense
    result (reference sum(csr, axis) FComputeEx); other inputs take the
    logged dense fallback."""
    ax = _one_axis(axis)
    if isinstance(arr, CSRNDArray) and not exclude and ax in (0, 1):
        nrows, ncols = arr.shape
        if ax == 1:
            out = torch.zeros(nrows, dtype=arr._csr_data.dtype,
                              device=arr._csr_data.device) \
                .index_add_(0, arr._row_ids(), arr._csr_data)
            if keepdims:
                out = out[:, None]
        else:
            out = torch.zeros(ncols, dtype=arr._csr_data.dtype,
                              device=arr._csr_data.device) \
                .index_add_(0, arr._csr_indices.long(), arr._csr_data)
            if keepdims:
                out = out[None, :]
        return NDArray(out, arr.context)
    from ..config import storage_fallback_log
    storage_fallback_log("sum(%s, axis=%r)" % (arr.stype, axis))
    from . import sum as _dense_sum
    return _dense_sum(_dense_of(arr), axis=axis, keepdims=keepdims,
                      exclude=exclude)


# ---------------------------------------------------------------------------
# dot
# ---------------------------------------------------------------------------

def _csr_dot(rows, cols, vals, rr, transpose_a, out_rows):
    """csr · rr (``out[i] = Σ_k csr[i, k] rr[k]``) or csrᵀ · rr
    (``out[k] += csr[i, k] rr[i]``): one gather of the touched rows of
    ``rr`` and one scatter-add, O(nnz × N)."""
    src, dst = (rows, cols) if transpose_a else (cols, rows)
    prod = vals[:, None] * rr.index_select(0, src)
    return torch.zeros((out_rows, rr.shape[1]), dtype=prod.dtype,
                       device=prod.device).index_add(0, dst, prod)


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Sparse-aware dot (parity: reference dot-inl.h sparse kernels).

    csr · dense and csrᵀ · dense (the sparse linear classifier's ops) run
    on the compressed form and never build the dense lhs. Under
    ``autograd.record`` the result carries the tape for the dense rhs
    only (the csr lhs gets no gradient, as in the reference). Every other
    storage pairing takes the logged dense fallback."""
    from . import dot as _dense_dot
    if isinstance(lhs, CSRNDArray) and not isinstance(rhs, BaseSparseNDArray) \
            and not transpose_b and rhs.ndim == 2:
        inner = lhs.shape[0] if transpose_a else lhs.shape[1]
        if rhs.shape[0] != inner:
            raise MXNetError("dot: shape mismatch %s x %s (transpose_a=%s)"
                             % (lhs.shape, tuple(rhs.shape), transpose_a))
        rows = lhs._row_ids()
        cols = lhs._csr_indices.long()
        out_rows = lhs.shape[1] if transpose_a else lhs.shape[0]
        if _imp.should_record([rhs]):
            with torch.enable_grad():
                out = _csr_dot(rows, cols, lhs._csr_data,
                               _imp.tape_tensor(rhs), transpose_a, out_rows)
            res = NDArray(out, lhs.context)
            res._tape = True
            return res
        return NDArray(_csr_dot(rows, cols, lhs._csr_data,
                                _imp.plain_tensor(rhs), transpose_a,
                                out_rows), lhs.context)
    if isinstance(lhs, BaseSparseNDArray) or isinstance(rhs, BaseSparseNDArray):
        from ..config import storage_fallback_log
        storage_fallback_log("dot(%s, %s)" % (lhs.stype, rhs.stype))
    return _dense_dot(_dense_of(lhs), _dense_of(rhs),
                      transpose_a=transpose_a, transpose_b=transpose_b)


# ---------------------------------------------------------------------------
# Storage-aware dispatch
# ---------------------------------------------------------------------------

#: op name -> union/intersection mode of the binary FComputeEx table; the
#: broadcast_* entries serve the NDArray operators, whose same-shape
#: sparse case is the elemwise op
_BINARY_EX = {"elemwise_add": "add", "broadcast_add": "add",
              "_grad_add": "add",
              "elemwise_sub": "sub", "broadcast_sub": "sub",
              "elemwise_mul": "mul", "broadcast_mul": "mul"}


def dispatch_ex(op_name, inputs, params):
    """Storage-aware dispatch (the reference's FInferStorageType +
    FComputeEx pair as one table): ``imperative.invoke`` asks here before
    it reads any input's dense view. NotImplemented means no sparse path
    for this storage combination: the caller logs the fallback and runs
    the op on the dense views."""
    mode = _BINARY_EX.get(op_name)
    if mode is not None and len(inputs) == 2:
        lhs, rhs = inputs
        if isinstance(lhs, CSRNDArray) and isinstance(rhs, CSRNDArray) \
                and lhs.shape == rhs.shape:
            return _csr_merge(lhs, rhs, mode)
        if isinstance(lhs, RowSparseNDArray) \
                and isinstance(rhs, RowSparseNDArray) \
                and lhs.shape == rhs.shape:
            return _rsp_pair(lhs, rhs, mode)
        return NotImplemented
    if len(inputs) != 1 or not isinstance(inputs[0], BaseSparseNDArray):
        return NotImplemented
    arr = inputs[0]
    if op_name == "square":
        return square(arr)
    if op_name == "negative":
        return _map_values(arr, lambda v: -v)
    if op_name == "_mul_scalar":
        s = params.get("scalar", 1.0)
        return _map_values(arr, lambda v: v * s)
    if op_name == "_div_scalar":
        s = params.get("scalar", 1.0)
        return _map_values(arr, lambda v: v / s)
    ax = _one_axis(params.get("axis"))
    if op_name == "sum" and isinstance(arr, CSRNDArray):
        if not params.get("exclude", False) and ax in (0, 1):
            return sum(arr, axis=params.get("axis"),
                       keepdims=params.get("keepdims", False))
        return NotImplemented
    if op_name == "_square_sum" and isinstance(arr, RowSparseNDArray) \
            and ax in (0, 1):
        return square_sum(arr, axis=params.get("axis"),
                          keepdims=params.get("keepdims", False))
    return NotImplemented
