"""Linear-algebra operators (the ``linalg_*`` namespace).

Counterpart of ``mxnet_tpu/ops/linalg.py`` (parity: reference
``src/operator/tensor/la_op.cc``): gemm, gemm2, potrf, potri, trmm,
trsm, sumlogdiag and syrk over the last two axes, batched over the
leading ones. ``torch.linalg`` runs them (cuSOLVER/cuBLAS on the card).
Two rules follow the reference where the JAX package does not: ``trmm``
reads only A's lower triangle, and ``trsm`` with ``rightside`` solves
with the triangle ``op(A)^T`` really has (the JAX package tells its
solver the transposed matrix is lower, so it reads only the diagonal).
"""
from __future__ import annotations

import torch

from .registry import register


def _t(x, transpose):
    return x.transpose(-1, -2) if transpose else x


@register("_linalg_gemm", nin=3, arg_names=["A", "B", "C"],
          defaults={"transpose_a": False, "transpose_b": False, "alpha": 1.0,
                    "beta": 1.0}, aliases=("linalg_gemm",))
def linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0, axis=-2):
    """alpha * op(A) op(B) + beta * C"""
    return alpha * torch.matmul(_t(A, transpose_a), _t(B, transpose_b)) \
        + beta * C


@register("_linalg_gemm2", nin=2, arg_names=["A", "B"],
          defaults={"transpose_a": False, "transpose_b": False,
                    "alpha": 1.0}, aliases=("linalg_gemm2",))
def linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0,
                 axis=-2):
    """alpha * op(A) op(B)"""
    return alpha * torch.matmul(_t(A, transpose_a), _t(B, transpose_b))


@register("_linalg_potrf", aliases=("linalg_potrf",))
def linalg_potrf(A):
    """The Cholesky factor L of A (upper triangle zero)."""
    return torch.linalg.cholesky(A)


@register("_linalg_potri", aliases=("linalg_potri",))
def linalg_potri(A):
    """(A A^T)^-1 from its Cholesky factor A = L."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device) \
        .expand(A.shape)
    linv = torch.linalg.solve_triangular(A, eye, upper=False)
    return torch.matmul(linv.transpose(-1, -2), linv)


@register("_linalg_trmm", nin=2, arg_names=["A", "B"],
          defaults={"transpose": False, "rightside": False, "alpha": 1.0},
          aliases=("linalg_trmm",))
def linalg_trmm(A, B, transpose=False, rightside=False, alpha=1.0,
                lower=True):
    """alpha * op(A) B, or alpha * B op(A) with ``rightside``; A lower
    triangular (its upper triangle is not read)."""
    a = _t(torch.tril(A) if lower else torch.triu(A), transpose)
    return alpha * (torch.matmul(B, a) if rightside else torch.matmul(a, B))


@register("_linalg_trsm", nin=2, arg_names=["A", "B"],
          defaults={"transpose": False, "rightside": False, "alpha": 1.0},
          aliases=("linalg_trsm",))
def linalg_trsm(A, B, transpose=False, rightside=False, alpha=1.0,
                lower=True):
    """X with op(A) X = alpha B, or X op(A) = alpha B with ``rightside``;
    A lower triangular."""
    upper = lower == bool(transpose)        # the triangle op(A) has
    return torch.linalg.solve_triangular(
        _t(A, transpose), alpha * B, upper=upper, left=not rightside)


@register("_linalg_sumlogdiag", aliases=("linalg_sumlogdiag",))
def linalg_sumlogdiag(A):
    """sum(log(diag(A)))"""
    return torch.sum(torch.log(torch.diagonal(A, dim1=-2, dim2=-1)), dim=-1)


@register("_linalg_syrk", defaults={"transpose": False, "alpha": 1.0},
          aliases=("linalg_syrk",))
def linalg_syrk(A, transpose=False, alpha=1.0):
    """alpha * op(A) op(A)^T"""
    a = _t(A, transpose)
    return alpha * torch.matmul(a, a.transpose(-1, -2))
