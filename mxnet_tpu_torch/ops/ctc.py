"""The CTC loss operator.

Counterpart of ``mxnet_tpu/ops/ctc.py`` (reference
``src/operator/contrib/ctc_loss-inl.h``): the JAX package's log-domain
alpha recursion, one step of batched device work per time step. Blank is
class 0; label padding is any value < 1 when ``label_lengths`` is absent;
past its ``data_lengths`` a sequence's alphas stay frozen. An alignment
that cannot exist gives a loss near 1e30 (the recursion's -1e30 stands
for log 0), as in the JAX package, where ``F.ctc_loss`` would give inf.
"""
from __future__ import annotations

import torch

from .registry import register

NEG_INF = -1e30


@register("_ctc_loss", nin=-1, arg_names=["data", "label"],
          aliases=("ctc_loss", "_contrib_ctc_loss", "_contrib_CTCLoss"))
def ctc_loss(data, label, data_lengths=None, label_lengths=None):
    """data (N, T, C) unnormalised activations; label (N, L) with classes
    in [1, C) -> the per-sample negative log likelihood (N,)."""
    N, T, C = data.shape
    L = label.shape[1]
    logp = torch.log_softmax(data, dim=-1)
    dev = data.device
    lab = label.detach().to(torch.int64)
    lab_len = (lab > 0).sum(dim=1) if label_lengths is None \
        else label_lengths.detach().to(torch.int64)
    seq_len = torch.full((N,), T, dtype=torch.int64, device=dev) \
        if data_lengths is None else data_lengths.detach().to(torch.int64)
    # the extended sequence, blanks at even positions; a padding value
    # (< 0 included) reads class 0, beyond the sequence's end either way
    S = 2 * L + 1
    ext = torch.zeros((N, S), dtype=torch.int64, device=dev)
    ext[:, 1::2] = lab.clamp(0, C - 1)
    ext_len = 2 * lab_len + 1
    prev2 = torch.cat([torch.zeros((N, 2), dtype=torch.int64, device=dev),
                       ext[:, :-2]], dim=1)
    can_skip = (ext != 0) & (ext != prev2) \
        & (torch.arange(S, device=dev) >= 2)[None, :]
    neg = torch.full((), NEG_INF, dtype=logp.dtype, device=dev)
    emit = torch.gather(logp, 2, ext[:, None, :].expand(N, T, S))  # (N, T, S)
    alpha = torch.full((N, S), NEG_INF, dtype=logp.dtype, device=dev)
    alpha = torch.cat([emit[:, 0, :1],
                       torch.where(lab_len > 0, emit[:, 0, 1], neg)[:, None],
                       alpha[:, 2:]], dim=1)
    pad1 = torch.full((N, 1), NEG_INF, dtype=logp.dtype, device=dev)
    pad2 = torch.full((N, 2), NEG_INF, dtype=logp.dtype, device=dev)
    for t in range(1, T):
        shift1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        shift2 = torch.where(can_skip, torch.cat([pad2, alpha[:, :-2]], 1),
                             neg)
        new = torch.logaddexp(torch.logaddexp(alpha, shift1), shift2) \
            + emit[:, t]
        alpha = torch.where((t < seq_len)[:, None], new, alpha)
    last = torch.gather(alpha, 1, (ext_len - 1)[:, None])[:, 0]
    last2 = torch.gather(alpha, 1, (ext_len - 2).clamp_min(0)[:, None])[:, 0]
    return -torch.logaddexp(last, torch.where(lab_len > 0, last2, neg))
