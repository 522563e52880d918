"""LM-head cross-entropy, chunked over rows (counterpart of
``lm_head_ce_loss``, ``cross_entropy`` and ``_masked_ce_sum`` in
``vyomai_tpu.ops.fused``).

``lm_head_ce_loss`` never holds the fp32 ``[B*L, V]`` logits: each chunk's
vocab projection and log-sum-exp run under ``torch.utils.checkpoint``, so
the backward recomputes the chunk's logits instead of saving them, and the
peak is ``chunk_size x V`` fp32 in both passes.
"""

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core import nn as cnn


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _masked_ce_sum(logits, targets, ignore_index: int):
    """fp32 (fp64 for fp64 logits) log-sum-exp CE summed over positions
    where ``targets != ignore_index``; returns ``(loss_sum,
    valid_count)``."""
    acc = _acc(logits.dtype)
    logits = logits.to(acc)
    lse = torch.logsumexp(logits, dim=-1)
    t_safe = targets.clamp(0, logits.shape[-1] - 1)
    tgt = logits.gather(-1, t_safe[..., None])[..., 0]
    valid = targets != ignore_index
    losses = torch.where(valid, lse - tgt, 0.0)
    return losses.sum(), valid.to(acc).sum()


def _chunk_loss(xc, tc, weight, bias, ignore_index: int):
    # the chunk's matmul in the input dtype, then fp32 log-sum-exp
    return _masked_ce_sum(cnn.linear(weight, xc, bias), tc, ignore_index)


def lm_head_ce_loss(hidden, weight, bias, targets, *,
                    ignore_index: int = -100, chunk_size: int = 1024,
                    shift: bool = False):
    """Mean cross-entropy of ``softmax(hidden @ weight.T + bias)`` against
    ``targets``.

    hidden ``[B, L, D]``; weight ``[V, D]`` (``nn.Linear`` layout; the JAX
    kernel is its transpose); bias ``[V]`` or None; targets ``[B, L]``.
    ``shift=True`` predicts token t+1 from position t. The mean runs over
    positions where ``targets != ignore_index`` (``max(count, 1)``).
    """
    if shift:
        hidden, targets = hidden[:, :-1], targets[:, 1:]
    b, l, d = hidden.shape
    n = b * l
    x, t = hidden.reshape(n, d), targets.reshape(n)
    n_pad = _round_up(n, chunk_size)
    if n_pad != n:
        x = F.pad(x, (0, 0, 0, n_pad - n))
        t = F.pad(t, (0, n_pad - n), value=ignore_index)
    acc = _acc(hidden.dtype)
    total = torch.zeros((), dtype=acc, device=hidden.device)
    count = torch.zeros((), dtype=acc, device=hidden.device)
    for i in range(0, n_pad, chunk_size):
        ls, cnt = checkpoint(_chunk_loss, x[i:i + chunk_size],
                             t[i:i + chunk_size], weight, bias, ignore_index,
                             use_reentrant=False)
        total, count = total + ls, count + cnt
    return total / count.clamp_min(1.0)


def cross_entropy(logits, targets, *, ignore_index: int = -100):
    """Plain masked CE (fp32 softmax), mean over valid positions."""
    total, count = _masked_ce_sum(logits, targets, ignore_index)
    return total / count.clamp_min(1.0)
