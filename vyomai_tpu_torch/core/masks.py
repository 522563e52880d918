"""Additive attention-mask builders (counterpart of
``vyomai_tpu.core.masks``): 0 where a key may be attended, ``NEG_INF``
where it is masked, broadcastable against scores ``[B, H, Lq, Lk]``."""

from typing import Optional

import torch

# torch.finfo(float32).min — the same additive mask constant as
# ``vyomai_tpu.core.masks.NEG_INF``.
NEG_INF = float(torch.finfo(torch.float32).min)


def additive(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``(1 - m) * NEG_INF`` for a {0, 1} (or bool) mask."""
    return (1.0 - mask.to(dtype)) * NEG_INF


def bidirectional_mask(attention_mask: torch.Tensor,
                       dtype=torch.float32) -> torch.Tensor:
    """[B, Lk] pad mask -> additive [B, 1, 1, Lk]."""
    return additive(attention_mask[:, None, None, :], dtype)


def causal_mask(seq_len: int, attention_mask: Optional[torch.Tensor] = None,
                start_pos: int = 0, batch_size: int = 1, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Causal mask for ``seq_len`` queries whose first sits at absolute
    position ``start_pos``, over keys ``[0, start_pos + seq_len)``, with an
    optional [B, start_pos + seq_len] pad mask. Returns additive
    [B, 1, seq_len, start_pos + seq_len]."""
    if attention_mask is not None:
        device = attention_mask.device
    kv_len = start_pos + seq_len
    q_pos = start_pos + torch.arange(seq_len, device=device)[:, None]
    k_pos = torch.arange(kv_len, device=device)[None, :]
    causal = k_pos <= q_pos
    if attention_mask is not None:
        m = (causal[None] & (attention_mask[:, None, :] != 0))[:, None]
    else:
        m = causal[None, None].expand(batch_size, 1, seq_len, kv_len)
    return additive(m, dtype)
