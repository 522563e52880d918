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


def causal_mask_static_kv(seq_len: int, kv_capacity: int, start_pos: int,
                          attention_mask: Optional[torch.Tensor] = None,
                          batch_size: int = 1, dtype=torch.float32,
                          window: Optional[int] = None, sinks: int = 0,
                          device=None) -> torch.Tensor:
    """Causal mask for queries at ``[start_pos, start_pos + seq_len)``
    against a whole static KV buffer of width ``kv_capacity``: key ``j`` is
    attended iff ``j <= start_pos + i`` and ``j`` is not padding (with
    ``window``, also ``j > start_pos + i - window`` or ``j < sinks``).
    Returns additive ``[B, 1, seq_len, kv_capacity]``.

    ``attention_mask`` covers key positions FROM 0, the whole context, not
    the current chunk: a shorter mask marks the key positions past its end
    invalid (what a prefill wants: they hold no data yet), and a longer
    one is cut at ``kv_capacity``. None attends the whole valid prefix."""
    if attention_mask is not None:
        device = attention_mask.device
    q_pos = start_pos + torch.arange(seq_len, device=device)[:, None]
    k_pos = torch.arange(kv_capacity, device=device)[None, :]
    causal = k_pos <= q_pos
    if window is not None:
        causal = causal & ((k_pos > q_pos - window) | (k_pos < sinks))
    if attention_mask is not None:
        pad = attention_mask != 0
        lpad = pad.shape[-1]
        if lpad < kv_capacity:
            pad = torch.nn.functional.pad(pad, (0, kv_capacity - lpad))
        else:
            pad = pad[:, :kv_capacity]
        m = causal[None] & pad[:, None, :]
    else:
        m = causal[None].expand(batch_size, seq_len, kv_capacity)
    return additive(m[:, None], dtype)
