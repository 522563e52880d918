"""Positional embeddings (counterpart of ``vyomai_tpu.layers.positional``):
learned absolute, sinusoidal, RoPE and ViT tables. RoPE scaling is not ported
yet.

The constant tables (sinusoidal, RoPE angles) are computed in fp32 on the
CPU like the JAX tables, so both packages and every device use the same
values.
"""

import math
from typing import Optional, Tuple

import torch

from ..core import nn as cnn


# -- absolute (learned) -----------------------------------------------------------

def absolute_init_(weight: torch.Tensor, config, generator: torch.Generator):
    """Normal(0, initializer_range) position table (no pad row zeroed)."""
    cnn.embedding_init_(weight, config.initializer_range, generator)


def absolute_slice(weight: torch.Tensor, start_pos: int, length: int,
                   pad_idx: Optional[int] = None) -> torch.Tensor:
    """Positions ``[start_pos, start_pos + length)`` -> ``[1, length, D]``.

    ``pad_idx`` keeps the reference's ``nn.Embedding(padding_idx=...)`` on
    the position table: position row ``pad_idx`` is a real position whose
    row never gets a gradient (a training quirk kept for parity)."""
    positions = start_pos + torch.arange(length, device=weight.device)
    return cnn.embedding(weight, positions, pad_idx=pad_idx)[None]


def table_slice(table: torch.Tensor, start_pos: int, length: int
                ) -> torch.Tensor:
    """Rows ``[start_pos, start_pos + length)`` of a constant table ``[1,
    max_len, D]``, the start clamped into ``[0, max_len - length]`` as
    ``lax.dynamic_slice_in_dim`` clamps it."""
    start = min(max(int(start_pos), 0), table.shape[1] - length)
    return table[:, start:start + length]


# -- sinusoidal (constant) ----------------------------------------------------------

def sinusoidal_table(max_len: int, dim: int,
                     dtype=torch.float32) -> torch.Tensor:
    """Interleaved ``sin`` (even) / ``cos`` (odd) table ``[1, max_len,
    dim]``."""
    if dim % 2 != 0:
        raise ValueError(
            f"SinusoidalEncoding requires even hidden dim, got {dim}")
    pos = torch.arange(max_len, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32)
                    * -(math.log(10000.0) / dim))
    tab = torch.zeros((max_len, dim), dtype=torch.float32)
    tab[:, 0::2] = torch.sin(pos * div)
    tab[:, 1::2] = torch.cos(pos * div)
    return tab.to(dtype)[None]


# -- RoPE ---------------------------------------------------------------------------

def rope_freqs(max_len: int, head_dim: int, theta: float = 10000.0,
               dtype=torch.float32, scaling: Optional[dict] = None
               ) -> torch.Tensor:
    """Angles ``[1, max_len, head_dim // 2]``, computed in fp32 like the
    JAX table (so both packages rotate by the same angles)."""
    if scaling:
        raise NotImplementedError("RoPE scaling is not ported yet")
    half = torch.arange(0, head_dim, 2, dtype=torch.float32)
    inv_freq = 1.0 / (theta ** (half / head_dim))
    t = torch.arange(max_len, dtype=torch.float32)
    return torch.outer(t, inv_freq).to(dtype)[None]


def rope_attention_factor(scaling: Optional[dict]) -> float:
    """YaRN attention mscale; 1.0 without scaling (the only case ported)."""
    if scaling:
        raise NotImplementedError("RoPE scaling is not ported yet")
    return 1.0


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary_pos_emb(q: torch.Tensor, k: torch.Tensor,
                         freqs: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """HF-style rotation. ``freqs``: ``[1, L, head_dim // 2]``; q, k:
    ``[B, H, L, D]``."""
    emb = torch.cat([freqs, freqs], dim=-1)
    cos = torch.cos(emb).to(q.dtype)[:, None]
    sin = torch.sin(emb).to(q.dtype)[:, None]
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin


# -- ViT absolute (learned ``[1, P+1, D]``) ------------------------------------------

@torch.no_grad()
def vit_absolute_init_(weight: torch.Tensor, generator: torch.Generator):
    """Standard-normal table (the JAX ``vit_absolute_init``: unscaled)."""
    weight.normal_(0.0, 1.0, generator=generator)


def vit_absolute_add(weight: torch.Tensor, img_seq: torch.Tensor
                     ) -> torch.Tensor:
    """``img_seq [B, n, D]`` plus the table's first ``n`` rows."""
    return img_seq + weight[:, :img_seq.shape[1]]
