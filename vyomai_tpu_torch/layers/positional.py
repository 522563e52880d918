"""Rotary position embedding tables (counterpart of
``vyomai_tpu.layers.positional``; vanilla RoPE only so far)."""

from typing import Optional

import torch


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
