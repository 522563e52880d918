"""The gated short convolution of LFM2 (no counterpart in the JAX package):
``[B | C | x̃] = split₃(x W_inᵀ)``, ``u = B ⊙ x̃``, a causal depthwise
convolution of ``L`` taps over ``u`` (``y_t = Σ_j w[:, j] ⊙ u_{t-L+1+j}``,
zeros before a sequence's first token), ``out = (C ⊙ y) W_outᵀ``, no
biases.

Its state is the last ``L - 1`` values of ``u``: :func:`conv_sequence` runs
a whole chunk from a given state (zeros for a sequence's start) and returns
the state as of each row's last real token; :func:`conv_step` advances it
one token. ``u`` and ``C ⊙ y`` are rounded to the activation dtype where
upstream's bf16 module rounds them; the taps' sum is fp32 (fp64 for fp64).
The module tree is upstream's: ``in_proj``, ``conv.weight [H, 1, L]``,
``out_proj``.
"""

from typing import Optional

import torch
from torch import nn
from torch.nn.utils import skip_init

from ..core import nn as cnn
from .modern import _linear


class ShortConv(nn.Module):
    def __init__(self, hidden: int, taps: int, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.in_proj = _linear(hidden, 3 * hidden, device, dtype)
        self.conv = skip_init(nn.Conv1d, hidden, hidden, taps, groups=hidden,
                              bias=False, device=device, dtype=dtype)
        self.out_proj = _linear(hidden, hidden, device, dtype)

    @property
    def taps(self) -> int:
        return self.conv.weight.shape[-1]


def _gated(conv: ShortConv, x: torch.Tensor):
    b, c, xt = cnn.apply_linear(conv.in_proj, x).chunk(3, dim=-1)
    return b * xt, c


def _taps(conv: ShortConv, x: torch.Tensor) -> torch.Tensor:
    """``w [L, H]`` in the taps' accumulation dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    return conv.conv.weight[:, 0, :].t().to(acc)


def conv_sequence(conv: ShortConv, x: torch.Tensor,
                  state: Optional[torch.Tensor] = None,
                  lengths: Optional[torch.Tensor] = None):
    """``x [N, T, H]`` (normed) from ``state [N, L-1, H]`` (None: zeros).
    Returns ``(out [N, T, H], state [N, L-1, H])``, the state as of
    position ``lengths - 1`` of each row (default: the last)."""
    n, t, h = x.shape
    u, c = _gated(conv, x)
    w = _taps(conv, x)
    taps = w.shape[0]
    if state is None:
        state = u.new_zeros(n, taps - 1, h)
    ext = torch.cat([state.to(u.dtype), u], dim=1)          # [N, T+L-1, H]
    y = sum(ext[:, j:j + t].to(w.dtype) * w[j] for j in range(taps))
    out = cnn.apply_linear(conv.out_proj, c * y.to(x.dtype))
    if lengths is None:
        return out, ext[:, t:]
    idx = lengths.long()[:, None] + torch.arange(taps - 1, device=x.device)
    new = ext.gather(1, idx[..., None].expand(n, taps - 1, h))
    return out, new


def conv_step(conv: ShortConv, x: torch.Tensor, state: torch.Tensor):
    """One token per row: ``x [B, H]`` (normed), ``state [B, L-1, H]``.
    Returns ``(out [B, H], state [B, L-1, H])``."""
    u, c = _gated(conv, x)
    w = _taps(conv, x)
    win = torch.cat([state.to(u.dtype), u[:, None]], dim=1)   # [B, L, H]
    y = (win.to(w.dtype) * w).sum(1)
    return cnn.apply_linear(conv.out_proj, c * y.to(x.dtype)), win[:, 1:]
