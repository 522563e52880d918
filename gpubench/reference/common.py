"""What every family's float32 reference shares: the weights of a group
made again from the seed (``gpubench.weights``) and held in float32, its
own int8 weight quantizer, RMSNorm, RoPE (rotate-half convention), and the
reading of the served tokens' gaps at the head. Products run with TF32
switched off."""

from contextlib import contextmanager
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import weights as W


def quantize_int8(w: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 per output row of ``w [out, in]`` (a token table: per
    token), returned dequantized in float32: ``round(w / s)`` clipped to
    +-127, times ``s = max|row| / 127`` (1 for an all-zero row)."""
    w = w.to(torch.float32)
    amax = w.abs().amax(dim=1, keepdim=True)
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.clamp(torch.round(w / s), -127, 127) * s


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(t: int, hd: int, theta: float, device):
    """``(cos, sin)`` of positions ``0..t-1``, each ``[t, 1, hd]``."""
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=device) / hd)
    ang = torch.arange(t, dtype=torch.float64, device=device)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos().float()[:, None], ang.sin().float()[:, None]


def rotate(x, cos, sin):
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


def group(cfg, seed, name, device, dtype, std, quant) -> dict:
    """The group's tensors in float32; with ``quant="int8"`` every matrix
    (the token table too) through :func:`quantize_int8`, as a weight-only
    int8 deployment stores them."""
    out = {}
    for key, t in W.make_group(cfg, seed, name, device, dtype, std).items():
        out[key] = (quantize_int8(t) if quant == "int8" and t.dim() == 2
                    else t.to(torch.float32))
    return out


@contextmanager
def float32_products():
    """TF32 off for matmuls and convolutions, restored on leaving."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def tokens(seqs: Sequence[Tuple[np.ndarray, int]], device) -> list:
    return [torch.as_tensor(np.asarray(t, dtype=np.int64), device=device)
            for t, _ in seqs]


def head_gaps(seqs, toks, hs, norm, head, eps: float,
              head_rows: int = 256) -> List[np.ndarray]:
    """For each ``(tokens, n_prompt)`` and its last hidden states ``h``:
    the logits (final RMSNorm, then ``head``) at every position that chose
    a served token (``n_prompt - 1`` to the one before last), ``head_rows``
    rows at a time, and for each the gap ``max logit - logit of the served
    token`` (0 where the served token is the reference's best)."""
    gaps = []
    for (_, n_prompt), t, h in zip(seqs, toks, hs):
        x = rms(h[n_prompt - 1:-1], norm, eps)
        target = t[n_prompt:]
        out = []
        for a in range(0, x.shape[0], head_rows):
            logits = x[a:a + head_rows] @ head.T
            best = logits.max(-1).values
            got = logits.gather(1, target[a:a + head_rows, None])[:, 0]
            out.append((best - got).cpu())
        gaps.append(torch.cat(out).numpy().astype(np.float64))
    return gaps
