"""Flash-attention forward: the hand-written Hopper kernel
(``csrc/flash_fwd.cu``) and its plain PyTorch version.

Replaces the TPU kernel ``vyomai_tpu/ops/flash_attention.py`` ``_fwd_kernel``
(forward only; the window and segment-id variants and the two backward
kernels are not ported yet). Contract, shared by both versions here:

- q: [B, H, Lq, D]; k, v: [B, H_kv, Lk, D]; q head ``h`` reads kv head
  ``h // (H // H_kv)``.
- ``bias``: additive fp32 ``[B|1, H|1, Lq|1, Lk]`` or None.
- ``causal``: keys after ``q_offset + row`` are masked (``q_offset``
  defaults to ``Lk - Lq``, queries aligned to the end of the keys).
- Scores ``q.k / sqrt(D)``, softmax and the value sum run in fp32.
  Masked scores take ``NEG_INF``; the running max is floored at ``-1e30``,
  so a fully-masked row gives output 0 and lse ``-1e30``.
- Returns ``(out [B, H, Lq, D] in q's dtype, lse [B, H, Lq] fp32)``.

:func:`flash_attention_fwd` routes a CPU tensor to
:func:`flash_attention_fwd_ref` and launches the kernel for a CUDA tensor;
there is no fallback between the two.
"""

from typing import Optional

import torch

from . import _build
from ..core.masks import NEG_INF

_DTYPES = (torch.bfloat16, torch.float32)


def flash_attention_fwd_ref(q, k, v, bias=None, *, causal: bool = False,
                            q_offset: Optional[int] = None):
    """Plain PyTorch version of the kernel (same contract, full softmax)."""
    b, h, lq, d = q.shape
    h_kv, lk = k.shape[1], k.shape[2]
    group = h // h_kv
    if q_offset is None:
        q_offset = lk - lq
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    kk = k.repeat_interleave(group, dim=1).to(acc)
    vv = v.repeat_interleave(group, dim=1).to(acc)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), kk) * (1.0 / d ** 0.5)
    if causal:
        q_pos = q_offset + torch.arange(lq, device=q.device)[:, None]
        k_pos = torch.arange(lk, device=q.device)[None, :]
        s = s + torch.where(k_pos <= q_pos, 0.0, NEG_INF).to(acc)
    if bias is not None:
        s = s + bias.to(acc)
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, 1.0, l)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vv) / l_safe
    lse = (m + torch.log(l_safe))[..., 0]
    return out.to(q.dtype), lse       # lse stays in the accumulation dtype


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"flash_attention_fwd: {msg}")


def flash_attention_fwd(q, k, v, bias=None, *, causal: bool = False,
                        q_offset: Optional[int] = None):
    """Flash-attention forward. CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise on what it does not take)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, bias, causal=causal,
                                       q_offset=q_offset)
    b, h, lq, d = q.shape
    h_kv, lk = k.shape[1], k.shape[2]
    if q_offset is None:
        q_offset = lk - lq
    tensors = (q, k, v) if bias is None else (q, k, v, bias)
    _check(all(t.is_cuda and t.device == q.device for t in tensors),
           "all tensors on one CUDA device")
    _check(q.dtype in _DTYPES and k.dtype == q.dtype and v.dtype == q.dtype,
           f"q/k/v must share a dtype in {_DTYPES}")
    _check(d in (64, 128), f"head_dim {d} not in (64, 128)")
    _check(k.shape == (b, h_kv, lk, d) and v.shape == k.shape
           and h % h_kv == 0, "k/v must be [B, H_kv, Lk, D], H % H_kv == 0")
    _check(all(t.is_contiguous() for t in (q, k, v)),
           "q/k/v must be contiguous")
    _check(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
           "q/k/v must be 16-byte aligned")
    sb = sh = sq = 0
    if bias is not None:
        _check(bias.dtype == torch.float32, "bias must be float32")
        _check(bias.dim() == 4 and bias.shape[0] in (1, b)
               and bias.shape[1] in (1, h) and bias.shape[2] in (1, lq)
               and bias.shape[3] == lk, "bias must be [B|1, H|1, Lq|1, Lk]")
        _check(bias.stride(3) == 1, "bias must be contiguous in Lk")
        sb, sh, sq = (0 if bias.shape[i] == 1 else bias.stride(i)
                      for i in range(3))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = _build.library()
    err = lib.flash_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, h, h_kv, lq, lk, d, sb, sh, sq, int(causal),
        int(q_offset), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0
