"""Paged-decode attention: the hand-written Hopper kernel
(``csrc/paged_decode.cu``) and its plain PyTorch version.

Replaces the TPU kernel ``vyomai_tpu/ops/paged_decode_pallas.py`` ``_kernel``
(bf16/fp32 pool; the window, sinks, int8 and int4 variants are not ported
yet). Contract, shared by both versions here:

- q: [B, H, D]; pool: [NB, 2, BS, H_kv*D]; block_tables: [B, MAXB] int32
  (``-1`` entries read block 0); seq_lens: [B] int32. Returns [B, H, D] in
  q's dtype.
- q is scaled by ``1/sqrt(D)`` in fp32 and rounded to q's dtype before the
  dots (the TPU wrapper's order); scores, softmax and the value sum are
  fp32.
- Live length is ``min(seq_len, MAXB*BS)``; a lane with seq_len 0 gives 0.

:func:`paged_decode` routes a CPU tensor to :func:`paged_attention_decode_ref`
and launches the kernel for a CUDA tensor; there is no fallback between the
two.
"""

import torch

from . import _build
from .paged_attention import gather_kv

_DTYPES = (torch.bfloat16, torch.float32)


def _scaled_q(q: torch.Tensor) -> torch.Tensor:
    d = q.shape[-1]
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    return (q.to(acc) * (1.0 / d ** 0.5)).to(q.dtype).to(acc)


def paged_attention_decode_ref(q, pool, block_tables, seq_lens,
                               h_kv: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same contract, full softmax)."""
    b, h, d = q.shape
    group = h // h_kv
    qs = _scaled_q(q)
    k, v = gather_kv(pool, block_tables.clamp_min(0).long(), h_kv)
    k = k.repeat_interleave(group, dim=1).to(qs.dtype)   # [B, H, T, D]
    v = v.repeat_interleave(group, dim=1).to(qs.dtype)
    s = torch.einsum("bhd,bhtd->bht", qs, k)
    t_pos = torch.arange(k.shape[2], device=q.device)
    valid = t_pos[None, :] < seq_lens[:, None].to(torch.long)
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bht,bhtd->bhd", p, v) / torch.where(l == 0, 1.0, l)
    return out.to(q.dtype)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"paged_decode: {msg}")


def paged_decode(q, pool, block_tables, seq_lens, h_kv: int) -> torch.Tensor:
    """Paged-decode attention. CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise on what it does not take)."""
    if q.device.type == "cpu":
        return paged_attention_decode_ref(q, pool, block_tables, seq_lens,
                                          h_kv)
    b, h, d = q.shape
    nb, two, bs, width = pool.shape
    maxb = block_tables.shape[1]
    _check(q.is_cuda and pool.device == q.device
           and block_tables.device == q.device
           and seq_lens.device == q.device, "all tensors on one CUDA device")
    _check(q.dtype in _DTYPES and pool.dtype == q.dtype,
           f"q/pool must share a dtype in {_DTYPES}")
    _check(block_tables.dtype == torch.int32 and seq_lens.dtype == torch.int32,
           "block_tables and seq_lens must be int32")
    _check(d in (64, 128), f"head_dim {d} not in (64, 128)")
    _check(h % h_kv == 0 and h // h_kv <= 8, "H/H_kv must be an int <= 8")
    _check(two == 2 and width == h_kv * d, "pool must be [NB, 2, BS, H_kv*D]")
    _check(tuple(block_tables.shape) == (b, maxb)
           and tuple(seq_lens.shape) == (b,), "table/length shapes")
    _check(all(t.is_contiguous() for t in (q, pool, block_tables, seq_lens)),
           "inputs must be contiguous")
    _check(q.data_ptr() % 16 == 0 and pool.data_ptr() % 16 == 0,
           "q and pool must be 16-byte aligned")
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _build.library()
    err = lib.paged_decode_launch(
        q.data_ptr(), pool.data_ptr(), block_tables.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(), b, h, h_kv, d, bs, maxb, width,
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_decode")
    paged_decode.launches += 1
    return out


paged_decode.launches = 0
