"""Paged-decode attention: the hand-written Hopper kernel
(``csrc/paged_decode.cu``) and its plain PyTorch version.

Replaces the TPU kernel ``vyomai_tpu/ops/paged_decode_pallas.py`` ``_kernel``
for bf16/fp32 pools and for its int8 and int4 pools (the window and sinks
variants are not ported yet). Contract, shared by both versions here:

- q: [B, H, D]; pool: [NB, 2, BS, H_kv*D] (``H_kv*D/2`` int8 bytes for
  int4); block_tables: [B, MAXB] int32 (``-1`` entries read block 0);
  seq_lens: [B] int32. ``scales``: None for a float pool of q's dtype,
  ``[NB, 2, BS]`` fp32 for int8, ``[NB, 2, H_kv, BS]`` fp32 for int4.
  Returns [B, H, D] in q's dtype.
- q is scaled by ``1/sqrt(D)`` in fp32 and rounded to q's dtype before the
  dots (the TPU wrapper's order); scores, softmax and the value sum are
  fp32. Quantized pools: the scores of the integer keys are multiplied by
  the key row's scale, and each probability by the value row's scale after
  the softmax denominator has summed the unscaled ones (the TPU kernel's
  order).
- Live length is ``min(seq_len, MAXB*BS)``; a lane with seq_len 0 gives 0.

:func:`paged_decode` routes a CPU tensor to :func:`paged_attention_decode_ref`
and launches the kernel for a CUDA tensor; there is no fallback between the
two. On the card a call is a split-KV pair (flash decoding): each lane's
context is cut into partitions of ``P`` tokens (:func:`_decode_plan`, from
shapes alone), one CTA per (lane, kv head, partition) writes the
partition's fp32 ``(m, l, acc)`` to a workspace, and a second kernel
combines the live partitions in split order; with one partition the first
kernel writes the output. :func:`paged_attention_decode_split_ref` is that
algebra in plain PyTorch, for the tests. Each wrapper counts one launch per
call, both kernels together, per variant: ``paged_decode.launches`` (float
pools), ``paged_decode_int8.launches`` and ``paged_decode_int4.launches``.
"""

import torch

from . import _build
from .paged_attention import unpack_int4_rows

_DTYPES = (torch.bfloat16, torch.float32)

# CTAs a call's grid aims at: about 16 for each of an H100's 132 SMs, so
# that the live partitions of a batch whose lanes are half full still fill
# the card several times over
_TARGET_CTAS = 2048
_MAX_TABLE = 256   # table entries one partition spans (csrc kMaxTable)


def _decode_plan(b: int, h_kv: int, bs: int, maxb: int):
    """``(P, S)``: the partition of each lane's context (P tokens, a
    multiple of ``bs``) and the splits ``S = ceil(maxb * bs / P)`` of the
    grid ``b x h_kv x S``.

    P is the split length that puts about ``_TARGET_CTAS`` CTAs in the
    grid, rounded up to whole blocks: P = 64, S = 16 at B=16, H_kv=8,
    MAXB=64, BS=16; one block a split for a single lane. A partition spans
    at most ``_MAX_TABLE`` blocks, so the grid is at most
    ``max(_TARGET_CTAS + b * h_kv, b * h_kv * ceil(maxb / _MAX_TABLE))``.
    The plan reads shapes only, never ``seq_lens``, so the launch needs no
    synchronisation and a CUDA graph can capture it."""
    tokens = maxb * bs
    want = max(1, -(-_TARGET_CTAS // max(1, b * h_kv)))
    p = -(-max(tokens, 1) // want)
    p = min(-(-p // bs) * bs, _MAX_TABLE * bs)
    return p, max(1, -(-tokens // p))


def _scaled_q(q: torch.Tensor) -> torch.Tensor:
    d = q.shape[-1]
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    return (q.to(acc) * (1.0 / d ** 0.5)).to(q.dtype).to(acc)


def _gather(pool, tables, h_kv: int, scales):
    """The context's K/V as stored values ``[B, H_kv, T, D]`` (integers for
    quantized pools) and their row scales ``[B, H_kv, T]`` (None for float
    pools)."""
    b, maxb = tables.shape
    _, _, bs, width = pool.shape
    kv = pool[tables]                                    # [B, MAXB, 2, BS, W']
    sc = None
    if scales is not None and scales.dim() == 4:         # int4
        kv = unpack_int4_rows(kv, h_kv)
        sc = scales[tables].permute(0, 2, 3, 1, 4)       # [B, 2, H_kv, MAXB, BS]
    elif scales is not None:                              # int8
        sc = scales[tables].permute(0, 2, 1, 3)[:, :, None]   # [B,2,1,MAXB,BS]
        sc = sc.expand(b, 2, h_kv, maxb, bs)
    d = kv.shape[-1] // h_kv
    kv = kv.reshape(b, maxb, 2, bs, h_kv, d).permute(2, 0, 4, 1, 3, 5)
    kv = kv.reshape(2, b, h_kv, maxb * bs, d)
    if sc is not None:
        sc = sc.reshape(b, 2, h_kv, maxb * bs).transpose(0, 1)
        return kv[0], kv[1], sc[0], sc[1]
    return kv[0], kv[1], None, None


def paged_attention_decode_ref(q, pool, block_tables, seq_lens, h_kv: int,
                               scales=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same contract, full softmax)."""
    b, h, d = q.shape
    group = h // h_kv
    qs = _scaled_q(q)
    k, v, ks, vs = _gather(pool, block_tables.clamp_min(0).long(), h_kv,
                           scales)
    k = k.repeat_interleave(group, dim=1).to(qs.dtype)   # [B, H, T, D]
    v = v.repeat_interleave(group, dim=1).to(qs.dtype)
    s = torch.einsum("bhd,bhtd->bht", qs, k)
    if ks is not None:
        s = s * ks.repeat_interleave(group, dim=1).to(qs.dtype)
    t_pos = torch.arange(k.shape[2], device=q.device)
    valid = t_pos[None, :] < seq_lens[:, None].to(torch.long)
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if vs is not None:   # after l: the value scale folds into p
        p = p * vs.repeat_interleave(group, dim=1).to(qs.dtype)
    out = torch.einsum("bht,bhtd->bhd", p, v) / torch.where(l == 0, 1.0, l)
    return out.to(q.dtype)


def paged_attention_decode_split_ref(q, pool, block_tables, seq_lens,
                                     h_kv: int, scales=None, *,
                                     partition: int) -> torch.Tensor:
    """The kernel pair's algebra in plain PyTorch (for the tests): the
    context cut into ``partition``-token splits, each split's ``m`` (its
    max, floored at -1e30), ``l`` (the sum of its unscaled ``p``) and
    unnormalised ``acc`` (``p`` times the value scale, times v), then
    ``out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s`` over the live
    splits (``M = max m_s``; no live split gives 0)."""
    b, h, d = q.shape
    group = h // h_kv
    qs = _scaled_q(q)
    k, v, ks, vs = _gather(pool, block_tables.clamp_min(0).long(), h_kv,
                           scales)
    t = k.shape[2]
    n_split = max(1, -(-t // partition))
    pad = n_split * partition - t

    def split(x):   # [B, H_kv, T, ...] -> [B, H, S, P, ...]
        x = x.repeat_interleave(group, dim=1).to(qs.dtype)
        x = torch.nn.functional.pad(x, (0, 0) * (x.dim() - 3) + (0, pad))
        return x.reshape(b, h, n_split, partition, *x.shape[3:])

    s = torch.einsum("bhd,bhspd->bhsp", qs, split(k))
    if ks is not None:
        s = s * split(ks)
    t_pos = torch.arange(n_split * partition, device=q.device).reshape(
        n_split, partition)
    n = seq_lens.to(torch.long).clamp(0, t)[:, None, None, None]
    s = s.masked_fill(~(t_pos < n), float("-inf"))
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)          # [B,H,S,1]
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if vs is not None:   # after l: the value scale folds into p
        p = p * split(vs)
    acc = torch.einsum("bhsp,bhspd->bhsd", p, split(v))
    live = (t_pos[:, 0] < n[..., 0])[..., None]                  # [B,1,S,1]
    m = m.masked_fill(~live, float("-inf"))
    big = m.amax(dim=2, keepdim=True).clamp_min(-1e30)
    w = torch.exp(m - big)
    den = (w * l).sum(dim=2)
    out = (w * acc).sum(dim=2) / torch.where(den == 0, 1.0, den)
    return out.to(q.dtype)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"paged_decode: {msg}")


def _launch(q, pool, block_tables, seq_lens, h_kv: int, scales, quant: int):
    b, h, d = q.shape
    nb, two, bs, width = pool.shape
    maxb = block_tables.shape[1]
    _check(q.is_cuda and pool.device == q.device
           and block_tables.device == q.device
           and seq_lens.device == q.device
           and (scales is None or scales.device == q.device),
           "all tensors on one CUDA device")
    _check(q.dtype in _DTYPES, f"q dtype {q.dtype} not in {_DTYPES}")
    _check(pool.dtype == (q.dtype if quant == 0 else torch.int8),
           "a float pool shares q's dtype; a quantized pool is int8")
    _check(block_tables.dtype == torch.int32 and seq_lens.dtype == torch.int32,
           "block_tables and seq_lens must be int32")
    _check(d in (64, 128), f"head_dim {d} not in (64, 128)")
    _check(h % h_kv == 0 and h // h_kv <= 8, "H/H_kv must be an int <= 8")
    _check(two == 2 and width == (h_kv * d // 2 if quant == 2 else h_kv * d),
           "pool must be [NB, 2, BS, H_kv*D] (H_kv*D/2 bytes for int4)")
    if quant:
        want = (nb, 2, h_kv, bs) if quant == 2 else (nb, 2, bs)
        _check(scales.dtype == torch.float32 and tuple(scales.shape) == want
               and scales.is_contiguous(), f"scales must be fp32 {want}")
    _check(tuple(block_tables.shape) == (b, maxb)
           and tuple(seq_lens.shape) == (b,), "table/length shapes")
    _check(all(t.is_contiguous() for t in (q, pool, block_tables, seq_lens)),
           "inputs must be contiguous")
    _check(q.data_ptr() % 16 == 0 and pool.data_ptr() % 16 == 0,
           "q and pool must be 16-byte aligned")
    out = torch.empty_like(q)
    if b == 0:
        return out, False
    part, splits = _decode_plan(b, h_kv, bs, maxb)
    ws_acc = ws_ml = None
    if splits > 1:   # the partitions' (acc, m/l), combined by kernel 2
        ws_acc = torch.empty(b, h, splits, d, dtype=torch.float32,
                             device=q.device)
        ws_ml = torch.empty(b, h, splits, 2, dtype=torch.float32,
                            device=q.device)
    lib = _build.library()
    err = lib.paged_decode_launch(
        q.data_ptr(), pool.data_ptr(),
        None if scales is None else scales.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        None if ws_acc is None else ws_acc.data_ptr(),
        None if ws_ml is None else ws_ml.data_ptr(), b, h, h_kv, d, bs, maxb,
        width, quant, int(q.dtype == torch.bfloat16), part, splits,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_decode")
    return out, True


def paged_decode_int8(q, pool, block_tables, seq_lens, h_kv: int,
                      scales) -> torch.Tensor:
    """The int8-pool variant (``scales [NB, 2, BS]``)."""
    if q.device.type == "cpu":
        return paged_attention_decode_ref(q, pool, block_tables, seq_lens,
                                          h_kv, scales)
    out, ran = _launch(q, pool, block_tables, seq_lens, h_kv, scales, 1)
    paged_decode_int8.launches += int(ran)
    return out


def paged_decode_int4(q, pool, block_tables, seq_lens, h_kv: int,
                      scales) -> torch.Tensor:
    """The int4-pool variant (``scales [NB, 2, H_kv, BS]``)."""
    if q.device.type == "cpu":
        return paged_attention_decode_ref(q, pool, block_tables, seq_lens,
                                          h_kv, scales)
    out, ran = _launch(q, pool, block_tables, seq_lens, h_kv, scales, 2)
    paged_decode_int4.launches += int(ran)
    return out


def paged_decode(q, pool, block_tables, seq_lens, h_kv: int,
                 scales=None) -> torch.Tensor:
    """Paged-decode attention over a float pool, or over a quantized one
    when ``scales`` is given (int4 when it has rank 4). CPU tensors take
    the plain version; CUDA tensors launch the kernel (or raise on what it
    does not take)."""
    if scales is not None:
        fn = paged_decode_int4 if scales.dim() == 4 else paged_decode_int8
        return fn(q, pool, block_tables, seq_lens, h_kv, scales)
    if q.device.type == "cpu":
        return paged_attention_decode_ref(q, pool, block_tables, seq_lens,
                                          h_kv)
    out, ran = _launch(q, pool, block_tables, seq_lens, h_kv, None, 0)
    paged_decode.launches += int(ran)
    return out


paged_decode.launches = 0
paged_decode_int8.launches = 0
paged_decode_int4.launches = 0
