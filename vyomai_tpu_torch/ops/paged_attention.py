"""Paged KV pool ops (counterpart of ``vyomai_tpu.ops.paged_attention``).

Pool layout, as in the JAX package: ``[NB, 2, BS, H_kv * D]`` per layer
(k in row 0, v in row 1), stacked ``[L, ...]`` across layers. Block tables
are int32 ``[B, MAXB]`` with ``-1`` for unused entries.

Quantized pools, as in the JAX package:

- int8: rows quantized symmetrically at write time (:func:`quantize_rows`,
  amax/127 over the row, floored at 1e-8), one fp32 scale per written row
  in the ``scales [NB, 2, BS]`` sidecar;
- int4: ``H_kv * D / 2`` bytes per row, packed per-head-local split halves
  (:func:`pack_int4_rows`: byte j of head g holds feature j in its low
  nibble and feature j + D/2 in its high one), one fp32 scale per
  (row, kv head) in ``scales [NB, 2, H_kv, BS]``.

Every consumer tells int4 from int8 by the sidecar's rank, as JAX does.
"""

import torch

from ..core.masks import NEG_INF

_INT8_EPS = 1e-8
_INT4_EPS = 1e-8


def quantize_rows(x: torch.Tensor):
    """Symmetric per-row int8. x: [T, W] float. Returns (q int8 [T, W],
    scale f32 [T])."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax / 127.0, _INT8_EPS)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def pack_int4_rows(q4: torch.Tensor, h_kv: int) -> torch.Tensor:
    """Pack int4 values (in [-8, 7]) [T, H_kv*D] -> int8 [T, H_kv*D/2],
    per-head-local split halves."""
    t, width = q4.shape
    d = width // h_kv
    x = q4.to(torch.int32).reshape(t, h_kv, d)
    lo, hi = x[..., :d // 2], x[..., d // 2:]
    packed = hi * 16 + (lo & 15)            # exact int8 range [-128, 127]
    return packed.reshape(t, width // 2).to(torch.int8)


def unpack_int4_rows(p8: torch.Tensor, h_kv: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4_rows`: int8 [..., W/2] -> int32 [..., W]
    in natural feature order."""
    p32 = p8.to(torch.int32)
    lo, hi = ((p32 & 15) ^ 8) - 8, p32 >> 4
    lead = p8.shape[:-1]
    half = p8.shape[-1] // h_kv             # D/2
    lo = lo.reshape(*lead, h_kv, half)
    hi = hi.reshape(*lead, h_kv, half)
    return torch.cat([lo, hi], dim=-1).reshape(*lead, 2 * p8.shape[-1])


def quantize_rows_int4(x: torch.Tensor, h_kv: int):
    """Symmetric per-(row, head) int4 quantization + packing. x: [T, H_kv*D]
    float. Returns (packed int8 [T, H_kv*D/2], scale f32 [T, H_kv])."""
    t, width = x.shape
    d = width // h_kv
    xf = x.to(torch.float32).reshape(t, h_kv, d)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax / 7.0, _INT4_EPS)
    q = torch.clamp(torch.round(xf / scale), -7, 7).to(torch.int32)
    return pack_int4_rows(q.reshape(t, width), h_kv), scale[..., 0]


def write_kv(pool: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
             slot_block: torch.Tensor, slot_offset: torch.Tensor,
             scales=None) -> None:
    """Scatter new K/V rows into ``pool`` (and a quantized pool's
    ``scales``) IN PLACE.

    pool: [NB, 2, BS, W] (W/2 packed bytes for int4); k_new/v_new:
    [T, H_kv, D] (W = H_kv*D); slot_block/slot_offset: [T] int. Rows with
    ``slot_block < 0`` are dropped. The JAX version redirects them out of
    range with ``mode="drop"``; torch raises on an out-of-range index and
    gives no defined winner among duplicate indices, and selecting the live
    rows with a boolean mask would stall the host on every layer. So each
    dead row takes the target AND the stored values of one live row: its
    quantized bytes and its scale, so colliding writes store identical
    values, whichever lands last. With no live row at all, every row
    rewrites one slot's current contents."""
    t, h_kv = k_new.shape[0], k_new.shape[1]
    keep = slot_block >= 0
    # a live row, if any; kept as a 1-element index (a 0-d index tensor
    # would be read back to the host)
    first = torch.argmax(keep.to(torch.int32)).unsqueeze(0)
    blk = torch.where(keep, slot_block, slot_block[first]).clamp_min(0)
    off = torch.where(keep, slot_offset, slot_offset[first])
    k_flat, v_flat = k_new.reshape(t, -1), v_new.reshape(t, -1)
    if scales is not None and scales.dim() == 4:          # int4
        (kq, ks), (vq, vs) = (quantize_rows_int4(k_flat, h_kv),
                              quantize_rows_int4(v_flat, h_kv))
        sc = torch.stack([ks, vs], dim=1)                  # [T, 2, H_kv]
    elif scales is not None:                               # int8
        (kq, ks), (vq, vs) = quantize_rows(k_flat), quantize_rows(v_flat)
        sc = torch.stack([ks, vs], dim=1)                  # [T, 2]
    else:
        kq, vq, sc = k_flat, v_flat, None
    kv = torch.stack([kq, vq], dim=1).to(pool.dtype)       # [T, 2, W']
    kv = torch.where(keep[:, None, None], kv, kv[first])
    kv = torch.where(keep.any(), kv, pool[blk, :, off])
    pool[blk, :, off] = kv
    if sc is None:
        return
    live = keep.reshape(-1, *([1] * (sc.dim() - 1)))
    sc = torch.where(live, sc, sc[first])
    if scales.dim() == 4:
        sc = torch.where(keep.any(), sc, scales[blk, :, :, off])
        scales[blk, :, :, off] = sc
    else:
        sc = torch.where(keep.any(), sc, scales[blk, :, off])
        scales[blk, :, off] = sc


def gather_kv(pool: torch.Tensor, tables: torch.Tensor, h_kv: int,
              scales=None):
    """Gather contexts from the pool. tables: [..., MAXB] (entries >= 0).
    Returns (k, v), each [..., H_kv, MAXB*BS, D]; quantized pools come back
    dequantized in fp32."""
    lead = tables.shape[:-1]
    maxb = tables.shape[-1]
    _, _, bs, width = pool.shape
    kv = pool[tables]                          # [..., MAXB, 2, BS, W']
    if scales is not None and scales.dim() == 4:           # int4
        sc = scales[tables]                    # [..., MAXB, 2, H_kv, BS]
        d = (2 * width) // h_kv
        kv = unpack_int4_rows(kv, h_kv).to(torch.float32)
        kv = kv.reshape(*lead, maxb, 2, bs, h_kv, d) * \
            sc.transpose(-1, -2)[..., None]
    else:
        d = width // h_kv
        if scales is not None:                              # int8
            kv = kv.to(torch.float32) * scales[tables][..., None]
        kv = kv.reshape(*lead, maxb, 2, bs, h_kv, d)
    n = len(lead)
    kv = kv.permute(*range(n), n + 1, n + 3, n, n + 2, n + 4)
    kv = kv.reshape(*lead, 2, h_kv, maxb * bs, d)
    return kv[..., 0, :, :, :], kv[..., 1, :, :, :]


def paged_attention_decode(q: torch.Tensor, pool: torch.Tensor,
                           block_tables: torch.Tensor,
                           seq_lens: torch.Tensor, h_kv: int,
                           scales=None) -> torch.Tensor:
    """Single-token decode attention over paged KV, the JAX package's
    gather fallback: masked full softmax over the (dequantized) context, so
    a dead lane (seq_len 0) gives the mean of V (the kernel and its plain
    version in ``ops.paged_decode`` give 0 there). q: [B, H, D]. Returns
    [B, H, D]."""
    b, h, d = q.shape
    group = h // h_kv
    tables = block_tables.clamp_min(0)
    k, v = gather_kv(pool, tables, h_kv, scales)   # [B, H_kv, T, D]
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    k = k.repeat_interleave(group, dim=1).to(acc)
    v = v.repeat_interleave(group, dim=1).to(acc)
    scores = torch.einsum("bhd,bhtd->bht", q.to(acc), k) * (1.0 / d ** 0.5)
    t_pos = torch.arange(k.shape[2], device=q.device)
    valid = t_pos[None, :] < seq_lens[:, None]
    scores = scores.masked_fill(~valid[:, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bht,bhtd->bhd", probs, v).to(q.dtype)
