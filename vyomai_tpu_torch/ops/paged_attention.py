"""Paged KV pool ops (counterpart of ``vyomai_tpu.ops.paged_attention``).

Pool layout, as in the JAX package: ``[NB, 2, BS, H_kv * D]`` per layer
(k in row 0, v in row 1), stacked ``[L, ...]`` across layers. Block tables
are int32 ``[B, MAXB]`` with ``-1`` for unused entries. Float pools only
(bf16/fp32/fp64); the int8/int4 pools come later.
"""

import torch

from ..core.masks import NEG_INF


def write_kv(pool: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
             slot_block: torch.Tensor, slot_offset: torch.Tensor) -> None:
    """Scatter new K/V rows into ``pool`` IN PLACE.

    pool: [NB, 2, BS, W]; k_new/v_new: [T, H_kv, D] (W = H_kv*D);
    slot_block/slot_offset: [T] int. Rows with ``slot_block < 0`` are
    dropped. The JAX version redirects them out of range with
    ``mode="drop"``; torch raises on an out-of-range index and gives no
    defined winner among duplicate indices, and selecting the live rows
    with a boolean mask would stall the host on every layer. So each dead
    row takes the target AND the values of one live row: colliding writes
    then store identical values, whichever lands last. With no live row at
    all, every row rewrites one slot's current contents."""
    t = k_new.shape[0]
    keep = slot_block >= 0
    # a live row, if any; kept as a 1-element index (a 0-d index tensor
    # would be read back to the host)
    first = torch.argmax(keep.to(torch.int32)).unsqueeze(0)
    blk = torch.where(keep, slot_block, slot_block[first]).clamp_min(0)
    off = torch.where(keep, slot_offset, slot_offset[first])
    kv = torch.stack([k_new.reshape(t, -1), v_new.reshape(t, -1)],
                     dim=1).to(pool.dtype)           # [T, 2, W]
    kv = torch.where(keep[:, None, None], kv, kv[first])
    kv = torch.where(keep.any(), kv, pool[blk, :, off])
    pool[blk, :, off] = kv


def gather_kv(pool: torch.Tensor, tables: torch.Tensor, h_kv: int):
    """Gather contexts from the pool. tables: [..., MAXB] (entries >= 0).
    Returns (k, v), each [..., H_kv, MAXB*BS, D]."""
    lead = tables.shape[:-1]
    maxb = tables.shape[-1]
    _, _, bs, width = pool.shape
    d = width // h_kv
    kv = pool[tables]                          # [..., MAXB, 2, BS, W]
    kv = kv.reshape(*lead, maxb, 2, bs, h_kv, d)
    n = len(lead)
    kv = kv.permute(*range(n), n + 1, n + 3, n, n + 2, n + 4)
    kv = kv.reshape(*lead, 2, h_kv, maxb * bs, d)
    return kv[..., 0, :, :, :], kv[..., 1, :, :, :]


def paged_attention_decode(q: torch.Tensor, pool: torch.Tensor,
                           block_tables: torch.Tensor,
                           seq_lens: torch.Tensor, h_kv: int) -> torch.Tensor:
    """Single-token decode attention over paged KV, the JAX package's
    gather fallback: masked full softmax, so a dead lane (seq_len 0) gives
    the mean of V (the kernel and its plain version in ``ops.paged_decode``
    give 0 there). q: [B, H, D]. Returns [B, H, D]."""
    b, h, d = q.shape
    group = h // h_kv
    tables = block_tables.clamp_min(0)
    k, v = gather_kv(pool, tables, h_kv)       # [B, H_kv, T, D]
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    k = k.repeat_interleave(group, dim=1).to(acc)
    v = v.repeat_interleave(group, dim=1).to(acc)
    scores = torch.einsum("bhd,bhtd->bht", q.to(acc), k) * (1.0 / d ** 0.5)
    t_pos = torch.arange(k.shape[2], device=q.device)
    valid = t_pos[None, :] < seq_lens[:, None]
    scores = scores.masked_fill(~valid[:, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bht,bhtd->bhd", probs, v).to(q.dtype)
