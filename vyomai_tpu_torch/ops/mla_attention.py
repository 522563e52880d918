"""K13, multi-head latent attention (MLA) over the paged latent pool: the
hand-written Hopper kernels (CUDA C++, ``csrc/mla_attention.cu``) and
their plain PyTorch version.

It replaces no TPU kernel: the JAX package has no MLA. The port needs it
because no other kernel computes this attention: K1 and K4 take heads of
64 or 128 dims with keys and values of one width, read from per-head K/V
rows, while MLA's absorbed form (``layers.mla``) scores each head's query
of ``C + R`` dims (the latent query and the rotary part) against one
shared row of ``C + R`` a token, the latent ``c_kv`` and ``k_pe``, and
sums the rows' first ``C`` dims. Every head reads the same row: a "group"
of all the heads over one cached row.

Contract, shared by both versions (``C`` = ``kv_lora_rank``, ``W`` = C +
R; a pool is a layer's or the flat ``[L*NB, BS, W]`` view with
layer-offset tables, ``serving.paged_model``):

- :func:`mla_decode`: ``q [B, H, W]``, ``pool [NB, BS, W]``, ``tables [B,
  MAXB]`` int32 (``-1`` entries read block 0 under the mask), ``seq_lens
  [B]`` int32: lane ``b`` attends its first ``min(seq_len, MAXB*BS)``
  rows. Returns ``[B, H, C]``, 0 for a lane of length 0.
- :func:`mla_prefill`: ``q [N, T, H, W]``, ``tables [N, MAXB]``,
  ``positions [N, T]``, ``ctx_len``, ``true_len [N]`` int64: token ``t <
  true_len`` of row ``n`` attends rows ``j <= positions[n, t]`` with ``j <
  ctx_len`` (its cached context and the suffix up to itself, causal with
  the offset). Returns ``[N, T, H, C]``, 0 for tokens past ``true_len``.
- Scores ``scale · q·row`` over all W dims, softmax and the weighted sum
  of the rows' first C dims in fp32 (fp64 for fp64), rounded once to q's
  dtype. The kernels take bf16 at the widths they were built for (16
  heads, 512 + 64: Moonlight-16B-A3B's), round the probabilities to bf16
  for the weighted sum, as flash attention does, and keep the softmax
  online.

What bounds it on the H100, and the kernels' design, are in the source's
header: decode is bytes (30 FLOPs a byte), prefill FLOPs. Decode splits
each lane's context into partitions (flash decoding; :func:`decode_plan`,
from shapes alone, so a CUDA graph captures it), one CTA a (lane,
partition), which streams 64-row tiles of latent rows straight from the
pool through the block table, with no gather into a copy, and scores all
16 heads against each row on the tensor cores, so each row is read once
for all the heads; a combine kernel merges the partitions. Prefill: one
CTA a (row of the call, 64 (token, head) query rows) streams the
context's rows under the causal mask. Lanes that share a cached prefix
read its rows each; only L2 may keep them.

Kernel names, one per path so a trace tells them apart:
``k13_decode_split_kernel`` and ``k13_decode_combine_kernel`` (decode),
``k13_prefill_kernel`` (prefill). :func:`mla_decode` and
:func:`mla_prefill` route a CPU tensor to the plain versions
(:func:`mla_decode_ref`, :func:`mla_prefill_ref`) and launch the kernels
for a CUDA tensor, or raise on what they do not take; there is no
fallback. ``mla_decode.launches`` and ``mla_prefill.launches`` count
calls. The kernels are built with the port's others at the first launch
(``ops._build``).
"""

from __future__ import annotations

import math

import torch

from . import _build

HEADS, RANK, WIDTH = 16, 512, 576   # the widths the kernels take
_TILE = 64               # decode partitions: whole pairs of 32-row tiles
_TARGET = 1024           # decode CTAs a call aims at (~8 an SM)
_MIN_CHUNK = 256         # fewest rows a decode partition holds


# -- the plain version --------------------------------------------------------

def _acc(dtype):
    return torch.promote_types(dtype, torch.float32)


def _rows(pool, tables, n_rows: int):
    """The rows of the first ``n_rows`` context positions of each table,
    ``[B, n_rows, W]`` (a copy)."""
    bs = pool.shape[1]
    j = torch.arange(n_rows, device=pool.device)
    blk = tables.clamp_min(0).long()[:, j // bs]
    return pool[blk, (j % bs)[None]]


def _attend(q, rows, ok, rank: int, scale: float):
    """``q [B, M, W]`` against ``rows [B, K, W]`` under ``ok [B, M, K]``;
    returns ``[B, M, C]`` in q's dtype (0 where a query sees no row)."""
    acc = _acc(q.dtype)
    s = torch.einsum("bmw,bkw->bmk", q.to(acc), rows.to(acc)) * scale
    s = s.masked_fill(~ok, float("-inf"))
    m = s.amax(-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bmk,bkc->bmc", p, rows[..., :rank].to(acc))
    return (out / torch.where(l == 0, 1.0, l)).to(q.dtype)


def mla_decode_ref(q, pool, tables, seq_lens, rank: int,
                   scale: float) -> torch.Tensor:
    """The plain decode (module docstring), a full softmax."""
    n_rows = tables.shape[1] * pool.shape[1]
    rows = _rows(pool, tables, n_rows)
    live = seq_lens.long().clamp(0, n_rows)
    ok = torch.arange(n_rows, device=q.device)[None] < live[:, None]
    return _attend(q, rows, ok[:, None].expand(-1, q.shape[1], -1), rank,
                   scale)


def mla_prefill_ref(q, pool, tables, positions, ctx_len, true_len,
                    rank: int, scale: float) -> torch.Tensor:
    """The plain prefill (module docstring), a full softmax."""
    n, t, h, w = q.shape
    n_rows = tables.shape[1] * pool.shape[1]
    rows = _rows(pool, tables, n_rows)
    j = torch.arange(n_rows, device=q.device)
    ok = (j[None, None] <= positions[..., None]) & \
        (j[None, None] < ctx_len[:, None, None])
    ok &= (torch.arange(t, device=q.device)[None] < true_len[:, None])[
        ..., None]
    ok = ok[:, :, None].expand(n, t, h, n_rows).reshape(n, t * h, n_rows)
    out = _attend(q.reshape(n, t * h, w), rows, ok, rank, scale)
    return out.reshape(n, t, h, rank)


def write_latent(pool, rows, slot_block, slot_offset) -> None:
    """Scatter new latent rows ``rows [T, W]`` into ``pool [NB, BS, W]`` IN
    PLACE at ``(slot_block, slot_offset) [T]``; rows with ``slot_block <
    0`` are dropped. As ``ops.paged_attention.write_kv`` does, a dead row
    takes the target and the values of one live row (with no live row,
    every row rewrites one slot's contents), so the scatter needs no
    boolean selection, which would read back to the host."""
    keep = slot_block >= 0
    first = torch.argmax(keep.to(torch.int32)).unsqueeze(0)
    blk = torch.where(keep, slot_block, slot_block[first]).clamp_min(0)
    off = torch.where(keep, slot_offset, slot_offset[first])
    rows = torch.where(keep[:, None], rows.to(pool.dtype), rows[first].to(
        pool.dtype))
    rows = torch.where(keep.any(), rows, pool[blk, off])
    pool[blk, off] = rows


# -- dispatch -----------------------------------------------------------------

def decode_plan(b: int, maxb: int, bs: int):
    """``(chunk, splits)``: each lane's context cut into partitions of
    ``chunk`` rows (a multiple of the kernel's 64-row tile, at least
    ``_MIN_CHUNK``), so that about ``_TARGET`` CTAs fill the card; from
    shapes alone, so the launch reads nothing from the device."""
    rows = max(maxb * bs, 1)
    want = max(1, -(-_TARGET // max(b, 1)))
    chunk = max(_MIN_CHUNK, -(-rows // want))
    chunk = -(-chunk // _TILE) * _TILE
    return chunk, -(-rows // chunk)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"K13: {msg}")


def _check_common(q, pool, tables, rank: int):
    h, w = q.shape[-2:]
    _check(q.dtype == torch.bfloat16 and pool.dtype == torch.bfloat16,
           f"takes a bf16 query and pool, not {q.dtype} and {pool.dtype}")
    _check((h, rank, w) == (HEADS, RANK, WIDTH),
           f"takes {HEADS} heads over a {RANK} + {WIDTH - RANK} latent row, "
           f"not {h} heads, latent {rank}, row {w}")
    _check(pool.dim() == 3 and pool.shape[2] == w,
           f"pool must be [NB, BS, {w}], got {tuple(pool.shape)}")
    bs = pool.shape[1]
    _check(bs > 0 and bs & (bs - 1) == 0, f"block size {bs}: a power of 2")
    _check(tables.dtype == torch.int32, "tables must be int32")
    for t in (q, pool, tables):
        _check(t.is_cuda and t.device == q.device and t.is_contiguous(),
               "contiguous tensors on one CUDA device")
    _check(q.data_ptr() % 16 == 0 and pool.data_ptr() % 16 == 0,
           "q and pool must be 16-byte aligned")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def mla_decode(q, pool, tables, seq_lens, rank: int,
               scale: float) -> torch.Tensor:
    """``[B, H, C]`` (module docstring): the plain version on the CPU, K13's
    decode pair on the card."""
    if not q.is_cuda:
        return mla_decode_ref(q, pool, tables, seq_lens, rank, scale)
    _check_common(q, pool, tables, rank)
    b, h, _ = q.shape
    maxb = tables.shape[1]
    bs = pool.shape[1]
    _check(seq_lens.dtype == torch.int32 and seq_lens.shape == (b,)
           and seq_lens.device == q.device and tables.shape[0] == b,
           "seq_lens int32 [B], tables [B, MAXB]")
    out = torch.empty(b, h, rank, dtype=q.dtype, device=q.device)
    if b == 0:
        return out
    chunk, splits = decode_plan(b, maxb, bs)
    ws_acc = ws_ml = None
    if splits > 1:   # the partitions' sums and (m, l), merged by the combine
        ws_acc = torch.empty(b, splits, h, rank, dtype=torch.float32,
                             device=q.device)
        ws_ml = torch.empty(b, splits, h, 2, dtype=torch.float32,
                            device=q.device)
    err = _build.library().mla_decode_launch(
        q.data_ptr(), pool.data_ptr(), tables.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(),
        None if ws_acc is None else ws_acc.data_ptr(),
        None if ws_ml is None else ws_ml.data_ptr(), b, maxb, bs,
        scale * math.log2(math.e), chunk, splits, _stream(q))
    _build.check(err, "mla_decode")
    mla_decode.launches += 1
    return out


def mla_prefill(q, pool, tables, positions, ctx_len, true_len, rank: int,
                scale: float) -> torch.Tensor:
    """``[N, T, H, C]`` (module docstring): the plain version on the CPU,
    K13's prefill kernel on the card."""
    if not q.is_cuda:
        return mla_prefill_ref(q, pool, tables, positions, ctx_len,
                               true_len, rank, scale)
    _check_common(q, pool, tables, rank)
    n, t, h, _ = q.shape
    _check(positions.dtype == torch.int64 and positions.shape == (n, t)
           and ctx_len.dtype == torch.int64 and true_len.dtype == torch.int64
           and ctx_len.shape == (n,) and true_len.shape == (n,)
           and tables.shape[0] == n
           and all(x.device == q.device and x.is_contiguous()
                   for x in (positions, ctx_len, true_len)),
           "positions int64 [N, T], ctx_len and true_len int64 [N], "
           "tables [N, MAXB]")
    out = torch.empty(n, t, h, rank, dtype=q.dtype, device=q.device)
    if n * t == 0:
        return out
    err = _build.library().mla_prefill_launch(
        q.data_ptr(), pool.data_ptr(), tables.data_ptr(),
        positions.data_ptr(), ctx_len.data_ptr(), true_len.data_ptr(),
        out.data_ptr(), n, t, tables.shape[1], pool.shape[1],
        scale * math.log2(math.e), _stream(q))
    _build.check(err, "mla_prefill")
    mla_prefill.launches += 1
    return out


mla_decode.launches = 0
mla_prefill.launches = 0
