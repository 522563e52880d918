"""K13's work in the traced slice, for its two roofline readers (not a
metric: it has no ``NAME``). From the engine's latent-row counters over the
slice, every MLA layer alike (``L`` layers, ``H`` heads, a row of ``C + R``
values in the pool's dtype):

- decode: FLOPs ``2 H (2C + R)`` a (lane, row) pair, over
  ``mla_rows_decode``; bytes, each distinct row the steps read once
  (``mla_distinct_rows_decode``: lanes that hold one cached document read
  its rows once from memory only if a kernel is written so), each decode
  token's query ``H (C + R)`` and output ``H C`` in bf16, and a 4-byte
  table entry every block of rows read;
- prefill: FLOPs ``2 H (2C + R)`` a live (query, key) pair
  (``mla_pairs_prefill``); bytes, the distinct rows each call reads
  (``mla_rows_prefill``), each real suffix token's query and output
  (``prefill_tokens``), the table entries.

The bound is the larger of bytes over 3.35 TB/s and FLOPs over 989
TFLOP/s, against the device time of the kernels of the phase: K13's
decode pair runs only in decode steps, its prefill kernel only in prefill
calls, replayed or not. The counters are added as each tick and prefill
call is staged, so a tick in flight at an edge of the slice counts on one
side of it."""

from .. import work
from ._tokens import decode_tokens, delta

DECODE = ("k13_decode_split_kernel", "k13_decode_combine_kernel")
PREFILL = ("k13_prefill_kernel",)


def _widths(cfg: dict):
    """``(L, H, C, R)``."""
    return (cfg["num_hidden_layers"], cfg["num_attention_heads"],
            cfg["kv_lora_rank"], cfg["qk_rope_head_dim"])


def counts(cfg: dict, pairs: float, rows: float, tokens: float,
           pool: str = "bfloat16", block: int = 16):
    """``(flops, bytes)`` of ``pairs`` (query, row) pairs over ``rows``
    distinct rows read once, for ``tokens`` queries."""
    layers, h, c, r = _widths(cfg)
    e = work.ELEM[pool]
    flops = 2.0 * h * (2 * c + r) * pairs * layers
    nbytes = layers * (rows * (c + r) * e + tokens * h * (2 * c + r) * 2
                       + 4.0 * rows / block)
    return flops, nbytes


def seconds(trace: dict, names) -> float:
    return sum(b - a for n, a, b, _, _ in trace["kernels"]
               if any(k in n for k in names))


def share(run, trace, cell, phase: str):
    """K13's share of its roofline in ``phase`` (``decode`` or
    ``prefill``); None without a trace, the counters or the kernels."""
    if not trace:
        return None
    if phase == "decode":
        pairs = delta(run, "mla_rows_decode")
        rows = delta(run, "mla_distinct_rows_decode")
        tokens = sum(1 for _ in decode_tokens(run)) if rows else 0
        names = DECODE
    else:
        pairs = delta(run, "mla_pairs_prefill")
        rows = delta(run, "mla_rows_prefill")
        tokens = delta(run, "prefill_tokens") or 0
        names = PREFILL
    if not pairs or not rows:
        return None
    secs = seconds(trace, names)
    if secs <= 0:
        return None
    flops, nbytes = counts(cell["config"], pairs, rows, tokens,
                           run.get("pool", "bfloat16"),
                           run.get("block_size", 16))
    return 100.0 * work.bound_s(flops, nbytes) / secs
