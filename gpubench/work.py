"""The work an operation needs, counted from shapes, and the card's peaks.

Every count is of what the operation needs, whatever kernel runs it: each
input byte read once, each output byte written once, the FLOPs of the live
(unmasked) part. A roofline share is ``bound_s / device seconds``, and
``bound_s`` is the larger of bytes over the memory rate and FLOPs over the
peak rate.
"""

from . import spec

# One H100 SXM's published peaks at 700 W (NVIDIA's data sheet, dense):
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_BF16 = 989e12      # tensor cores, bf16 in, fp32 accumulate
PEAK_FLOPS_FP32 = 67e12       # outside the tensor cores

ELEM = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1, "int4": 0.5}


def bound_s(flops: float, nbytes: float,
            peak: float = PEAK_FLOPS_BF16) -> float:
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)


def dims(cfg: dict) -> dict:
    """The widths, ``layers`` and, from the configuration's family,
    ``attn_layers``: the layers that hold KV and run attention."""
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"h": h, "i": cfg["intermediate_size"], "nh": nh,
            "nkv": cfg["num_key_value_heads"],
            "hd": cfg.get("head_dim") or h // nh,
            "v": cfg["vocab_size"], "layers": cfg["num_hidden_layers"],
            "attn_layers": spec.family(cfg).attn_layers(cfg)}


def linears(cfg: dict):
    """``(n_out, k_in)`` of every matmul weight one token passes through,
    the head (tied or not) last, as the configuration's family lists
    them."""
    return spec.family(cfg).linears(cfg)


def token_flops(cfg: dict, ctx: int) -> float:
    """Model FLOPs of one token that attends ``ctx`` keys: 2 per weight it
    multiplies (head included), and 4 * heads * head_dim * ctx in each
    attention layer for the scores and the weighted sum."""
    d = dims(cfg)
    mats = sum(n * k for n, k in linears(cfg))
    return 2.0 * mats + 4.0 * d["attn_layers"] * d["nh"] * d["hd"] * ctx


def prompt_flops(cfg: dict, start: int, end: int) -> float:
    """:func:`token_flops` summed over prompt positions ``[start, end)``,
    each attending its position + 1 keys (causal)."""
    n = end - start
    keys = (end * (end + 1) - start * (start + 1)) // 2
    d = dims(cfg)
    return (2.0 * sum(a * b for a, b in linears(cfg)) * n
            + 4.0 * d["attn_layers"] * d["nh"] * d["hd"] * keys)


def paged_decode(cfg: dict, ctx: int, pool: str, block_size: int,
                 act: str = "bfloat16"):
    """``(flops, bytes)`` of one lane's attention over ``ctx`` cached
    tokens in one decode step, every attention layer: q and out, the live
    tokens' K and V rows (and an int8 pool's one fp32 scale per row, an
    int4 pool's one per row and kv head), the block-table entries they sit
    in and the context length."""
    d = dims(cfg)
    nh, nkv, hd = d["nh"], d["nkv"], d["hd"]
    row = nkv * hd * ELEM[pool]
    if pool == "int8":
        row += 4
    elif pool == "int4":
        row += 4 * nkv
    blocks = -(-ctx // block_size)
    per_layer = (2 * nh * hd * ELEM[act] + 2 * ctx * row + 4 * blocks + 4)
    n = d["attn_layers"]
    return 4.0 * nh * hd * ctx * n, float(per_layer * n)


def weight_only_step(cfg: dict, m: int, bits: int = 8,
                     act: str = "bfloat16"):
    """``(flops, bytes)`` of one decode step's quantized matmuls at ``m``
    rows: each weight byte and its per-channel fp32 scales read once, the
    activations read once and the outputs written once."""
    flops = nbytes = 0.0
    for n, k in linears(cfg):
        flops += 2.0 * m * n * k
        nbytes += n * k * bits / 8 + 4 * n + (m * k + m * n) * ELEM[act]
    return flops, nbytes


def flash_prefill(b: int, nh: int, nkv: int, lq: int, hd: int,
                  act: str = "bfloat16"):
    """``(flops, bytes)`` of one causal attention layer over ``lq`` tokens
    from position 0: q, k, v read once, out written once."""
    e = ELEM[act]
    flops = 4.0 * b * nh * hd * lq * (lq + 1) / 2
    nbytes = b * hd * e * (2 * nh * lq + 2 * nkv * lq)
    return flops, float(nbytes)


def flash_step(b: int, nh: int, nkv: int, keys: int, hd: int,
               act: str = "bfloat16"):
    """``(flops, bytes)`` of one layer's attention for one new token per
    row over ``keys`` live keys."""
    e = ELEM[act]
    flops = 4.0 * b * nh * hd * keys
    nbytes = b * hd * e * (2 * nh + 2 * nkv * keys)
    return flops, float(nbytes)
