"""Paged-KV model execution for the serving engine (counterpart of
``vyomai_tpu.serving.paged_model``).

Runs a ``models.qwen.ModelForCausalLM`` over the paged pool
``[L, NB, 2, BS, H_kv*D]``: prefill writes prompt K/V into pool blocks and
attends over cached prefix + suffix through the flash-forward kernel;
decode is a batched single-token step through the paged-decode kernel.

The pool is updated IN PLACE. Each layer's K/V writes go straight into the
``[L*NB, 2, BS, W]`` view of the pool (a view costs nothing), and both
attention kernels address it through layer-offset block tables: table
entry ``j >= 0`` of layer ``l`` becomes ``j + l*NB``, while ``-1`` entries
stay ``-1`` in prefill AND decode and are read as block 0 under the mask
(the JAX prefill offsets padded entries as well, leaving the context-length
mask alone to hide what they address).

A pool is a float tensor, or for the quantized pools of the JAX package a
dict ``{"kv": int8 [L, NB, 2, BS, W'], "scale": fp32 sidecar}`` (W' = H_kv*D
for int8 with scales ``[L, NB, 2, BS]``, H_kv*D/2 for int4 with scales
``[L, NB, 2, H_kv, BS]``). Prefill attends over ``gather_kv``'s dequantized
K/V, including the suffix it has just written, so the quantized path sees
its own quantization as JAX's does.

Linears, the token table and the tied head go through ``core.nn``'s module
dispatch, so a model from ``quant.quantize_model`` runs unchanged.
"""

from typing import Optional

import torch

from ..core import nn as cnn
from ..core.device import resolve_device
from ..core.masks import NEG_INF
from ..generation.sampling import _min_p_mask, _top_p_mask
from ..layers.modern import swiglu_apply
from ..layers.positional import rotate_half
from ..ops.flash_attention import flash_attention_fwd
from ..ops.paged_attention import gather_kv, write_kv
from ..ops.paged_decode import paged_decode


def init_pool(config, num_blocks: int, block_size: int,
              dtype=torch.bfloat16, device=None):
    """Combined K/V pool ``[L, NB, 2, BS, H_kv*D]`` (k row 0, v row 1), on
    the card unless ``device`` names another.

    ``dtype=torch.int8`` stores rows quantized at write time with one fp32
    scale per (layer, block, k/v, slot); ``dtype="int4"`` packs two values
    per byte with one scale per (row, kv head). Both return the dict of the
    module docstring, the scales initialised to 1 as in JAX."""
    device = resolve_device(device)
    h_kv = config.num_key_value_heads
    shape = (config.num_hidden_layers, num_blocks, 2, block_size,
             h_kv * config.head_dim)
    if dtype == "int4":
        return {"kv": torch.zeros(shape[:4] + (shape[4] // 2,),
                                  dtype=torch.int8, device=device),
                "scale": torch.ones(shape[:3] + (h_kv, block_size),
                                    dtype=torch.float32, device=device)}
    if dtype == torch.int8:
        return {"kv": torch.zeros(shape, dtype=torch.int8, device=device),
                "scale": torch.ones(shape[:4], dtype=torch.float32,
                                    device=device)}
    if dtype not in (torch.bfloat16, torch.float32, torch.float64):
        raise NotImplementedError(f"pool dtype {dtype}: float, torch.int8 "
                                  'or "int4"')
    return torch.zeros(shape, dtype=dtype, device=device)


def pool_parts(pool):
    """``(kv [L, NB, 2, BS, W'], scales or None)`` of a pool."""
    if isinstance(pool, dict):
        return pool["kv"], pool["scale"]
    return pool, None


def pool_bytes(pool) -> int:
    return sum(t.numel() * t.element_size() for t in pool_parts(pool)
               if t is not None)


def _flat(pool):
    """The pool's ``[L*NB, ...]`` views (views cost nothing) and NB."""
    kv, sc = pool_parts(pool)
    nl, nb = kv.shape[:2]
    flat_sc = None if sc is None else sc.view(nl * nb, *sc.shape[2:])
    return kv.view(nl * nb, *kv.shape[2:]), flat_sc, nb


def _head(model, h: torch.Tensor) -> torch.Tensor:
    if model.lm_head is not None:
        return cnn.apply_linear(model.lm_head, h)
    return cnn.apply_tied_lm_head(model.embed_tokens, h)


def _layer_tables(tables: torch.Tensor, layer: int, nb: int) -> torch.Tensor:
    return torch.where(tables >= 0, tables + layer * nb, tables)


def _rope(model, positions: torch.Tensor, dtype):
    """cos/sin ``[..., 1, D]`` for absolute positions, from the fp32
    angle table (cast to the activation dtype as the JAX path does)."""
    freqs = model.emb_freq[0][positions]
    emb = torch.cat([freqs, freqs], dim=-1).unsqueeze(-2)
    return ((torch.cos(emb) * model.rope_scale).to(dtype),
            (torch.sin(emb) * model.rope_scale).to(dtype))


def _qkv(attn, cfg, normed, lead):
    nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    q = cnn.apply_linear(attn.q_proj, normed).reshape(*lead, nh, hd)
    k = cnn.apply_linear(attn.k_proj, normed).reshape(*lead, nkv, hd)
    v = cnn.apply_linear(attn.v_proj, normed).reshape(*lead, nkv, hd)
    if attn.q_norm is not None:
        q = cnn.rms_norm(attn.q_norm.weight, q, eps=cfg.rms_norm_eps)
        k = cnn.rms_norm(attn.k_norm.weight, k, eps=cfg.rms_norm_eps)
    return q, k, v


def _mlp_block(layer, cfg, h):
    normed = cnn.rms_norm(layer.post_attention_layernorm.weight, h,
                          eps=cfg.rms_norm_eps)
    return h + swiglu_apply(layer.mlp, normed)


def _multi_core(model, pool, ids, positions, slot_blocks, slot_offsets,
                block_tables, ctx_len) -> torch.Tensor:
    """Multi-token paged step: writes each token's K/V at its slot and
    attends causally-with-offset over the gathered paged context.

    ids/positions/slot_blocks/slot_offsets: [N, T] (slot -1 = padding or
    dead lane, write dropped); block_tables: [N, MAXB]; ctx_len: [N] total
    valid context (0 = dead lane). Returns final-normed hidden [N, T, Dm].
    """
    cfg = model.config
    n, t_pad = ids.shape
    flat_pool, flat_sc, nb = _flat(pool)
    bs = flat_pool.shape[2]
    nkv = cfg.num_key_value_heads
    maxb = block_tables.shape[1]
    hidden = cnn.apply_embedding(model.embed_tokens, ids)       # [N, T, Dm]

    # causal-with-offset additive mask over the gathered context
    k_pos = torch.arange(maxb * bs, device=ids.device)[None, None, :]
    ok = (k_pos <= positions[:, :, None]) & (k_pos < ctx_len[:, None, None])
    bias = torch.where(ok, 0.0, NEG_INF).to(torch.float32)[:, None]
    cos, sin = _rope(model, positions, hidden.dtype)            # [N,T,1,D]
    flat_blocks = slot_blocks.reshape(-1)
    flat_offsets = slot_offsets.reshape(-1)

    for layer_i, layer in enumerate(model.layers):
        normed = cnn.rms_norm(layer.input_layernorm.weight, hidden,
                              eps=cfg.rms_norm_eps)
        q, k, v = _qkv(layer.self_attn, cfg, normed, (n, t_pad))
        q = q * cos + rotate_half(q) * sin
        k = k * cos + rotate_half(k) * sin
        write_kv(flat_pool, k.reshape(n * t_pad, nkv, -1),
                 v.reshape(n * t_pad, nkv, -1),
                 _layer_tables(flat_blocks, layer_i, nb), flat_offsets,
                 scales=flat_sc)
        tables = _layer_tables(block_tables, layer_i, nb).clamp_min(0)
        # [N, H_kv, MAXB*BS, D]; a quantized pool's come back dequantized
        # in fp32, and K1 attends q against them in (at least) fp32, as the
        # JAX prefill does: a bf16 q widens exactly, and the output returns
        # to q's dtype
        kk, vv = gather_kv(flat_pool, tables, nkv, flat_sc)
        qh = q.transpose(1, 2).contiguous()          # [N, H, T, D]
        acc = qh.dtype if flat_sc is None else torch.promote_types(
            qh.dtype, torch.float32)
        attn, _ = flash_attention_fwd(qh.to(acc), kk.to(acc).contiguous(),
                                      vv.to(acc).contiguous(), bias)
        attn = attn.to(qh.dtype).transpose(1, 2).reshape(n, t_pad, -1)
        hidden = hidden + cnn.apply_linear(layer.self_attn.o_proj, attn)
        hidden = _mlp_block(layer, cfg, hidden)
    return cnn.rms_norm(model.norm.weight, hidden, eps=cfg.rms_norm_eps)


@torch.no_grad()
def prefill(model, pool, ids, positions, slot_blocks, slot_offsets,
            block_tables, ctx_len, true_len) -> torch.Tensor:
    """Batched prefill of uncached prompt suffixes; writes ``pool`` in
    place. ids/positions/slot_blocks/slot_offsets: [N, T_pad];
    block_tables: [N, MAXB]; ctx_len/true_len: [N] (0 = dead lane).
    Returns last-real-token logits [N, V]."""
    hidden = _multi_core(model, pool, ids, positions, slot_blocks,
                         slot_offsets, block_tables, ctx_len)
    last = (true_len.long() - 1).clamp_min(0)
    rows = torch.arange(hidden.shape[0], device=hidden.device)
    return _head(model, hidden[rows, last])


@torch.no_grad()
def decode(model, pool, tokens, positions, block_tables, seq_lens,
           slot_blocks, slot_offsets) -> torch.Tensor:
    """Batched single-token decode; writes ``pool`` in place.

    tokens: [B]; positions: [B] absolute positions; block_tables: [B, MAXB]
    int32; seq_lens: [B] int32 context lengths incl. the new token;
    slot_blocks/slot_offsets: [B] write targets (-1 = dead lane).
    Returns logits [B, V]."""
    cfg = model.config
    b = tokens.shape[0]
    flat_pool, flat_sc, nb = _flat(pool)
    nkv = cfg.num_key_value_heads
    hidden = cnn.apply_embedding(model.embed_tokens, tokens)     # [B, Dm]
    cos, sin = _rope(model, positions, hidden.dtype)             # [B,1,D]
    for layer_i, layer in enumerate(model.layers):
        normed = cnn.rms_norm(layer.input_layernorm.weight, hidden,
                              eps=cfg.rms_norm_eps)
        q, k, v = _qkv(layer.self_attn, cfg, normed, (b,))
        q = q * cos + rotate_half(q) * sin
        k = k * cos + rotate_half(k) * sin
        write_kv(flat_pool, k, v, _layer_tables(slot_blocks, layer_i, nb),
                 slot_offsets, scales=flat_sc)
        attn = paged_decode(q.contiguous(), flat_pool,
                            _layer_tables(block_tables, layer_i, nb),
                            seq_lens, nkv, scales=flat_sc)       # [B, H, D]
        hidden = hidden + cnn.apply_linear(layer.self_attn.o_proj,
                                           attn.reshape(b, -1))
        hidden = _mlp_block(layer, cfg, hidden)
    hidden = cnn.rms_norm(model.norm.weight, hidden, eps=cfg.rms_norm_eps)
    return _head(model, hidden)


def sampling_mask(logits, temperature, top_p, min_p=0.0) -> torch.Tensor:
    """Temperature + nucleus (top-p) + min-p masked fp32 logits.
    ``temperature``/``top_p``/``min_p``: scalars or [B] per-lane."""
    def lane(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=logits.device)
        return x[:, None] if x.dim() == 1 else x

    logits = logits.to(torch.float32) / lane(temperature).clamp_min(1e-6)
    return _min_p_mask(_top_p_mask(logits, lane(top_p)), lane(min_p))


def sample_tokens(logits, generator: Optional[torch.Generator], temperature,
                  top_p, min_p=0.0) -> torch.Tensor:
    """Sample [B] int32 tokens from the masked distribution."""
    probs = torch.softmax(sampling_mask(logits, temperature, top_p, min_p),
                          dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


@torch.no_grad()
def decode_horizon(model, pool, tokens, positions, block_tables, live,
                   horizon: int, do_sample: bool = False, eos: int = -1,
                   generator: Optional[torch.Generator] = None,
                   temperature=1.0, top_p=1.0, min_p=0.0, budget=None):
    """Up to ``horizon`` decode steps per lane. The engine pre-allocates
    blocks for ``positions + budget`` so ``table[pos // BS], pos % BS``
    always lands on a live block.

    Lanes that emit ``eos`` (-1 disables) or exhaust ``budget`` [B] go dead:
    their writes are dropped and their token/position freeze; the loop ends
    once every lane is dead. tokens/positions: [B] latest token and its
    position; live: [B] bool. Returns ``(generated [B, horizon] int32,
    final_tokens [B] int32, eos_dead [B] bool)`` (dead entries are 0)."""
    b = tokens.shape[0]
    bs = pool_parts(pool)[0].shape[3]
    maxb = block_tables.shape[1]
    dev = tokens.device
    out = torch.zeros((b, horizon), dtype=torch.int32, device=dev)
    if budget is None:
        budget = torch.full((b,), horizon, dtype=torch.int32, device=dev)
    toks = tokens.to(torch.int32)
    pos = positions.to(torch.int64)
    alive = live.clone()
    eos_dead = torch.zeros_like(alive)
    lanes = torch.arange(b, device=dev)
    for i in range(horizon):
        if not bool(alive.any()):
            break
        blk = block_tables[lanes, (pos // bs).clamp_max(maxb - 1)]
        slot_blocks = torch.where(alive, blk, -1)
        seq_lens = torch.where(alive, pos + 1, 0).to(torch.int32)
        logits = decode(model, pool, toks, pos, block_tables, seq_lens,
                        slot_blocks, pos % bs)
        if do_sample:
            nxt = sample_tokens(logits, generator, temperature, top_p, min_p)
        else:
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        nxt = torch.where(alive, nxt, toks)
        out[:, i] = torch.where(alive, nxt, 0)
        eos_dead |= alive & (nxt == eos)
        alive = alive & (nxt != eos) & (i + 1 < budget)
        pos = torch.where(alive, pos + 1, pos)
        toks = nxt
    return out, toks, eos_dead
