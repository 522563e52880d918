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
dispatch, so a model from ``quant.quantize_model`` runs unchanged. Every
norm site of both steps (input, post-attention, per-head q and k, final)
is one call of K12, ``ops.rms_norm``, with the residual add in front of it
folded in: the steps carry each block's output (``delta``) to the next
norm instead of adding it themselves.

A model with multi-head latent attention (``config.kv_lora_rank``,
``models.deepseek_v3``) keeps a latent pool instead,
``[L, NB, BS, kv_lora_rank + qk_rope_head_dim]``: one row a token a layer,
the latent ``c_kv`` and the rotated ``k_pe`` that every head shares, with
no K/V pair and no heads (1,152 B a token a layer for Moonlight-16B-A3B,
against 8,192 B for its 16 heads' K and V). Both steps run MLA's absorbed
form (``layers.mla``): each head's latent query ``q_nope W_UK`` beside its
``q_pe`` attends the rows through K13 (``ops.mla_attention``), which reads
them from the pool through the layer-offset tables, and the heads' latent
outputs go through ``W_UV`` into ``o_proj``. Prefill takes the absorbed
form too: a refill's few suffix tokens attend a cached context of
thousands of rows, which the decompressed form would first expand through
``kv_b_proj`` (2·512·4,096 FLOPs a row and layer, more than the absorbed
scores of a short suffix cost), and a gather of the rows into a copy is
what K13 avoids. A span ``paged_model.mla`` encloses each layer's MLA
attention in both steps.

The steps walk the model's layers by kind. A model with ``layer_types``
(``models.lfm2.Lfm2MoeForCausalLM``) keeps KV for its ``full_attention``
layers only: the pool's L counts those (:func:`kv_layers`), and a layer's
pool index is its place among them. Its conv layers keep a per-lane state
and its expert layers device counters in a :class:`LaneState` beside the
pool (None for the dense model), which both steps and both captured graphs
take; the MoE layers route only real tokens (a prefill row's suffix, a
live decode lane).
"""

from typing import Optional

import torch

from ..core import nn as cnn
from ..core.device import resolve_device
from ..core.masks import NEG_INF
from ..generation.sampling import _min_p_mask, _top_p_mask
from ..layers.mla import absorb_out, absorb_q, latent_rows, queries
from ..layers.modern import (lm_logits, qkv_heads, rope_tables, rotate,
                             swiglu_apply)
from ..layers.moe import MoE, moe_apply
from ..layers.short_conv import conv_sequence, conv_step
from ..ops.flash_attention import flash_attention_fwd
from ..ops.grouped_matmul import grouped_swiglu
from ..ops.mla_attention import mla_decode, mla_prefill, write_latent
from ..ops.paged_attention import gather_kv, write_kv
from ..ops.paged_decode import (paged_decode, paged_decode_int4,
                                paged_decode_int8)
from ..ops.quant_matmul import int4_matmul, int8_matmul
from ..ops.rms_norm import rms_norm
from .spans import span


def kv_layers(config) -> list:
    """The layers that hold KV in the pool, in pool order: every layer, or
    those ``config.layer_types`` names ``full_attention``."""
    types = getattr(config, "layer_types", None)
    if types is None:
        return list(range(config.num_hidden_layers))
    return [i for i, t in enumerate(types) if t == "full_attention"]


def is_mla(config) -> bool:
    """Whether the model attends through multi-head latent attention, over
    a latent pool."""
    return getattr(config, "kv_lora_rank", None) is not None


def conv_layers(model) -> list:
    """The layers with a gated short conv, which keeps per-lane state."""
    return [i for i, layer in enumerate(model.layers)
            if getattr(layer, "conv", None) is not None]


class LaneState:
    """What a model with conv layers or experts keeps beside the paged
    pool, for ``lanes`` decode lanes (:func:`init_lane_state`):

    - ``conv [conv layers, lanes + 1, L - 1, H]`` in the activation dtype:
      each lane's last ``L - 1`` gated conv inputs in every conv layer
      (``conv_index`` maps a layer to its row). A prefill row writes its
      lane as of its last real token, from zeros at a sequence's start or
      from the lane's state when it continues a chunked suffix; a dead
      row writes the last lane, a sink. A decode step shifts each live
      lane by one token and leaves a dead one as it was.
    - ``moe [2, 2]`` int64: for decode steps (row 0) and prefill calls (row
      1), the rows K11 ran and the (layer, call, expert) triples with at
      least one row, summed on the device inside the captured graphs.
    """

    def __init__(self, model, lanes: int):
        cfg, device = model.config, model.device
        convs = conv_layers(model)
        self.conv_index = {li: j for j, li in enumerate(convs)}
        self.conv = None
        if convs:
            taps = model.layers[convs[0]].conv.taps
            self.conv = torch.zeros(len(convs), lanes + 1, taps - 1,
                                    cfg.hidden_size, dtype=model.dtype,
                                    device=device)
        self.moe = None
        if any(isinstance(layer.mlp, MoE) for layer in model.layers):
            self.moe = torch.zeros(2, 2, dtype=torch.int64, device=device)


def init_lane_state(model, lanes: int) -> Optional[LaneState]:
    """The model's :class:`LaneState` for ``lanes`` lanes; None for a model
    with neither conv layers nor experts."""
    state = LaneState(model, lanes)
    return None if state.conv is None and state.moe is None else state


def init_pool(config, num_blocks: int, block_size: int,
              dtype=torch.bfloat16, device=None):
    """Combined K/V pool ``[L, NB, 2, BS, H_kv*D]`` (k row 0, v row 1), on
    the card unless ``device`` names another; L counts the layers that
    hold KV (:func:`kv_layers`). An MLA model's is the latent pool ``[L,
    NB, BS, kv_lora_rank + qk_rope_head_dim]`` of a float dtype.

    ``dtype=torch.int8`` stores rows quantized at write time with one fp32
    scale per (layer, block, k/v, slot); ``dtype="int4"`` packs two values
    per byte with one scale per (row, kv head). Both return the dict of the
    module docstring, the scales initialised to 1 as in JAX."""
    device = resolve_device(device)
    if is_mla(config):
        if dtype not in (torch.bfloat16, torch.float32, torch.float64):
            raise NotImplementedError(
                f"latent pool dtype {dtype}: a float dtype (a quantized "
                "latent pool is not ported)")
        return torch.zeros(config.num_hidden_layers, num_blocks, block_size,
                           config.latent_dim, dtype=dtype, device=device)
    h_kv = config.num_key_value_heads
    shape = (len(kv_layers(config)), num_blocks, 2, block_size,
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


def pool_block_size(pool) -> int:
    """Tokens a block of the pool holds (K/V or latent)."""
    kv = pool_parts(pool)[0]
    return kv.shape[2] if kv.dim() == 4 else kv.shape[3]


def pool_bytes(pool) -> int:
    return sum(t.numel() * t.element_size() for t in pool_parts(pool)
               if t is not None)


def _flat(pool):
    """The pool's ``[L*NB, ...]`` views (views cost nothing) and NB."""
    kv, sc = pool_parts(pool)
    nl, nb = kv.shape[:2]
    flat_sc = None if sc is None else sc.view(nl * nb, *sc.shape[2:])
    return kv.view(nl * nb, *kv.shape[2:]), flat_sc, nb


def _layer_tables(tables: torch.Tensor, layer: int, nb: int) -> torch.Tensor:
    return torch.where(tables >= 0, tables + layer * nb, tables)


def _norm(norm, cfg, hidden: torch.Tensor, delta):
    """``(hidden + delta, its norm by the RMSNorm module norm)`` in one K12
    launch on the card: a norm site with the residual add in front of it;
    ``delta`` None: ``(hidden, its norm)``."""
    if delta is None:
        return hidden, rms_norm(norm.weight, hidden, eps=cfg.rms_norm_eps)
    return rms_norm(norm.weight, delta, eps=cfg.rms_norm_eps,
                    residual=hidden)


def _ffn(layer, normed: torch.Tensor, valid, counts) -> torch.Tensor:
    """The layer's FFN of its normed input: the dense MLP, or the experts
    over the ``valid`` tokens (``counts``: their device counters or
    None). The caller adds it to the residual stream."""
    if not isinstance(layer.mlp, MoE):
        return swiglu_apply(layer.mlp, normed)
    with span("paged_model.moe"):
        return moe_apply(layer.mlp, normed, valid, counts)


def _moe_counts(state, phase: int):
    return None if state is None or state.moe is None else state.moe[phase]


def _conv_prefill(conv, normed, st, lanes, cont, true_len) -> torch.Tensor:
    """The conv over each row's chunk from its lane's state (``cont``) or
    zeros; writes each lane's state as of the row's last real token."""
    with span("paged_model.conv"):
        lane = torch.where(lanes >= 0, lanes, st.shape[0] - 1)
        init = torch.where(cont[:, None, None], st[lane], 0)
        out, new = conv_sequence(conv, normed, init, true_len)
        st.index_copy_(0, lane, new.to(st.dtype))
        return out


def _conv_decode(conv, normed, st, alive) -> torch.Tensor:
    """One token of the conv per lane; live lanes' states shift."""
    with span("paged_model.conv"):
        cur = st[:normed.shape[0]]
        out, new = conv_step(conv, normed, cur)
        cur.copy_(torch.where(alive[:, None, None], new.to(cur.dtype), cur))
        return out


def _mla_prefill(attn, cfg, normed, cos, sin, flat_pool, pl, nb, flat_blocks,
                 flat_offsets, block_tables, positions, ctx_len, true_len):
    """One layer's MLA over a prefill call's rows ``normed [N, T, h]``:
    writes each token's latent row at its slot, then its absorbed query
    attends the row's cached context and its suffix through K13. Returns
    the ``o_proj`` output ``[N, T, h]``."""
    with span("paged_model.mla"):
        n, t = normed.shape[:2]
        nh = cfg.num_attention_heads
        q_nope, q_pe = queries(attn, cfg, normed, (n * t,), cos.reshape(
            n * t, 1, -1), sin.reshape(n * t, 1, -1))
        lat = latent_rows(attn, cfg, normed, cos, sin, norm=rms_norm)
        write_latent(flat_pool, lat.reshape(n * t, -1),
                     _layer_tables(flat_blocks, pl, nb), flat_offsets)
        q = torch.cat([absorb_q(attn, cfg, q_nope), q_pe], -1)
        o = mla_prefill(q.view(n, t, nh, -1), flat_pool,
                        _layer_tables(block_tables, pl, nb), positions,
                        ctx_len, true_len, cfg.kv_lora_rank,
                        cfg.qk_head_dim ** -0.5)
        o = absorb_out(attn, cfg, o.view(n * t, nh, -1))
        return cnn.apply_linear(attn.o_proj, o.view(n, t, -1))


def _mla_decode(attn, cfg, normed, cos, sin, flat_pool, pl, nb, slot_blocks,
                slot_offsets, block_tables, seq_lens):
    """One layer's MLA over a decode step's lanes ``normed [B, h]``: writes
    each live lane's latent row, then its absorbed query attends the lane's
    rows through K13. Returns the ``o_proj`` output ``[B, h]``."""
    with span("paged_model.mla"):
        q_nope, q_pe = queries(attn, cfg, normed, (normed.shape[0],), cos,
                               sin)
        lat = latent_rows(attn, cfg, normed, cos, sin, norm=rms_norm)
        write_latent(flat_pool, lat, _layer_tables(slot_blocks, pl, nb),
                     slot_offsets)
        q = torch.cat([absorb_q(attn, cfg, q_nope), q_pe], -1)
        o = mla_decode(q, flat_pool, _layer_tables(block_tables, pl, nb),
                       seq_lens, cfg.kv_lora_rank, cfg.qk_head_dim ** -0.5)
        return cnn.apply_linear(attn.o_proj, absorb_out(attn, cfg, o))


def _multi_core(model, pool, ids, positions, slot_blocks, slot_offsets,
                block_tables, ctx_len, true_len=None, lanes=None,
                state=None) -> torch.Tensor:
    """Multi-token paged step: writes each token's K/V at its slot and
    attends causally-with-offset over the gathered paged context.

    ids/positions/slot_blocks/slot_offsets: [N, T] (slot -1 = padding or
    dead lane, write dropped); block_tables: [N, MAXB]; ctx_len: [N] total
    valid context (0 = dead lane). A model with a :class:`LaneState`
    (``state``) also takes ``true_len`` [N] (real tokens of each row) and
    ``lanes`` [N] (each row's lane, -1 dead). Returns final-normed hidden
    [N, T, Dm].
    """
    cfg = model.config
    n, t_pad = ids.shape
    flat_pool, flat_sc, nb = _flat(pool)
    mla = is_mla(cfg)
    nkv = cfg.num_key_value_heads
    maxb = block_tables.shape[1]
    hidden = cnn.apply_embedding(model.embed_tokens, ids)       # [N, T, Dm]
    kv_of = {li: j for j, li in enumerate(kv_layers(cfg))}
    valid = cont = None                 # the dense model reads neither
    if state is not None:
        valid = slot_blocks >= 0                # real tokens
        cont = positions[:, 0] > 0              # a chunk after the first
    counts = _moe_counts(state, 1)

    if not mla:     # K13 masks from the positions itself
        # causal-with-offset additive mask over the gathered context
        k_pos = torch.arange(maxb * flat_pool.shape[2],
                             device=ids.device)[None, None, :]
        ok = (k_pos <= positions[:, :, None]) & \
            (k_pos < ctx_len[:, None, None])
        bias = torch.where(ok, 0.0, NEG_INF).to(torch.float32)[:, None]
    cos, sin = rope_tables(model, positions, hidden.dtype)      # [N,T,1,D]
    flat_blocks = slot_blocks.reshape(-1)
    flat_offsets = slot_offsets.reshape(-1)

    delta = None            # what the last block adds to the residual
    for layer_i, layer in enumerate(model.layers):
        with span("paged_model.prefill.layer"):
            hidden, normed = _norm(layer.input_layernorm, cfg, hidden, delta)
            if layer_i not in kv_of:
                st = state.conv[state.conv_index[layer_i]]
                delta = _conv_prefill(layer.conv, normed, st, lanes, cont,
                                      true_len)
            elif mla:
                delta = _mla_prefill(layer.self_attn, cfg, normed, cos, sin,
                                     flat_pool, kv_of[layer_i], nb,
                                     flat_blocks, flat_offsets, block_tables,
                                     positions, ctx_len, true_len)
            else:
                pl = kv_of[layer_i]
                q, k, v = qkv_heads(layer.self_attn, cfg, normed, (n, t_pad),
                                    norm=rms_norm)
                q, k = rotate(q, cos, sin), rotate(k, cos, sin)
                write_kv(flat_pool, k.reshape(n * t_pad, nkv, -1),
                         v.reshape(n * t_pad, nkv, -1),
                         _layer_tables(flat_blocks, pl, nb), flat_offsets,
                         scales=flat_sc)
                tables = _layer_tables(block_tables, pl, nb).clamp_min(0)
                # [N, H_kv, MAXB*BS, D]; a quantized pool's come back
                # dequantized in fp32, and K1 attends q against them in (at
                # least) fp32, as the JAX prefill does: a bf16 q widens
                # exactly, and the output returns to q's dtype
                kk, vv = gather_kv(flat_pool, tables, nkv, flat_sc)
                qh = q.transpose(1, 2).contiguous()          # [N, H, T, D]
                acc = qh.dtype if flat_sc is None else torch.promote_types(
                    qh.dtype, torch.float32)
                attn, _ = flash_attention_fwd(
                    qh.to(acc), kk.to(acc).contiguous(),
                    vv.to(acc).contiguous(), bias)
                attn = attn.to(qh.dtype).transpose(1, 2).reshape(
                    n, t_pad, -1)
                delta = cnn.apply_linear(layer.self_attn.o_proj, attn)
            hidden, normed = _norm(layer.post_attention_layernorm, cfg,
                                   hidden, delta)
            delta = _ffn(layer, normed, valid, counts)
    return _norm(model.norm, cfg, hidden, delta)[1]


@torch.no_grad()
def prefill(model, pool, ids, positions, slot_blocks, slot_offsets,
            block_tables, ctx_len, true_len, lanes=None,
            state=None) -> torch.Tensor:
    """Batched prefill of uncached prompt suffixes; writes ``pool`` (and
    ``state``'s conv lanes) in place. ids/positions/slot_blocks/
    slot_offsets: [N, T_pad]; block_tables: [N, MAXB]; ctx_len/true_len:
    [N] (0 = dead lane); lanes: [N] (-1 = dead), read with ``state``.
    Returns last-real-token logits [N, V]. A ``paged_model.prefill`` span
    (``spans.span``), with one ``paged_model.prefill.layer`` a layer."""
    with span("paged_model.prefill"):
        hidden = _multi_core(model, pool, ids, positions, slot_blocks,
                             slot_offsets, block_tables, ctx_len, true_len,
                             lanes, state)
        last = (true_len.long() - 1).clamp_min(0)
        rows = torch.arange(hidden.shape[0], device=hidden.device)
        return lm_logits(model, hidden[rows, last])


@torch.no_grad()
def decode(model, pool, tokens, positions, block_tables, seq_lens,
           slot_blocks, slot_offsets, state=None) -> torch.Tensor:
    """Batched single-token decode; writes ``pool`` (and ``state``'s conv
    lanes) in place.

    tokens: [B]; positions: [B] absolute positions; block_tables: [B, MAXB]
    int32; seq_lens: [B] int32 context lengths incl. the new token (0 = dead
    lane); slot_blocks/slot_offsets: [B] write targets (-1 = dead lane).
    Returns logits [B, V]."""
    cfg = model.config
    b = tokens.shape[0]
    flat_pool, flat_sc, nb = _flat(pool)
    nkv = cfg.num_key_value_heads
    kv_of = {li: j for j, li in enumerate(kv_layers(cfg))}
    mla = is_mla(cfg)
    alive = None if state is None else seq_lens > 0
    counts = _moe_counts(state, 0)
    hidden = cnn.apply_embedding(model.embed_tokens, tokens)     # [B, Dm]
    cos, sin = rope_tables(model, positions, hidden.dtype)       # [B,1,D]
    delta = None            # what the last block adds to the residual
    for layer_i, layer in enumerate(model.layers):
        hidden, normed = _norm(layer.input_layernorm, cfg, hidden, delta)
        if layer_i not in kv_of:
            st = state.conv[state.conv_index[layer_i]]
            delta = _conv_decode(layer.conv, normed, st, alive)
        elif mla:
            delta = _mla_decode(layer.self_attn, cfg, normed, cos, sin,
                                flat_pool, kv_of[layer_i], nb, slot_blocks,
                                slot_offsets, block_tables, seq_lens)
        else:
            pl = kv_of[layer_i]
            q, k, v = qkv_heads(layer.self_attn, cfg, normed, (b,),
                                norm=rms_norm)
            q, k = rotate(q, cos, sin), rotate(k, cos, sin)
            write_kv(flat_pool, k, v, _layer_tables(slot_blocks, pl, nb),
                     slot_offsets, scales=flat_sc)
            attn = paged_decode(q.contiguous(), flat_pool,
                                _layer_tables(block_tables, pl, nb),
                                seq_lens, nkv, scales=flat_sc)   # [B, H, D]
            delta = cnn.apply_linear(layer.self_attn.o_proj,
                                     attn.reshape(b, -1))
        hidden, normed = _norm(layer.post_attention_layernorm, cfg, hidden,
                               delta)
        delta = _ffn(layer, normed, alive, counts)
    return lm_logits(model, _norm(model.norm, cfg, hidden, delta)[1])


def sampling_tensors(device, temperature=1.0, top_p=1.0, min_p=0.0):
    """``(temperature, top_p, min_p)`` as fp32 tensors on ``device`` (scalars
    or ``[B]``), made once: :func:`sampling_mask` turns a Python number into
    a tensor on each call, a host-to-device copy that a captured step may
    not make."""
    return tuple(torch.as_tensor(x, dtype=torch.float32, device=device)
                 for x in (temperature, top_p, min_p))


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


def pick_tokens(logits, do_sample: bool, generator, samp) -> torch.Tensor:
    """[B] next tokens: drawn from the masked distribution (int32;
    ``samp`` as :func:`sampling_tensors` gives it) or greedy (int64)."""
    if do_sample:
        return sample_tokens(logits, generator, *samp)
    return torch.argmax(logits, dim=-1)


def _tick_spec(b: int, maxb: int) -> dict:
    """A horizon's inputs in load order, as :class:`_Staged` takes them;
    its steps update tokens, positions and live in place."""
    return {"tokens": (0, torch.int32, (b,)),
            "positions": (0, torch.int64, (b,)),
            "tables": (-1, torch.int32, (b, maxb)),
            "budget": (0, torch.int32, (b,)),
            "live": (False, torch.bool, (b,))}


def _buffers(spec: dict, **where) -> dict:
    """One tensor per ``spec`` entry, filled as a dead row; ``where``:
    ``device=`` or ``pin_memory=``."""
    return {name: torch.full(shape, fill, dtype=dtype, **where)
            for name, (fill, dtype, shape) in spec.items()}


class _Carry:
    """What a horizon carries besides its inputs, as tensors updated in
    place: ``eos_dead`` ``[B]`` bool, the step counter (a 0-d int64
    tensor), the output ``[B, horizon]`` int32 and the lane index."""

    def __init__(self, b: int, horizon: int, device):
        self.eos_dead = torch.zeros(b, dtype=torch.bool, device=device)
        self.step = torch.zeros((), dtype=torch.int64, device=device)
        self.out = torch.zeros(b, horizon, dtype=torch.int32, device=device)
        self.lanes = torch.arange(b, device=device)

    def start(self, x: dict, dead_mask=None, **given):
        """Load a tick into its inputs ``x``, from the ``given`` tensors
        (``tokens=None``: the last tick's final tokens, a chained tick's
        carry). ``dead_mask`` (the JAX argument: lanes an earlier chained
        tick killed by eos; may be ``self.eos_dead``) is taken off ``live``
        and seeds ``eos_dead``, so the flag accumulates over a chain."""
        for name, t in given.items():
            if t is not None:
                x[name].copy_(t)
        if dead_mask is None:
            self.eos_dead.zero_()
        elif dead_mask is not self.eos_dead:
            self.eos_dead.copy_(dead_mask)
        x["live"] &= ~self.eos_dead
        self.step.zero_()
        self.out.zero_()


def _step(model, pool, x: dict, c: _Carry, do_sample: bool, eos: int,
          generator, samp, state=None) -> torch.Tensor:
    """One step of the horizon on its inputs ``x`` and carry ``c``, in
    place, with nothing read back to the host: a CUDA graph captures it as
    it is. A dead lane is a no-op: its write slot is -1 (dropped), its
    context length 0 (K4 gives 0), its token and position stay and its
    output is 0. Returns the step's logits [B, V]."""
    tokens, pos, alive = x["tokens"], x["positions"], x["live"]
    tables = x["tables"]
    bs = pool_block_size(pool)
    maxb = tables.shape[1]
    blk = tables[c.lanes, (pos // bs).clamp_max(maxb - 1)]
    slot_blocks = torch.where(alive, blk, -1)
    seq_lens = torch.where(alive, pos + 1, 0).to(torch.int32)
    logits = decode(model, pool, tokens, pos, tables, seq_lens,
                    slot_blocks, pos % bs, state)
    nxt = pick_tokens(logits, do_sample, generator, samp).to(torch.int32)
    nxt = torch.where(alive, nxt, tokens)                 # freeze dead lanes
    c.out.scatter_(1, c.step.expand(c.out.shape[0], 1),
                   torch.where(alive, nxt, 0)[:, None])
    # eos-death apart from the budget freeze: the next chained tick
    # revives a budget-frozen lane, never an eos'd one
    c.eos_dead |= alive & (nxt == eos)
    alive &= (nxt != eos) & (c.step + 1 < x["budget"])
    pos.copy_(torch.where(alive, pos + 1, pos))
    tokens.copy_(nxt)
    c.step += 1
    return logits


@torch.no_grad()
def decode_horizon(model, pool, tokens, positions, block_tables, live,
                   horizon: int, do_sample: bool = False, eos: int = -1,
                   generator: Optional[torch.Generator] = None,
                   temperature=1.0, top_p=1.0, min_p=0.0, budget=None,
                   dead_mask=None, return_logits: bool = False,
                   state=None):
    """Up to ``horizon`` decode steps per lane, run eagerly. The engine
    pre-allocates blocks for ``positions + budget`` so ``table[pos // BS],
    pos % BS`` always lands on a live block.

    Lanes that emit ``eos`` (-1 disables) or exhaust ``budget`` [B] go dead:
    their writes are dropped and their token/position freeze. The loop runs
    all ``horizon`` steps and reads nothing back: a dead lane's step
    changes nothing, so the tokens are those of the JAX ``while_loop``,
    which stops once every lane is dead (the engine's tick runs
    ``min(horizon, max budget)`` steps, a count its host knows).
    tokens/positions: [B] latest token and its position; live: [B] bool;
    ``dead_mask`` [B] bool: lanes an earlier chained tick killed by eos
    (JAX semantics: taken off ``live``, and seeding ``eos_dead``). Returns
    ``(generated [B, horizon] int32, final_tokens [B] int32, eos_dead [B]
    bool)`` (dead entries are 0), and with ``return_logits`` the last
    step's logits; ``(final_tokens, eos_dead)`` is the carry a chained tick
    starts from. ``state``: the model's :class:`LaneState` (lane ``i`` is
    row ``i``), None for the dense model."""
    b, maxb = block_tables.shape
    x = _buffers(_tick_spec(b, maxb), device=tokens.device)
    c = _Carry(b, horizon, tokens.device)
    if budget is None:
        budget = torch.full((b,), horizon, dtype=torch.int32)
    c.start(x, dead_mask, tokens=tokens, positions=positions,
            tables=block_tables, budget=budget, live=live)
    samp = sampling_tensors(tokens.device, temperature, top_p, min_p)
    logits = None
    for _ in range(horizon):
        logits = _step(model, pool, x, c, do_sample, eos, generator, samp,
                       state)
    if return_logits:
        return c.out, x["tokens"], c.eos_dead, logits
    return c.out, x["tokens"], c.eos_dead


# the kernels' wrappers that a captured decode step or prefill may call,
# and their counters
_COUNTED = (paged_decode, paged_decode_int8, paged_decode_int4, int8_matmul,
            int4_matmul, flash_attention_fwd, grouped_swiglu, rms_norm,
            mla_decode, mla_prefill)


def _launch_counts() -> dict:
    return {(fn, name): getattr(fn, name) for fn in _COUNTED
            for name in ("launches", "tc_launches", "sites")
            if hasattr(fn, name)}


def norm_counts() -> tuple:
    """``(norm sites run, those K12 ran)`` so far in this process: the
    steps' calls of ``ops.rms_norm``, eager, or added per replay of a
    captured graph as its capture counted them."""
    return rms_norm.sites, rms_norm.launches


def _capture(fn, device, generator=None, pool=None):
    """``(graph, per_replay)``: ``fn`` captured as a CUDA graph on a stream
    of its own, into the memory pool ``pool`` (None: a private one).

    ``fn`` first runs once eagerly on that stream, on inputs that change
    nothing (dead lanes or rows), so that whatever a first call creates
    exists when the capture starts: the kernels' library and their
    shared-memory attributes, cuBLAS's handle and workspace of that stream,
    the split-K workspace that ``ops.quant_matmul`` keys by (device,
    stream). ``generator``'s state is registered with the graph, so each
    replay draws fresh numbers from it, and restored after the warm-up. A
    failed capture raises.

    The kernels' wrappers count launches (K12 also its norm sites) in
    Python, which a replay never calls: the counts the capture added are
    taken back, and ``per_replay`` holds what :func:`_replay` adds once per
    replay instead."""
    gen_state = None if generator is None else generator.get_state()
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        fn()
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    before = _launch_counts()
    with torch.cuda.graph(graph, pool=pool, stream=stream):
        fn()
    per_replay = {}
    for (wrapper, name), n in before.items():
        per_replay[(wrapper, name)] = getattr(wrapper, name) - n
        setattr(wrapper, name, n)          # the capture launched nothing
    torch.cuda.current_stream(device).wait_stream(stream)
    if gen_state is not None:
        generator.set_state(gen_state)
    return graph, per_replay


def _replay(graph, per_replay):
    graph.replay()
    for (fn, name), k in per_replay.items():
        setattr(fn, name, getattr(fn, name) + k)


class _Staged:
    """A device call fed from host staging and read back into it: ``sets``
    sets of host buffers (pinned on the card), each with the call's inputs
    as ``spec`` gives them (name -> (value of a dead row, dtype, shape), in
    the call's order) and room for the device tensors ``outs`` and, with
    experts, ``LaneState.moe``'s row of ``phase`` ("decode" or "prefill");
    ``inputs``, the static device buffers that ``fn`` reads. On a CUDA
    device ``fn`` is captured at construction (:func:`_capture`, warmed up
    on the dead inputs) and replayed, with no eager fallback; on the CPU it
    runs eagerly. Neither copy waits for the device on the card, so a set
    is written again only once the device has passed its copies: with one
    set, the caller's blocking read of the call's results sees to that;
    with more, the set's event, recorded after its copies back."""

    def __init__(self, spec, outs, state, phase, device, sets, fn,
                 generator=None, mempool=None):
        cuda = device.type == "cuda"
        moe = _moe_counts(state, ("decode", "prefill").index(phase))
        self.outs = outs if moe is None else dict(outs, moe=moe)
        self.spec, self.phase, self.turn = spec, phase, sets - 1
        self.inputs = _buffers(spec, device=device)
        host = dict(spec, **{name: (0, t.dtype, tuple(t.shape))
                             for name, t in self.outs.items()})
        self.sets = [_buffers(host, pin_memory=cuda) for _ in range(sets)]
        self.events = [torch.cuda.Event() if cuda and sets > 1 else None
                       for _ in self.sets]
        self.graph, self.per_replay = None, {}
        if cuda:
            self.graph, self.per_replay = _capture(fn, device, generator,
                                                   mempool)

    def stage(self, wait=None) -> dict:
        """The next set's inputs as numpy views, every row dead, to write a
        call into, once ``wait(event)`` has waited on the set's event."""
        self.turn = (self.turn + 1) % len(self.sets)
        if self.events[self.turn] is not None:
            wait(self.events[self.turn])
        x = {name: self.sets[self.turn][name].numpy() for name in self.spec}
        for name, (fill, _, _) in self.spec.items():
            x[name].fill(fill)
        return x

    def _copy(self, dst, src, names):
        for name in names:
            dst[name].copy_(src[name], non_blocking=self.graph is not None)

    def counts(self, k: int = 0) -> dict:
        """The engine's MoE counters as of set ``k``'s call, once its
        copies have landed; empty without experts."""
        if "moe" not in self.outs:
            return {}
        rows, visits = self.sets[k]["moe"].tolist()
        return {f"moe_rows_{self.phase}": rows,
                f"moe_expert_visits_{self.phase}": visits}


class HorizonGraph(_Staged):
    """The engine's decode tick: :func:`decode_horizon`'s step over static
    inputs and a :class:`_Carry` for ``batch`` lanes, ``max_blocks`` table
    entries and ``horizon`` steps, bound to one ``pool`` (updated in place,
    never reallocated, so the graph may hold its pointers) and ``state``,
    the model's :class:`LaneState` (lane ``i`` is its lane ``i``). On the
    card a tick replays the captured step ``n`` times, with no host work
    between steps. ``logits`` holds the last step's logits.

    The engine's ticks go :meth:`stage`, :meth:`launch`, :meth:`read`,
    over two staging sets: a chained tick fills one while the other's tick
    is in flight. :meth:`start` and :meth:`run` take device tensors."""

    def __init__(self, model, pool, batch: int, max_blocks: int,
                 horizon: int, *, do_sample: bool = False, eos: int = -1,
                 generator: Optional[torch.Generator] = None, samp=None,
                 state=None):
        device = pool_parts(pool)[0].device
        self.model, self.pool, self.state = model, pool, state
        self.do_sample, self.eos, self.generator = do_sample, eos, generator
        self.samp = samp if samp is not None else sampling_tensors(device)
        self.c = _Carry(batch, horizon, device)
        self.logits = None
        super().__init__(_tick_spec(batch, max_blocks), {"out": self.c.out},
                         state, "decode", device, 2, self._step, generator)

    @torch.no_grad()
    def _step(self):
        self.logits = _step(self.model, self.pool, self.inputs, self.c,
                            self.do_sample, self.eos, self.generator,
                            self.samp, self.state)

    def start(self, positions, tables, live, budget, tokens=None):
        """Load a tick (:meth:`_Carry.start`); ``tokens=None`` chains it
        from the last one's carry, its ``eos_dead`` the dead mask."""
        self.c.start(self.inputs, None if tokens is not None else
                     self.c.eos_dead, tokens=tokens, positions=positions,
                     tables=tables, budget=budget, live=live)

    def run(self, n: int):
        """``n`` steps; returns ``(generated, final_tokens, eos_dead)``,
        the buffers themselves (the next tick overwrites them)."""
        for _ in range(n):
            if self.graph is None:
                self._step()
            else:
                _replay(self.graph, self.per_replay)
        return self.c.out, self.inputs["tokens"], self.c.eos_dead

    def launch(self, n: int, chain: bool) -> int:
        """The staged tick copied up (``chain``: all but its tokens, and
        from the last tick's carry), ``n`` steps, and its tokens and counts
        copied back behind its set's event; returns the set's index."""
        st = self.sets[self.turn]
        self._copy(self.inputs, st, [k for k in self.spec
                                     if not (chain and k == "tokens")])
        self.c.start(self.inputs, self.c.eos_dead if chain else None)
        self.run(n)
        self._copy(st, self.outs, self.outs)
        if self.events[self.turn] is not None:
            self.events[self.turn].record()
        return self.turn

    def read(self, k: int, wait):
        """Set ``k``'s tokens ``[B, horizon]`` (a copy) and
        :meth:`counts`, once ``wait(event)`` has waited on its event."""
        if self.events[k] is not None:
            wait(self.events[k])
        return self.sets[k]["out"].numpy().copy(), self.counts(k)


class PrefillGraph(_Staged):
    """The engine's prefill call for one shape: :func:`prefill` over static
    inputs of ``group`` rows, ``bucket`` tokens and ``max_blocks`` table
    entries (and with ``state``, the model's :class:`LaneState`, each row's
    ``lanes``), bound to one ``pool`` (written in place, never
    reallocated), fed from one staging set. On the card the forward and
    the last real token's ``lm_logits`` are captured into ``mempool`` where
    given (graphs that share one must have each call's logits read before
    the next replay): the same kernels as the eager call."""

    # name -> (value of a dead row, dtype); rows: [group, bucket] for the
    # first four, [group, max_blocks] for the tables, [group] for the rest
    DEAD = {"ids": (0, torch.int64), "positions": (0, torch.int64),
            "slot_blocks": (-1, torch.int32), "slot_offsets": (0, torch.int64),
            "tables": (-1, torch.int32), "ctx_len": (0, torch.int64),
            "true_len": (0, torch.int64)}

    def __init__(self, model, pool, group: int, bucket: int,
                 max_blocks: int, *, mempool=None, state=None):
        self.model, self.pool, self.state = model, pool, state
        self.logits = None
        dead = self.DEAD if state is None else dict(
            self.DEAD, lanes=(-1, torch.int64))
        shapes = {"tables": (group, max_blocks), "ctx_len": (group,),
                  "true_len": (group,), "lanes": (group,)}
        spec = {name: (fill, dtype, shapes.get(name, (group, bucket)))
                for name, (fill, dtype) in dead.items()}
        super().__init__(spec, {}, state, "prefill",
                         pool_parts(pool)[0].device, 1, self._forward,
                         mempool=mempool)

    def _forward(self):
        self.logits = prefill(self.model, self.pool, *self.inputs.values(),
                              state=self.state)

    def start(self):
        """Copy the staging set up, on the card without waiting: the
        caller's read of the logits frees the set."""
        self._copy(self.inputs, self.sets[0], self.spec)

    def run(self) -> torch.Tensor:
        """The call's last-real-token logits ``[group, V]`` (on the card
        the graph's output buffer, which the next replay overwrites), its
        :meth:`counts` copied back behind them."""
        if self.graph is None:
            self._forward()
        else:
            with span("paged_model.prefill"):
                _replay(self.graph, self.per_replay)
        self._copy(self.sets[0], self.outs, self.outs)
        return self.logits
