"""Multi-head latent attention (MLA), DeepSeek-V3's, without a low-rank
query; the JAX package has no counterpart.

For a token's normed input ``x``, with ``H`` heads, ``n`` = ``qk_nope_
head_dim``, ``r`` = ``qk_rope_head_dim``, ``c`` = ``kv_lora_rank`` and
``v`` = ``v_head_dim``:

- ``q = q_proj(x)``, ``[H, n + r]``: ``q_nope [H, n]``, and ``q_pe [H, r]``
  rotated by RoPE;
- ``kv_a_proj_with_mqa(x)``, ``[c + r]``: the latent ``c_kv =
  kv_a_layernorm(first c)`` and one rotary key ``k_pe`` (the last ``r``,
  rotated) that every head shares. ``[c_kv, k_pe]`` is all a token keeps
  in a cache: one row of ``c + r`` a layer (:func:`latent_rows`);
- ``kv_b_proj(c_kv)``, ``[H, n + v]``: each head's ``k_nope`` and value;
- head ``h`` attends with scores ``(q_nope·k_nope + q_pe·k_pe) / sqrt(n +
  r)`` and sums its values; ``o_proj`` maps the ``[H, v]`` outputs back.

The absorbed form computes the same without making ``k_nope`` or the
values: with ``W_UK [H, n, c]`` and ``W_UV [H, v, c]`` the two halves of
``kv_b_proj``'s weight, ``q_nope·(W_UK c_kv) = (q_nope W_UK)·c_kv``, so
each head's latent query ``q_nope W_UK`` (:func:`absorb_q`) and ``q_pe``
score ``c + r`` dims of the cached row, and the head's output is ``W_UV``
times the probability-weighted sum of the ``c_kv`` (:func:`absorb_out`).
The serving steps (``serving.paged_model``) run that form over the latent
pool through K13 (``ops.mla_attention``); :func:`mla_apply`, the model's
full forward, runs the decompressed one.

RoPE is DeepSeek-V3's as published: its ``r`` rotary dims are read as
interleaved pairs ``(x0, x1), (x2, x3), ...`` and put in the order
``x0, x2, ..., x1, x3, ...`` before the rotate-half rotation
(:func:`rope_interleaved`), so the rotated ``q_pe`` and ``k_pe`` come out
in that order, as upstream's do. The softmax scale is ``(n + r)^-1/2``
(no YaRN: ``rope_scaling`` is refused by the config). ``kv_a_layernorm``
takes the published code's epsilon, ``kv_a_layernorm_eps``.

Linears go through ``core.nn``'s module dispatch; the absorbed products
read ``kv_b_proj``'s weight itself, dequantized for a quantized model
(:func:`kv_b_weight`).
"""

import torch
from torch import nn

from ..core import nn as cnn
from .modern import RMSNorm, _linear, rotate


class MLA(nn.Module):
    """The projections and the latent norm of one MLA block."""

    def __init__(self, config, *, device=None, dtype=torch.float32):
        super().__init__()
        h, nh = config.hidden_size, config.num_attention_heads
        c, r = config.kv_lora_rank, config.qk_rope_head_dim
        self.q_proj = _linear(h, nh * config.qk_head_dim, device, dtype)
        self.kv_a_proj_with_mqa = _linear(h, c + r, device, dtype)
        self.kv_a_layernorm = RMSNorm(c, device=device, dtype=dtype)
        self.kv_b_proj = _linear(
            c, nh * (config.qk_nope_head_dim + config.v_head_dim), device,
            dtype)
        self.o_proj = _linear(nh * config.v_head_dim, h, device, dtype)


def rope_interleaved(x: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V3's rotation of ``x [..., r]``: the interleaved pairs put
    in rotate-half order, then rotated by ``cos``/``sin`` ``[..., r]`` (the
    rotate-half tables of ``layers.modern.rope_tables``)."""
    x = x.unflatten(-1, (-1, 2)).transpose(-1, -2).flatten(-2)
    return rotate(x, cos, sin)


def queries(attn: MLA, cfg, normed: torch.Tensor, lead, cos, sin):
    """``(q_nope [*lead, H, n], q_pe [*lead, H, r])``, ``q_pe`` rotated;
    ``cos``/``sin`` broadcast over the heads."""
    q = cnn.apply_linear(attn.q_proj, normed).reshape(
        *lead, cfg.num_attention_heads, cfg.qk_head_dim)
    q_nope, q_pe = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], -1)
    return q_nope, rope_interleaved(q_pe, cos, sin)


def latent_rows(attn: MLA, cfg, normed: torch.Tensor, cos, sin,
                norm=cnn.rms_norm) -> torch.Tensor:
    """The cached row of each token, ``[..., c + r]``: ``kv_a_layernorm``'s
    latent (applied by ``norm``: ``core.nn``'s, or K12 in the serving
    steps) and the rotated ``k_pe``; ``cos``/``sin`` ``[..., 1, r]`` as
    :func:`queries` takes them."""
    ckv = cnn.apply_linear(attn.kv_a_proj_with_mqa, normed)
    c = norm(attn.kv_a_layernorm.weight,
             ckv[..., :cfg.kv_lora_rank].contiguous(),
             eps=cfg.kv_a_layernorm_eps)
    k_pe = rope_interleaved(ckv[..., None, cfg.kv_lora_rank:], cos, sin)
    return torch.cat([c, k_pe[..., 0, :]], dim=-1)


def kv_b_weight(attn: MLA, cfg, dtype) -> torch.Tensor:
    """``kv_b_proj``'s weight as ``[H, n + v, c]`` in the activation dtype
    ``dtype`` (a view of a float weight; a quantized one dequantized)."""
    lin = attn.kv_b_proj
    w = lin.weight if isinstance(lin, nn.Linear) else \
        lin.dequantized().to(dtype)
    return w.view(cfg.num_attention_heads, -1, cfg.kv_lora_rank)


def absorb_q(attn: MLA, cfg, q_nope: torch.Tensor) -> torch.Tensor:
    """Each head's latent query ``q_nope W_UK``: ``[T, H, n] -> [T, H,
    c]``, one batched product over the heads."""
    w_uk = kv_b_weight(attn, cfg, q_nope.dtype)[:, :cfg.qk_nope_head_dim]
    return torch.bmm(q_nope.transpose(0, 1), w_uk).transpose(0, 1)


def absorb_out(attn: MLA, cfg, o_lat: torch.Tensor) -> torch.Tensor:
    """Each head's output ``W_UV o``, flattened for ``o_proj``: ``[T, H, c]
    -> [T, H * v]``."""
    w_uv = kv_b_weight(attn, cfg, o_lat.dtype)[:, cfg.qk_nope_head_dim:]
    o = torch.bmm(o_lat.transpose(0, 1), w_uv.transpose(1, 2))
    return o.transpose(0, 1).reshape(o_lat.shape[0], -1)


def mla_apply(attn: MLA, normed: torch.Tensor, cfg, cos, sin):
    """The decompressed block over whole causal sequences ``normed [B, L,
    h]`` from position 0 (the model's full forward); ``cos``/``sin``
    ``[L, 1, r]``. Returns the ``o_proj`` output ``[B, L, h]``."""
    b, l, _ = normed.shape
    nh, nope = cfg.num_attention_heads, cfg.qk_nope_head_dim
    q_nope, q_pe = queries(attn, cfg, normed, (b, l), cos, sin)
    lat = latent_rows(attn, cfg, normed, cos, sin)             # [B, L, c+r]
    kv = cnn.apply_linear(attn.kv_b_proj, lat[..., :cfg.kv_lora_rank])
    kv = kv.reshape(b, l, nh, nope + cfg.v_head_dim)
    k_pe = lat[..., None, cfg.kv_lora_rank:].expand(b, l, nh, -1)
    q = torch.cat([q_nope, q_pe], -1).transpose(1, 2)          # [B, H, L, d]
    k = torch.cat([kv[..., :nope], k_pe], -1).transpose(1, 2)
    v = kv[..., nope:].transpose(1, 2)
    scale = cfg.qk_head_dim ** -0.5
    s = (q @ k.transpose(-1, -2)).to(torch.promote_types(
        q.dtype, torch.float32)) * scale
    causal = torch.ones(l, l, dtype=torch.bool, device=q.device).tril()
    p = s.masked_fill(~causal, float("-inf")).softmax(-1).to(v.dtype)
    out = (p @ v).transpose(1, 2).reshape(b, l, -1)
    return cnn.apply_linear(attn.o_proj, out)
