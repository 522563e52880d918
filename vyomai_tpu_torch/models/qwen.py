"""Qwen2/3-flavored causal LM as an ``nn.Module`` (counterpart of
``vyomai_tpu.models.qwen.ModelForCausalLM``): RMSNorm, SwiGLU, GQA, RoPE,
optional per-head QK-norm, tied or untied head.

It holds the weights, the RoPE angle table ``emb_freq`` and the attention
mscale ``rope_scale``. ``forward`` is the dense model, with or without the
static KV cache (``layers.kv_cache``); the paged serving path runs the same
modules through ``serving.paged_model``. Linears, the token table and the
tied head go through ``core.nn``'s module dispatch, so a model from
``quant.quantize_model`` runs unchanged. The configs ``QwenConfig`` refuses
(sliding window, sinks, RoPE scaling, attention bias, MoE) are not ported.
"""

import torch
from torch import nn
from torch.nn.utils import skip_init

from typing import Optional

from ..config import QwenConfig
from ..core import nn as cnn
from ..core.device import resolve_device
from ..core.masks import bidirectional_mask, causal_mask_static_kv
from ..layers import positional as pos
from ..layers.kv_cache import cache_max_len, init_cache, with_length
from ..layers.modern import (ModernLayer, RMSNorm, lm_logits,
                             modern_layer_apply, rope_tables_at)
from .outputs import CLMOutput


class ModelForCausalLM(nn.Module):
    def __init__(self, config: QwenConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.embed_tokens = skip_init(nn.Embedding, config.vocab_size,
                                      config.hidden_size, device=device,
                                      dtype=dtype)
        self.layers = nn.ModuleList(
            ModernLayer(config, device=device, dtype=dtype)
            for _ in range(config.num_hidden_layers))
        self.norm = RMSNorm(config.hidden_size, device=device, dtype=dtype)
        self.lm_head = None
        if not config.tie_word_embeddings:
            self.lm_head = skip_init(nn.Linear, config.hidden_size,
                                     config.vocab_size, bias=False,
                                     device=device, dtype=dtype)
        # the angle table is computed on the CPU and moved, so every device
        # rotates by bit-identical angles
        self.register_buffer(
            "emb_freq", pos.rope_freqs(config.max_position_embeddings,
                                       config.head_dim,
                                       theta=config.rope_theta,
                                       scaling=config.rope_scaling
                                       ).to(device), persistent=False)
        self.rope_scale = pos.rope_attention_factor(config.rope_scaling)

    @property
    def device(self) -> torch.device:
        return self.norm.weight.device

    @property
    def dtype(self) -> torch.dtype:
        """The activation dtype (a quantized table's ``out_dtype``)."""
        return cnn.embedding_dtype(self.embed_tokens)

    @torch.no_grad()
    def init(self, generator: torch.Generator, std: float = 0.02
             ) -> "ModelForCausalLM":
        """Random init from ``generator`` (normal(0, std) matrices, unit
        norms — the JAX package's scheme). The generator must live on the
        model's device. Returns ``self``."""
        self.embed_tokens.weight.normal_(0.0, std, generator=generator)
        for layer in self.layers:
            layer.init(generator, std)
        self.norm.weight.fill_(1.0)
        if self.lm_head is not None:
            self.lm_head.weight.normal_(0.0, std, generator=generator)
        return self

    def init_cache(self, *, batch_size: int = 1,
                   max_len: Optional[int] = None) -> dict:
        """A zeroed static cache of ``max_len`` positions (2,048 when None,
        as in the JAX package) on the model's device, in the activation
        dtype (the layers write their k/v into it uncast)."""
        cfg = self.config
        return init_cache(cfg, batch_size=batch_size,
                          max_len=max_len or 2048, dtype=self.dtype,
                          num_kv_heads=cfg.num_key_value_heads,
                          head_dim=cfg.head_dim, device=self.device)

    def forward(self, input_ids, attention_mask=None, cache=None,
                start_pos: int = 0, segment_ids=None,
                positions=None) -> CLMOutput:
        """Logits ``[B, L, V]`` for tokens at ``[start_pos, start_pos +
        L)``. With ``cache``, their k/v are written into it in place, the
        queries attend the whole buffer under ``causal_mask_static_kv`` and
        ``kv_cache`` is the cache with ``length = start_pos + L``; without,
        attention is causal in the kernel plus the pad bias of
        ``attention_mask``. Packed ``segment_ids``/``positions`` are not
        ported yet (they raise)."""
        if segment_ids is not None or positions is not None:
            raise NotImplementedError(
                "packed segment_ids/positions are not ported yet")
        cfg = self.config
        bsz, seqlen = input_ids.shape
        hidden = cnn.apply_embedding(self.embed_tokens, input_ids)
        rope = rope_tables_at(self, start_pos, seqlen, hidden.dtype)
        if cache is not None:
            mask = causal_mask_static_kv(seqlen, cache_max_len(cache),
                                         start_pos, attention_mask,
                                         batch_size=bsz,
                                         device=input_ids.device)
        else:
            mask = (None if attention_mask is None
                    else bidirectional_mask(attention_mask))
        for i, layer in enumerate(self.layers):
            kv = None if cache is None else (cache["k"][i], cache["v"][i])
            hidden, _ = modern_layer_apply(
                layer, hidden, cfg, rope=rope, mask=mask,
                causal=cache is None, cache_kv=kv, start_pos=start_pos)
        hidden = cnn.rms_norm(self.norm.weight, hidden, eps=cfg.rms_norm_eps)
        return CLMOutput(
            hidden_state=hidden, logits=lm_logits(self, hidden),
            kv_cache=None if cache is None else with_length(
                cache, start_pos + seqlen))
