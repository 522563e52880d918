"""DeepSeek-V3-block causal LM (Moonlight-16B-A3B) as an ``nn.Module``; the
JAX package has no counterpart.

Each layer is ``h = x + MLA(RMSNorm(x))``, ``out = h + FFN(RMSNorm(h))``:
multi-head latent attention (``layers.mla``), and an FFN that is a dense
SwiGLU in the first ``first_k_dense_replace`` layers and, after them, the
sigmoid-routed experts (``layers.moe``, the ``noaux_tc`` router at one
group) with the shared expert added; a final RMSNorm and the untied head
close it. RMSNorm is ``w ⊙ x / sqrt(mean(x²) + eps)`` in fp32.

Module names are upstream's (``model.`` dropped), except that the stacked
expert banks are ``mlp.w1``/``w3``/``w2`` (upstream's per-expert
``mlp.experts.<e>.{gate,up,down}_proj``) and the router's correction bias
is ``mlp.expert_bias`` (upstream ``mlp.gate.e_score_correction_bias``).

``forward`` runs whole sequences from position 0 with no cache, the
attention decompressed (the tests' full forward); serving runs the same
modules through ``serving.paged_model`` in the absorbed form, over a
latent pool of one row per token a layer. Linears, the token table and
the head go through ``core.nn``'s module dispatch, so a model from
``quant.quantize_model`` runs unchanged.
"""

import torch
from torch import nn
from torch.nn.utils import skip_init

from ..config import DeepseekV3Config
from ..core import nn as cnn
from ..core.device import resolve_device
from ..layers import positional as pos
from ..layers.mla import MLA, mla_apply
from ..layers.modern import (RMSNorm, SwiGLU, lm_logits, rope_tables_at,
                             swiglu_apply)
from ..layers.moe import MoE, moe_apply
from .outputs import CLMOutput


class DeepseekV3Layer(nn.Module):
    def __init__(self, config: DeepseekV3Config, index: int, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h = config.hidden_size
        self.input_layernorm = RMSNorm(h, **kw)
        self.post_attention_layernorm = RMSNorm(h, **kw)
        self.self_attn = MLA(config, **kw)
        if index < config.first_k_dense_replace:
            self.mlp = SwiGLU(config, **kw)
        else:
            self.mlp = MoE(h, config.moe_intermediate_size,
                           config.n_routed_experts,
                           config.num_experts_per_tok, router="sigmoid",
                           expert_bias=True,
                           norm_topk_prob=config.norm_topk_prob,
                           routed_scaling_factor=config.routed_scaling_factor,
                           norm_eps=1e-20,
                           shared_inter=(config.n_shared_experts
                                         * config.moe_intermediate_size),
                           **kw)


class DeepseekV3ForCausalLM(nn.Module):
    def __init__(self, config: DeepseekV3Config, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.embed_tokens = skip_init(nn.Embedding, config.vocab_size,
                                      config.hidden_size, device=device,
                                      dtype=dtype)
        self.layers = nn.ModuleList(
            DeepseekV3Layer(config, i, device=device, dtype=dtype)
            for i in range(config.num_hidden_layers))
        self.norm = RMSNorm(config.hidden_size, device=device, dtype=dtype)
        self.lm_head = skip_init(nn.Linear, config.hidden_size,
                                 config.vocab_size, bias=False, device=device,
                                 dtype=dtype)
        # the rotary dims' angles, computed on the CPU and moved
        self.register_buffer(
            "emb_freq", pos.rope_freqs(config.max_position_embeddings,
                                       config.qk_rope_head_dim,
                                       theta=config.rope_theta).to(device),
            persistent=False)
        self.rope_scale = 1.0

    @property
    def device(self) -> torch.device:
        return self.norm.weight.device

    @property
    def dtype(self) -> torch.dtype:
        """The activation dtype (a quantized table's ``out_dtype``)."""
        return cnn.embedding_dtype(self.embed_tokens)

    @torch.no_grad()
    def init(self, generator: torch.Generator, std: float = 0.02
             ) -> "DeepseekV3ForCausalLM":
        """Random init from ``generator`` (on the model's device):
        normal(0, std) matrices and expert banks; unit norms; zero expert
        bias. Returns ``self``."""
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            elif name.endswith("expert_bias"):
                p.zero_()
            else:
                p.normal_(0.0, std, generator=generator)
        return self

    def forward(self, input_ids: torch.Tensor) -> CLMOutput:
        """Logits ``[B, L, V]`` of whole sequences from position 0 (no
        cache, no padding)."""
        cfg = self.config
        hidden = cnn.apply_embedding(self.embed_tokens, input_ids)
        cos, sin = rope_tables_at(self, 0, input_ids.shape[1], hidden.dtype)
        for layer in self.layers:
            normed = cnn.rms_norm(layer.input_layernorm.weight, hidden,
                                  eps=cfg.rms_norm_eps)
            hidden = hidden + mla_apply(layer.self_attn, normed, cfg, cos,
                                        sin)
            normed = cnn.rms_norm(layer.post_attention_layernorm.weight,
                                  hidden, eps=cfg.rms_norm_eps)
            hidden = hidden + (moe_apply(layer.mlp, normed)
                               if isinstance(layer.mlp, MoE)
                               else swiglu_apply(layer.mlp, normed))
        hidden = cnn.rms_norm(self.norm.weight, hidden, eps=cfg.rms_norm_eps)
        return CLMOutput(hidden_state=hidden, logits=lm_logits(self, hidden),
                         kv_cache=None)
