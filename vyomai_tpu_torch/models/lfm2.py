"""LFM2-MoE causal LM (LiquidAI's LFM2-8B-A1B) as an ``nn.Module``; the
JAX package has no counterpart.

Each layer is ``h = x + Op(RMSNorm(x))``, ``out = h + FFN(RMSNorm(h))``,
with ``Op`` a gated short convolution (``layers.short_conv``) or GQA
attention with RMSNorm over each head of q and k and rotate-half RoPE (the
dense model's ``layers.modern.Attention``), as ``config.layer_types``
says, and ``FFN`` a dense SwiGLU in the first ``num_dense_layers`` layers
and a sigmoid-routed mixture of experts after (``layers.moe``); a final
RMSNorm and the head tied to the token table close it. RMSNorm is ``w ⊙ x
/ sqrt(mean(x²) + eps)`` in fp32.

The module names are the dense model's where the paged serving path
(``serving.paged_model``) shares its code: ``input_layernorm`` and
``post_attention_layernorm`` (upstream ``operator_norm``, ``ffn_norm``),
``self_attn.{q,k,v,o}_proj`` and ``self_attn.{q,k}_norm`` (upstream
``out_proj``, ``q_layernorm``, ``k_layernorm``), ``mlp`` (upstream
``feed_forward``: ``w1``/``w3``/``w2`` as ``gate_proj``/``up_proj``/
``down_proj``, the router ``gate``, the stacked experts and
``expert_bias``), ``norm`` (upstream ``embedding_norm``); the conv
operator keeps upstream's ``conv.{in_proj,conv,out_proj}``.

``forward`` runs whole sequences from position 0 with no cache (the
tests' full forward); serving runs the same modules through
``serving.paged_model``, with the conv layers' state beside the paged KV
pool. Linears, the token table and the tied head go through ``core.nn``'s
module dispatch, so a model from ``quant.quantize_model`` runs unchanged.
"""

import torch
from torch import nn
from torch.nn.utils import skip_init

from ..config import Lfm2MoeConfig
from ..core import nn as cnn
from ..core.device import resolve_device
from ..layers import positional as pos
from ..layers.modern import (Attention, RMSNorm, SwiGLU, lm_logits,
                             modern_attention_apply, rope_tables_at,
                             swiglu_apply)
from ..layers.moe import MoE, moe_apply
from ..layers.short_conv import ShortConv, conv_sequence
from .outputs import CLMOutput


class Lfm2Layer(nn.Module):
    def __init__(self, config: Lfm2MoeConfig, index: int, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h = config.hidden_size
        self.input_layernorm = RMSNorm(h, **kw)
        self.post_attention_layernorm = RMSNorm(h, **kw)
        if config.layer_types[index] == "full_attention":
            self.self_attn, self.conv = Attention(config, **kw), None
        else:
            self.self_attn = None
            self.conv = ShortConv(h, config.conv_L_cache, **kw)
        if index < config.num_dense_layers:
            self.mlp = SwiGLU(config, **kw)
        else:
            self.mlp = MoE(h, config.moe_intermediate_size,
                           config.num_experts, config.num_experts_per_tok,
                           router="sigmoid",
                           expert_bias=config.use_expert_bias,
                           norm_topk_prob=config.norm_topk_prob,
                           routed_scaling_factor=config.routed_scaling_factor,
                           **kw)


class Lfm2MoeForCausalLM(nn.Module):
    def __init__(self, config: Lfm2MoeConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.embed_tokens = skip_init(nn.Embedding, config.vocab_size,
                                      config.hidden_size, device=device,
                                      dtype=dtype)
        self.layers = nn.ModuleList(
            Lfm2Layer(config, i, device=device, dtype=dtype)
            for i in range(config.num_hidden_layers))
        self.norm = RMSNorm(config.hidden_size, device=device, dtype=dtype)
        self.lm_head = None                  # tied to the token table
        # angles computed on the CPU and moved, as in ModelForCausalLM
        self.register_buffer(
            "emb_freq", pos.rope_freqs(config.max_position_embeddings,
                                       config.head_dim,
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
             ) -> "Lfm2MoeForCausalLM":
        """Random init from ``generator`` (on the model's device):
        normal(0, std) matrices, conv taps and expert banks; unit norms;
        zero expert bias. Returns ``self``."""
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
        rope = rope_tables_at(self, 0, input_ids.shape[1], hidden.dtype)
        for layer in self.layers:
            normed = cnn.rms_norm(layer.input_layernorm.weight, hidden,
                                  eps=cfg.rms_norm_eps)
            if layer.conv is not None:
                op, _ = conv_sequence(layer.conv, normed)
            else:
                op, _ = modern_attention_apply(layer.self_attn, normed, cfg,
                                               rope=rope, causal=True)
            hidden = hidden + op
            normed = cnn.rms_norm(layer.post_attention_layernorm.weight,
                                  hidden, eps=cfg.rms_norm_eps)
            hidden = hidden + (moe_apply(layer.mlp, normed)
                               if isinstance(layer.mlp, MoE)
                               else swiglu_apply(layer.mlp, normed))
        hidden = cnn.rms_norm(self.norm.weight, hidden, eps=cfg.rms_norm_eps)
        return CLMOutput(hidden_state=hidden, logits=lm_logits(self, hidden),
                         kv_cache=None)
