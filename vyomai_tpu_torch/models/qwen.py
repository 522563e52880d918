"""Qwen2/3-flavored causal LM as an ``nn.Module`` (counterpart of
``vyomai_tpu.models.qwen.ModelForCausalLM``).

It holds the weights, the RoPE angle table ``emb_freq`` and the attention
mscale ``rope_scale`` that the paged serving path reads. The dense
``apply``/``generate_hf`` entry points are not ported yet: serving runs the
model through ``serving.paged_model``.
"""

import torch
from torch import nn
from torch.nn.utils import skip_init

from ..config import QwenConfig
from ..core import nn as cnn
from ..core.device import resolve_device
from ..layers import positional as pos
from ..layers.modern import ModernLayer, RMSNorm


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
