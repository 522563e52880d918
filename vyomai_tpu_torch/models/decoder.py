"""GPT-style causal decoder as an ``nn.Module`` (counterpart of
``vyomai_tpu.models.decoder.DecoderModel``).

Positional embeddings ``"absolute" | "sinusoidal" | "rope"``, attention
``None`` (MHA) or ``"gqa"``. The module tree mirrors the JAX param tree
(``word_embeddings``, ``position_embeddings``, ``layers.{i}.attention``,
``layers.{i}.ffn``, ``lm_head``), so a JAX param path names the same tensor
here. The body (embeddings, layer stack, remat) is ``encoder.TextModel``;
the model builds on the card unless ``device`` names another.

Parity quirk kept: each layer's FFN residual adds the *pre-attention* block
input. Without a cache, attention gets the pad bias ``[B, 1, 1, L]`` and
``causal=True``, so the flash route applies the triangle in-kernel and
skips future tiles.

Not ported yet (they raise): the static KV cache and ``generate``, packed
``segment_ids``/``positions``, and ``remat="dots"``.
"""

from typing import Optional

import torch

from ..config import EncoderConfig
from ..core.masks import bidirectional_mask
from ..layers import attention as attn
from ..layers import ffn as ffn_mod
from .encoder import LMHead, TextModel, lm_head_apply, lm_head_init_
from .outputs import CLMOutput


class DecoderModel(TextModel):
    def __init__(self, config: EncoderConfig,
                 pos_embedding_type: Optional[str] = "absolute",
                 attention_type: Optional[str] = None, remat: bool = False,
                 *, device=None, dtype=torch.float32):
        super().__init__(config, pos_embedding_type, attention_type, remat,
                         device=device, dtype=dtype)
        self.lm_head = LMHead(config, device=self.device, dtype=dtype)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "DecoderModel":
        """Random init from ``generator`` (the JAX scheme: normal(0,
        initializer_range) weights, zero biases, unit norms, the pad row of
        the token table zeroed). The generator must live on the model's
        device. Returns ``self``."""
        self._init_body(generator)
        lm_head_init_(self.lm_head, self.config, generator)
        return self

    def _layer(self, layer, h, deterministic, generator, *, mask, freqs,
               causal):
        cfg = self.config
        out, _ = attn.decoder_attention_apply(
            layer.attention, h, mask, cfg, kind=self.kind, freqs=freqs,
            causal=causal, deterministic=deterministic, generator=generator)
        # FFN residual uses the pre-attention hidden state (parity quirk)
        return ffn_mod.ffn_apply(layer.ffn, out, h, cfg,
                                 deterministic=deterministic,
                                 generator=generator)

    def hidden_states(self, input_ids, attention_mask=None, *,
                      deterministic: bool = True,
                      generator: Optional[torch.Generator] = None):
        """The last layer's output ``[B, L, h]`` (before the LM head)."""
        hidden, freqs = self.embed(input_ids)
        mask = (None if attention_mask is None
                else bidirectional_mask(attention_mask))
        return self.run_layers(hidden, mask=mask, freqs=freqs, causal=True,
                               deterministic=deterministic,
                               generator=generator)

    def forward(self, input_ids, attention_mask=None, cache=None,
                start_pos: int = 0, *, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                segment_ids=None, positions=None) -> CLMOutput:
        if cache is not None or start_pos:
            raise NotImplementedError(
                "the static KV cache is not ported yet")
        if segment_ids is not None or positions is not None:
            raise NotImplementedError(
                "packed segment_ids/positions are not ported yet")
        hidden = self.hidden_states(input_ids, attention_mask,
                                    deterministic=deterministic,
                                    generator=generator)
        logits = lm_head_apply(self.lm_head, hidden, self.config)
        return CLMOutput(hidden_state=hidden, logits=logits)

    def generate(self, *args, **kwargs):
        raise NotImplementedError("DecoderModel.generate (static-cache "
                                  "decoding) is not ported yet")
