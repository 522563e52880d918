"""GPT-style causal decoder as an ``nn.Module`` (counterpart of
``vyomai_tpu.models.decoder.DecoderModel``).

Positional embeddings ``"absolute" | "sinusoidal" | "rope"``, attention
``None`` (MHA) or ``"gqa"``. The module tree mirrors the JAX param tree
(``word_embeddings``, ``position_embeddings``, ``layers.{i}.attention``,
``layers.{i}.ffn``, ``lm_head``), so a JAX param path names the same tensor
here.

Parity quirk kept: each layer's FFN residual adds the *pre-attention* block
input. Without a cache, attention gets the pad bias ``[B, 1, 1, L]`` and
``causal=True``, so the flash route applies the triangle in-kernel and
skips future tiles.

Not ported yet (they raise): the static KV cache and ``generate``, packed
``segment_ids``/``positions``, and ``remat="dots"``.
"""

from typing import Optional

import torch
from torch import nn
from torch.nn.utils import skip_init
from torch.utils.checkpoint import checkpoint

from ..config import EncoderConfig
from ..core import nn as cnn
from ..core.masks import bidirectional_mask
from ..layers import attention as attn
from ..layers import ffn as ffn_mod
from ..layers import positional as pos
from .encoder import LMHead, lm_head_apply, lm_head_init_, stacked_layers
from .outputs import CLMOutput


class DecoderModel(nn.Module):
    def __init__(self, config: EncoderConfig,
                 pos_embedding_type: Optional[str] = "absolute",
                 attention_type: Optional[str] = None, remat: bool = False,
                 *, device=None, dtype=torch.float32):
        super().__init__()
        if remat == "dots":
            raise NotImplementedError(
                'remat="dots" (save matmul outputs, recompute the rest) is '
                "not ported yet; remat=True recomputes whole layers")
        device = torch.device("cpu" if device is None else device)
        self.config = config
        self.pos_embedding_type = pos_embedding_type
        self.kind = "gqa" if attention_type == "gqa" else "mha"
        self.remat = bool(remat)
        kw = dict(device=device, dtype=dtype)
        self.word_embeddings = skip_init(nn.Embedding, config.vocab_size,
                                         config.hidden_size, **kw)
        if pos_embedding_type == "absolute":
            self.position_embeddings = skip_init(
                nn.Embedding, config.max_position_embeddings,
                config.hidden_size, **kw)
        self.layers = stacked_layers(config, self.kind, **kw)
        self.lm_head = LMHead(config, **kw)
        # constant tables, computed on the CPU and moved
        if pos_embedding_type == "rope":
            self.register_buffer("emb_freq", pos.rope_freqs(
                config.max_position_embeddings, config.head_dim).to(device),
                persistent=False)
        elif pos_embedding_type == "sinusoidal":
            self.register_buffer("sin_table", pos.sinusoidal_table(
                config.max_position_embeddings, config.hidden_size
            ).to(device), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.word_embeddings.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.word_embeddings.weight.dtype

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "DecoderModel":
        """Random init from ``generator`` (the JAX scheme: normal(0,
        initializer_range) weights, zero biases, unit norms, the pad row of
        the token table zeroed). The generator must live on the model's
        device. Returns ``self``."""
        cfg = self.config
        cnn.embedding_init_(self.word_embeddings.weight,
                            cfg.initializer_range, generator,
                            pad_idx=getattr(cfg, "pad_token_id", None))
        if self.pos_embedding_type == "absolute":
            pos.absolute_init_(self.position_embeddings.weight, cfg,
                               generator)
        for layer in self.layers:
            layer.init_(cfg, generator)
        lm_head_init_(self.lm_head, cfg, generator)
        return self

    # -- forward ----------------------------------------------------------------
    def _embed(self, input_ids):
        seqlen = input_ids.shape[1]
        pad = getattr(self.config, "pad_token_id", None)
        hidden = cnn.embedding(self.word_embeddings.weight, input_ids,
                               pad_idx=pad)
        freqs = None
        if self.pos_embedding_type == "absolute":
            hidden = hidden + pos.absolute_slice(
                self.position_embeddings.weight, 0, seqlen,
                pad_idx=pad).to(hidden.dtype)
        elif self.pos_embedding_type == "sinusoidal":
            hidden = hidden + self.sin_table[:, :seqlen].to(hidden.dtype)
        elif self.pos_embedding_type == "rope":
            freqs = self.emb_freq[:, :seqlen]
        return hidden, freqs

    def _layer(self, layer, h, mask, freqs, causal, deterministic,
               generator):
        cfg = self.config
        out, _ = attn.decoder_attention_apply(
            layer.attention, h, mask, cfg, kind=self.kind, freqs=freqs,
            causal=causal, deterministic=deterministic, generator=generator)
        # FFN residual uses the pre-attention hidden state (parity quirk)
        return ffn_mod.ffn_apply(layer.ffn, out, h, cfg,
                                 deterministic=deterministic,
                                 generator=generator)

    def run_layers(self, hidden, mask, freqs, *, causal: bool = False,
                   deterministic: bool = True,
                   generator: Optional[torch.Generator] = None):
        if not deterministic and generator is None:
            raise ValueError(
                "deterministic=False requires a generator for dropout")
        for layer in self.layers:
            if not self.remat:
                hidden = self._layer(layer, hidden, mask, freqs, causal,
                                     deterministic, generator)
            elif deterministic:
                hidden = checkpoint(self._layer, layer, hidden, mask, freqs,
                                    causal, True, None, use_reentrant=False)
            else:
                hidden = self._remat_dropout_layer(layer, hidden, mask,
                                                   freqs, causal, generator)
        return hidden

    def _remat_dropout_layer(self, layer, hidden, mask, freqs, causal,
                             generator):
        """A checkpointed layer with dropout: the recompute in backward
        replays the forward's masks from a copy of the generator's state;
        the generator then continues from where the forward left it."""
        start, used = generator.get_state(), []

        def body(h):
            g = torch.Generator(device=h.device)
            g.set_state(start)
            used.append(g)
            return self._layer(layer, h, mask, freqs, causal, False, g)

        hidden = checkpoint(body, hidden, use_reentrant=False)
        generator.set_state(used[0].get_state())
        return hidden

    def hidden_states(self, input_ids, attention_mask=None, *,
                      deterministic: bool = True,
                      generator: Optional[torch.Generator] = None):
        """The last layer's output ``[B, L, h]`` (before the LM head)."""
        hidden, freqs = self._embed(input_ids)
        mask = (None if attention_mask is None
                else bidirectional_mask(attention_mask))
        return self.run_layers(hidden, mask, freqs, causal=True,
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
