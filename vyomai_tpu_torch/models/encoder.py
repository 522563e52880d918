"""BERT-style bidirectional encoder and the pieces the encoder, decoder and
ViT models share (counterpart of ``vyomai_tpu.models.encoder``):
``EncoderModel``, ``EncoderForMaskedLM``, the LM head (dense -> exact GELU
-> LN -> vocab projection) and the layer stack.

The JAX package stacks per-layer params on a leading ``[L]`` axis for
``lax.scan``; here the stack is an ``nn.ModuleList`` of layer modules, run
by a Python loop (``interop.from_jax`` unstacks). ``remat=True`` checkpoints
each layer (``torch.utils.checkpoint``); with dropout the recompute replays
the forward's masks. ``remat="dots"`` is not ported yet.

Parity quirk kept: each layer's FFN residual adds the *pre-attention*
block input. ``EncoderModel``'s forward always builds the key-pad bias
``[B, 1, 1, L]`` (all zeros without an ``attention_mask``), so on the card
the ``"auto"`` route runs it through the short-attention kernels (K5
forward, K7 backward) at ``L <= 512``.
"""

import functools
from typing import Optional

import torch
from torch import nn
from torch.nn.utils import skip_init
from torch.utils.checkpoint import checkpoint

from ..config import EncoderConfig
from ..core import nn as cnn
from ..core.device import resolve_device
from ..core.masks import bidirectional_mask
from ..layers import attention as attn
from ..layers import ffn as ffn_mod
from ..layers import positional as pos
from .outputs import EncoderOutput, MLMOutput


class Layer(nn.Module):
    """One encoder/decoder/vision block: ``attention`` and ``ffn``."""

    def __init__(self, config, kind: str, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attention = attn.Attention(config, kind, **kw)
        self.ffn = ffn_mod.FFN(config, **kw)

    def init_(self, config, generator: torch.Generator):
        attn.attention_init_(self.attention, config, generator)
        ffn_mod.ffn_init_(self.ffn, config, generator)


def stacked_layers(config, kind: str, *, device=None, dtype=torch.float32
                   ) -> nn.ModuleList:
    """``config.num_hidden_layers`` blocks (the JAX
    ``stacked_layers_init``'s counterpart, uninitialized: call each
    layer's ``init_``)."""
    return nn.ModuleList(Layer(config, kind, device=device, dtype=dtype)
                         for _ in range(config.num_hidden_layers))


class LayerStack(nn.Module):
    """A model built around ``self.layers``: runs them in order, with
    per-layer checkpointing when ``self.remat``. Subclasses define
    ``_layer(layer, h, deterministic, generator, **kw)``."""

    def __init__(self, remat=False):
        super().__init__()
        if remat == "dots":
            raise NotImplementedError(
                'remat="dots" (save matmul outputs, recompute the rest) is '
                "not ported yet; remat=True recomputes whole layers")
        self.remat = bool(remat)

    def _layer(self, layer, h, deterministic, generator, **kw):
        raise NotImplementedError

    def run_layers(self, hidden, *, deterministic: bool = True,
                   generator: Optional[torch.Generator] = None, **kw):
        """The layer stack over ``hidden``; ``kw`` goes to every
        ``_layer`` call (mask, rotation angles, ...)."""
        if not deterministic and generator is None:
            raise ValueError(
                "deterministic=False requires a generator for dropout")
        for layer in self.layers:
            fn = functools.partial(self._layer, layer, **kw)
            if not self.remat:
                hidden = fn(hidden, deterministic, generator)
            elif deterministic:
                hidden = checkpoint(fn, hidden, True, None,
                                    use_reentrant=False)
            else:
                hidden = _remat_dropout_layer(fn, hidden, generator)
        return hidden


def _remat_dropout_layer(fn, hidden, generator):
    """A checkpointed layer with dropout: the recompute in backward replays
    the forward's masks from a copy of the generator's state; the generator
    then continues from where the forward left it."""
    start, used = generator.get_state(), []

    def body(h):
        g = torch.Generator(device=h.device)
        g.set_state(start)
        used.append(g)
        return fn(h, False, g)

    hidden = checkpoint(body, hidden, use_reentrant=False)
    generator.set_state(used[0].get_state())
    return hidden


class TextModel(LayerStack):
    """Token and position embeddings over a layer stack, the shared body of
    ``EncoderModel`` and ``DecoderModel``. Positional embeddings
    ``"absolute" | "sinusoidal" | "rope"``, attention ``None`` (MHA) or
    ``"gqa"``. The module tree mirrors the JAX param tree
    (``word_embeddings``, ``position_embeddings``, ``layers.{i}.attention``,
    ``layers.{i}.ffn``), so a JAX param path names the same tensor here.
    Builds on the card unless ``device`` names another."""

    def __init__(self, config: EncoderConfig,
                 pos_embedding_type: Optional[str] = "absolute",
                 attention_type: Optional[str] = None, remat: bool = False,
                 *, device=None, dtype=torch.float32):
        super().__init__(remat)
        device = resolve_device(device)
        self.config = config
        self.pos_embedding_type = pos_embedding_type
        self.kind = "gqa" if attention_type == "gqa" else "mha"
        kw = dict(device=device, dtype=dtype)
        self.word_embeddings = skip_init(nn.Embedding, config.vocab_size,
                                         config.hidden_size, **kw)
        if pos_embedding_type == "absolute":
            self.position_embeddings = skip_init(
                nn.Embedding, config.max_position_embeddings,
                config.hidden_size, **kw)
        self.layers = stacked_layers(config, self.kind, **kw)
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
    def _init_body(self, generator: torch.Generator):
        """Random init of the embeddings and layers (the JAX scheme:
        normal(0, initializer_range) weights, zero biases, unit norms, the
        pad row of the token table zeroed)."""
        cfg = self.config
        cnn.embedding_init_(self.word_embeddings.weight,
                            cfg.initializer_range, generator,
                            pad_idx=getattr(cfg, "pad_token_id", None))
        if self.pos_embedding_type == "absolute":
            pos.absolute_init_(self.position_embeddings.weight, cfg,
                               generator)
        for layer in self.layers:
            layer.init_(cfg, generator)

    def embed(self, input_ids, start_pos: int = 0):
        """Token + positional embedding for positions ``[start_pos,
        start_pos + L)``; returns ``(hidden, freqs)``."""
        seqlen = input_ids.shape[1]
        pad = getattr(self.config, "pad_token_id", None)
        hidden = cnn.embedding(self.word_embeddings.weight, input_ids,
                               pad_idx=pad)
        freqs = None
        if self.pos_embedding_type == "absolute":
            hidden = hidden + pos.absolute_slice(
                self.position_embeddings.weight, start_pos, seqlen,
                pad_idx=pad).to(hidden.dtype)
        elif self.pos_embedding_type == "sinusoidal":
            hidden = hidden + pos.table_slice(
                self.sin_table, start_pos, seqlen).to(hidden.dtype)
        elif self.pos_embedding_type == "rope":
            freqs = pos.table_slice(self.emb_freq, start_pos, seqlen)
        return hidden, freqs


class EncoderModel(TextModel):
    """Bidirectional encoder (counterpart of the JAX ``EncoderModel``):
    ``model(input_ids, attention_mask)``, the JAX ``apply``, returns
    ``EncoderOutput(logits=last hidden state)``."""

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "EncoderModel":
        """Random init from ``generator`` (on the model's device); returns
        ``self``."""
        self._init_body(generator)
        return self

    def _layer(self, layer, h, deterministic, generator, *, mask, freqs):
        cfg = self.config
        out = attn.encoder_attention_apply(
            layer.attention, h, mask, cfg, kind=self.kind, freqs=freqs,
            deterministic=deterministic, generator=generator)
        # FFN residual uses the pre-attention hidden state (parity quirk)
        return ffn_mod.ffn_apply(layer.ffn, out, h, cfg,
                                 deterministic=deterministic,
                                 generator=generator)

    def forward(self, input_ids, attention_mask=None, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> EncoderOutput:
        hidden, freqs = self.embed(input_ids)
        if attention_mask is None:
            attention_mask = torch.ones(input_ids.shape, dtype=torch.float32,
                                        device=input_ids.device)
        hidden = self.run_layers(hidden, mask=bidirectional_mask(
            attention_mask), freqs=freqs, deterministic=deterministic,
            generator=generator)
        return EncoderOutput(logits=hidden)


class LMHead(nn.Module):
    """``dense`` (h -> h), ``layer_norm`` and ``decoder`` (h -> vocab),
    all with biases."""

    def __init__(self, config, *, device=None, dtype=torch.float32):
        super().__init__()
        h, kw = config.hidden_size, dict(device=device, dtype=dtype)
        self.dense = skip_init(nn.Linear, h, h, **kw)
        self.layer_norm = skip_init(nn.LayerNorm, h, **kw)
        self.decoder = skip_init(nn.Linear, h, config.vocab_size, **kw)


def lm_head_init_(p: LMHead, config, generator: torch.Generator):
    std = config.initializer_range
    cnn.linear_init_(p.dense, std, generator)
    cnn.layer_norm_init_(p.layer_norm)
    cnn.linear_init_(p.decoder, std, generator)


def lm_head_transform(p: LMHead, hidden, config):
    """dense -> exact GELU -> LN: the head's input to the vocab
    projection."""
    x = cnn.gelu(cnn.linear(p.dense.weight, hidden, p.dense.bias))
    return cnn.layer_norm(p.layer_norm.weight, p.layer_norm.bias, x,
                          eps=getattr(config, "layer_norm_eps", 1e-6))


def lm_head_apply(p: LMHead, hidden, config):
    return cnn.linear(p.decoder.weight, lm_head_transform(p, hidden, config),
                      p.decoder.bias)


class EncoderForMaskedLM(nn.Module):
    """``encoder`` (:class:`EncoderModel`) + ``lm_head`` (counterpart of the
    JAX ``EncoderForMaskedLM``). Builds on the card unless ``device`` names
    another."""

    def __init__(self, config: EncoderConfig,
                 pos_embedding_type: Optional[str] = "absolute",
                 attention_type: Optional[str] = None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.encoder = EncoderModel(config, pos_embedding_type,
                                    attention_type, device=device,
                                    dtype=dtype)
        self.lm_head = LMHead(config, device=device, dtype=dtype)

    @property
    def device(self) -> torch.device:
        return self.encoder.device

    @property
    def dtype(self) -> torch.dtype:
        return self.encoder.dtype

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "EncoderForMaskedLM":
        self.encoder.init(generator)
        lm_head_init_(self.lm_head, self.config, generator)
        return self

    def forward(self, input_ids, attention_mask=None, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> MLMOutput:
        hidden = self.encoder(input_ids, attention_mask,
                              deterministic=deterministic,
                              generator=generator).logits
        return MLMOutput(hidden_state=hidden,
                         logits=lm_head_apply(self.lm_head, hidden,
                                              self.config))
