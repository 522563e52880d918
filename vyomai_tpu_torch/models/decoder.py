"""GPT-style causal decoder as an ``nn.Module`` (counterpart of
``vyomai_tpu.models.decoder.DecoderModel``).

Positional embeddings ``"absolute" | "sinusoidal" | "rope"``, attention
``None`` (MHA) or ``"gqa"``. The module tree mirrors the JAX param tree
(``word_embeddings``, ``position_embeddings``, ``layers.{i}.attention``,
``layers.{i}.ffn``, ``lm_head``), so a JAX param path names the same tensor
here. The body (embeddings, layer stack, remat) is ``encoder.TextModel``;
the model builds on the card unless ``device`` names another.

Parity quirks kept: each layer's FFN residual adds the *pre-attention*
block input; without a cache, attention gets the pad bias ``[B, 1, 1, L]``
and ``causal=True`` (the flash route applies the triangle in-kernel and
skips future tiles); with a cache (``layers.kv_cache``), the static-cache
mask over the whole buffer, and a cached step given no ``attention_mask``
attends every earlier position, pads included.

Not ported yet (they raise): packed ``segment_ids``/``positions`` and
``remat="dots"``.
"""

from typing import Optional

import torch

from ..config import EncoderConfig
from ..core.masks import bidirectional_mask, causal_mask_static_kv
from ..layers import attention as attn
from ..layers import ffn as ffn_mod
from ..layers.kv_cache import cache_max_len, init_cache, with_length
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

    def init_cache(self, *, batch_size: int = 1,
                   max_len: Optional[int] = None) -> dict:
        """A zeroed static cache on the model's device, in the model's
        dtype (the layers write their k/v into it uncast)."""
        cfg = self.config
        nkv = cfg.num_key_value_heads if self.kind == "gqa" else \
            cfg.num_attention_heads
        return init_cache(cfg, batch_size=batch_size, max_len=max_len,
                          dtype=self.dtype, num_kv_heads=nkv,
                          device=self.device)

    def _layer(self, layer, h, deterministic, generator, *, mask, freqs,
               causal, cache_kv=None, start_pos=0):
        cfg = self.config
        out, _ = attn.decoder_attention_apply(
            layer.attention, h, mask, cfg, kind=self.kind, freqs=freqs,
            cache_kv=cache_kv, start_pos=start_pos, causal=causal,
            deterministic=deterministic, generator=generator)
        # FFN residual uses the pre-attention hidden state (parity quirk)
        return ffn_mod.ffn_apply(layer.ffn, out, h, cfg,
                                 deterministic=deterministic,
                                 generator=generator)

    def hidden_states(self, input_ids, attention_mask=None, *,
                      start_pos: int = 0, deterministic: bool = True,
                      generator: Optional[torch.Generator] = None):
        """The last layer's output ``[B, L, h]`` (before the LM head),
        without a cache."""
        hidden, freqs = self.embed(input_ids, start_pos)
        mask = (None if attention_mask is None
                else bidirectional_mask(attention_mask))
        return self.run_layers(hidden, mask=mask, freqs=freqs, causal=True,
                               deterministic=deterministic,
                               generator=generator)

    def _cached_hidden_states(self, input_ids, attention_mask, cache,
                              start_pos, deterministic, generator):
        """The layer stack over the static ``cache`` (written in place)."""
        if not deterministic and generator is None:
            raise ValueError(
                "deterministic=False requires a generator for dropout")
        bsz, seqlen = input_ids.shape
        hidden, freqs = self.embed(input_ids, start_pos)
        mask = causal_mask_static_kv(seqlen, cache_max_len(cache), start_pos,
                                     attention_mask, batch_size=bsz,
                                     device=input_ids.device)
        for i, layer in enumerate(self.layers):
            hidden = self._layer(layer, hidden, deterministic, generator,
                                 mask=mask, freqs=freqs, causal=False,
                                 cache_kv=(cache["k"][i], cache["v"][i]),
                                 start_pos=start_pos)
        return hidden

    def forward(self, input_ids, attention_mask=None, cache=None,
                start_pos: int = 0, *, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                segment_ids=None, positions=None) -> CLMOutput:
        """Logits ``[B, L, V]``. With ``cache`` (from :meth:`init_cache`)
        the tokens sit at ``[start_pos, start_pos + L)``, their k/v are
        written into the cache in place, and ``kv_cache`` is the cache with
        ``length = start_pos + L``."""
        if segment_ids is not None or positions is not None:
            raise NotImplementedError(
                "packed segment_ids/positions are not ported yet")
        new_cache = None
        if cache is not None:
            hidden = self._cached_hidden_states(
                input_ids, attention_mask, cache, start_pos, deterministic,
                generator)
            new_cache = with_length(cache, start_pos + input_ids.shape[1])
        else:
            hidden = self.hidden_states(
                input_ids, attention_mask, start_pos=start_pos,
                deterministic=deterministic, generator=generator)
        logits = lm_head_apply(self.lm_head, hidden, self.config)
        return CLMOutput(hidden_state=hidden, logits=logits,
                         kv_cache=new_cache)

    @torch.no_grad()
    def generate(self, input_ids, attention_mask=None, max_len: int = 5,
                 temperature: float = 1.0, use_cache: bool = True,
                 do_sample: bool = False,
                 generator: Optional[torch.Generator] = None,
                 use_static_cache: bool = True) -> torch.Tensor:
        """Batched greedy or sampled generation (the JAX ``generate``):
        a prefill, then one token a step into a ``[B, prompt + max_len]``
        buffer, which it returns. The static cache is the only cache:
        ``use_static_cache`` is kept for the JAX signature, and ``False``
        raises.

        Quirks kept from the JAX package: (a) the llama-style
        ``input_text_mask`` replay (a position holding a non-pad token
        keeps it), inert for rectangular inputs, with eos tracked only on
        positions not replayed; (b) a cached step attends the whole prefix
        with no pad masking while the uncached path masks pads, so the two
        agree token for token only for all-valid masks; (c) sampling
        divides by ``temperature`` with no clamp (``_sample_token``).

        The JAX loop stops once every lane has emitted eos and leaves pad
        after that point. This loop reads nothing back: it runs every step
        and then writes pad over each position after the first step at
        which every lane had hit eos. That is exact, since a step's token
        never depends on a later step. ``prompt + max_len`` must not exceed
        ``max_position_embeddings`` (positions past the table would
        clamp). ``generator`` (on the model's device) drives sampling;
        None seeds one with 0."""
        if not use_static_cache:
            raise ValueError("use_static_cache=False: the static cache is "
                             "the only cache")
        cfg = self.config
        dev = self.device
        input_ids = torch.as_tensor(input_ids, device=dev)
        bsz, prompt_len = input_ids.shape
        total_len = prompt_len + max_len
        if total_len > cfg.max_position_embeddings:
            raise ValueError(
                f"prompt ({prompt_len}) + max_len ({max_len}) exceeds "
                f"max_position_embeddings ({cfg.max_position_embeddings}): "
                "positions past the table would silently clamp to its last "
                "row")
        if attention_mask is None:
            attention_mask = torch.ones((bsz, prompt_len), dtype=torch.int32,
                                        device=dev)
        if do_sample and generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        pad_id = getattr(cfg, "pad_token_id", 1)
        eos_id = getattr(cfg, "eos_token_id", 2)

        tokens = torch.full((bsz, total_len), pad_id, dtype=input_ids.dtype,
                            device=dev)
        tokens[:, :prompt_len] = input_ids
        mask_buf = torch.ones((bsz, total_len), dtype=torch.int32,
                              device=dev)
        mask_buf[:, :prompt_len] = torch.as_tensor(attention_mask,
                                                   device=dev)
        input_text_mask = tokens != pad_id
        eos = torch.zeros(bsz, dtype=torch.bool, device=dev)
        # all_eos[p]: every lane had hit eos before position p was written
        all_eos = torch.zeros(total_len, dtype=torch.bool, device=dev)

        def put(pos: int, nxt):
            nonlocal eos
            replay = input_text_mask[:, pos]
            nxt = torch.where(replay, tokens[:, pos], nxt.to(tokens.dtype))
            all_eos[pos] = eos.all()
            tokens[:, pos] = nxt
            eos = eos | (~replay & (nxt == eos_id))

        def sample(logits):
            return _sample_token(logits, temperature, do_sample, generator)

        if use_cache:
            cache = self.init_cache(batch_size=bsz, max_len=total_len)
            if prompt_len < total_len:
                out = self(tokens[:, :prompt_len],
                           attention_mask=mask_buf[:, :prompt_len],
                           cache=cache, start_pos=0)
                put(prompt_len, sample(out.logits[:, -1]))
            for pos in range(prompt_len + 1, total_len):
                out = self(tokens[:, pos - 1:pos], cache=cache,
                           start_pos=pos - 1)
                put(pos, sample(out.logits[:, -1]))
        else:
            ar = torch.arange(total_len, device=dev)[None, :]
            for pos in range(prompt_len, total_len):
                step_mask = (ar < pos) & (mask_buf != 0)
                out = self(tokens, attention_mask=step_mask.to(torch.int32))
                put(pos, sample(out.logits[:, pos - 1]))
        # the JAX loop's stop: positions written after every lane hit eos
        # stay pad (eos only accumulates, so all_eos stays set once set)
        return torch.where(all_eos[None, :], torch.full_like(tokens, pad_id),
                           tokens)


def _sample_token(logits, temperature, do_sample: bool, generator):
    """Argmax, or a draw from ``softmax(logits / temperature)`` (no clamp:
    ``temperature=0`` with sampling gives NaN, as in the JAX package)."""
    if do_sample:
        probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.argmax(logits, dim=-1)
