"""Free-function decode loops (counterpart of
``vyomai_tpu.generation.generate``).

``generate`` (decoder-only, cached or uncached) and ``generate_hf``
(HF-``generate`` breadth: greedy, temperature / top-k / top-p / min-p
sampling, repetition penalty, n-gram blocking, ``min_new_tokens``,
per-lane eos with pad emission) run on any model with the protocol of
``DecoderModel`` and ``ModelForCausalLM``: ``config``, ``device``,
``init_cache(batch_size=, max_len=)`` (in the model's activation dtype)
and ``model(ids, attention_mask=, cache=, start_pos=)``. A prefill, then one cached step a
token into a fixed-size buffer, as the JAX package's jitted loops do.

Every step's position is known on the host (``prompt + i``), and the loops
read nothing back from the card: ``generate_hf`` runs all its steps even
once every lane has hit eos, since a dead lane only emits pad, which is
what the JAX ``while_loop`` leaves in the buffer when it stops early.
``jax.random`` cannot be reproduced, so sampling draws from an explicit
``torch.Generator`` (on the model's device; None seeds one with 0).

``generate_seq2seq`` and ``generate_multimodel`` wait for the seq2seq and
vision-language models (ROADMAP Queue 1 item 7) and raise.
"""

from typing import Optional

import torch

from .sampling import (_min_p_mask, _top_k_mask, _top_p_mask,
                       apply_min_new_tokens, apply_no_repeat_ngram,
                       apply_repetition_penalty, normalize_eos)


def _generator(model, generator, do_sample: bool):
    if do_sample and generator is None:
        return torch.Generator(device=model.device).manual_seed(0)
    return generator


def _sample(logits, temperature, do_sample: bool, generator):
    """Argmax, or a draw from ``softmax(logits / max(temperature,
    1e-6))``: the clamp makes ``temperature=0`` with sampling greedy
    instead of NaN."""
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.to(torch.float32) / max(temperature, 1e-6),
                          dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def _generate_decoder(model, idx, max_new_tokens: int, temperature: float,
                      generator, do_sample: bool, use_cache: bool):
    bsz, prompt_len = idx.shape
    total_len = prompt_len + max_new_tokens
    tokens = torch.zeros((bsz, total_len), dtype=idx.dtype, device=idx.device)
    tokens[:, :prompt_len] = idx
    if max_new_tokens < 1:
        return tokens
    if use_cache:
        cache = model.init_cache(batch_size=bsz, max_len=total_len)
        out = model(idx, cache=cache, start_pos=0)
        tokens[:, prompt_len] = _sample(out.logits[:, -1], temperature,
                                        do_sample, generator)
        for pos in range(prompt_len, total_len - 1):
            out = model(tokens[:, pos:pos + 1], cache=cache, start_pos=pos)
            tokens[:, pos + 1] = _sample(out.logits[:, -1], temperature,
                                         do_sample, generator)
        return tokens
    ar = torch.arange(total_len, device=idx.device)[None, :]
    for pos in range(prompt_len, total_len):
        step_mask = (ar < pos).to(torch.int32).expand(bsz, total_len)
        out = model(tokens, attention_mask=step_mask)
        tokens[:, pos] = _sample(out.logits[:, pos - 1], temperature,
                                 do_sample, generator)
    return tokens


def generate(model, tokenize_text, max_new_tokens: int = 3,
             temperature: float = 1.0, do_sample: bool = False,
             use_cache: bool = False,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Decoder-only generation. Returns ``[B, prompt + max_new_tokens]``
    (the prompt's dtype). Uncached, each step runs the whole fixed-size
    buffer with a step mask (the reference's growing-prefix forward)."""
    idx = torch.as_tensor(tokenize_text, device=model.device)
    return _generate_decoder(model, idx, int(max_new_tokens),
                             float(temperature),
                             _generator(model, generator, do_sample),
                             bool(do_sample), bool(use_cache))


@torch.no_grad()
def _generate_hf(model, idx, max_new_tokens: int, do_sample: bool,
                 generator, temperature: float, top_k: int, top_p: float,
                 min_p: float, repetition_penalty: float,
                 no_repeat_ngram_size: int, min_new_tokens: int, eos_ids,
                 pad_token_id: int):
    bsz, prompt_len = idx.shape
    total_len = prompt_len + max_new_tokens
    dev = idx.device
    tokens = torch.full((bsz, total_len), pad_token_id, dtype=torch.int32,
                        device=dev)
    tokens[:, :prompt_len] = idx
    cache = model.init_cache(batch_size=bsz, max_len=total_len)
    out = model(idx, cache=cache, start_pos=0)
    ar = torch.arange(total_len, device=dev)[None, :]
    eos_arr = None if eos_ids is None else torch.tensor(
        eos_ids, dtype=torch.int32, device=dev)

    def process(logits, cur_len: int):
        logits = logits.to(torch.float32)
        if repetition_penalty != 1.0:
            logits = apply_repetition_penalty(logits, tokens,
                                              repetition_penalty,
                                              ar < cur_len)
        if no_repeat_ngram_size:
            logits = apply_no_repeat_ngram(logits, tokens, cur_len,
                                           no_repeat_ngram_size)
        if eos_ids is not None:
            logits = apply_min_new_tokens(logits, eos_ids,
                                          cur_len - prompt_len,
                                          min_new_tokens)
        return logits

    def pick(logits):
        if not do_sample:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        logits = logits / max(temperature, 1e-6)
        if top_k:
            logits = _top_k_mask(logits, top_k)
        if top_p < 1.0:
            logits = _top_p_mask(logits, top_p)
        if min_p > 0.0:
            logits = _min_p_mask(logits, min_p)
        probs = torch.softmax(logits, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)

    alive = torch.ones(bsz, dtype=torch.bool, device=dev)

    def emit(logits, cur_len: int):
        nonlocal alive
        nxt = pick(process(logits, cur_len))
        nxt = torch.where(alive, nxt, pad_token_id)
        tokens[:, cur_len] = nxt
        if eos_arr is not None:
            alive = alive & ~torch.isin(nxt, eos_arr)

    emit(out.logits[:, -1], prompt_len)
    for pos in range(prompt_len, total_len - 1):
        out = model(tokens[:, pos:pos + 1], cache=cache, start_pos=pos)
        emit(out.logits[:, -1], pos + 1)
    return tokens


def generate_hf(model, input_ids, *, max_new_tokens: int = 32,
                do_sample: bool = False, temperature: float = 1.0,
                top_k: int = 0, top_p: float = 1.0, min_p: float = 0.0,
                repetition_penalty: float = 1.0,
                no_repeat_ngram_size: int = 0, min_new_tokens: int = 0,
                eos_token_id=None, pad_token_id: int = 0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
    """HF-``generate``-breadth decoding over the static cache: greedy and
    temperature / top-k / top-p / min-p sampling with repetition penalty,
    n-gram blocking, min-length eos suppression and per-lane eos (a
    finished lane emits ``pad_token_id``). ``eos_token_id`` defaults to the
    config's (an id or a list). Returns int32 ``[B, prompt +
    max_new_tokens]``; with ``max_new_tokens < 1`` the prompt itself."""
    if eos_token_id is None:
        eos_token_id = getattr(model.config, "eos_token_id", None)
    _, eos = normalize_eos(eos_token_id)
    ids = torch.as_tensor(input_ids, device=model.device).to(torch.int32)
    if int(max_new_tokens) < 1:
        # the JAX loop's first emit would clobber the last prompt token
        # (dynamic_update_slice clamps the out-of-bounds start)
        return ids
    return _generate_hf(model, ids, int(max_new_tokens), bool(do_sample),
                        _generator(model, generator, do_sample),
                        float(temperature), int(top_k), float(top_p),
                        float(min_p), float(repetition_penalty),
                        int(no_repeat_ngram_size), int(min_new_tokens),
                        tuple(eos) if eos else None, int(pad_token_id))


def generate_seq2seq(*args, **kwargs):
    raise NotImplementedError(
        "generate_seq2seq waits for the seq2seq models (ROADMAP Queue 1 "
        "item 7)")


def generate_multimodel(*args, **kwargs):
    raise NotImplementedError(
        "generate_multimodel waits for the vision-language models (ROADMAP "
        "Queue 1 item 7)")
