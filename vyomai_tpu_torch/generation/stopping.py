"""Stopping criteria for host-driven generation (counterpart of
``vyomai_tpu.generation.stopping``).

``generate``'s loops stop only on an eos id. Keyword and substring
stopping needs the text, which only the host has: :func:`generate_until`
runs the same cached single-token steps and shows the criteria each new
token, reading it back once a step.
"""

from typing import Callable, List, Optional, Sequence

import torch

from .sampling import normalize_eos


class KeywordsStoppingCriteria:
    """Stop when the last token is a single-token keyword, or when a
    keyword appears in the decoded continuation.

    ``tokenizer`` needs ``__call__(text) -> ids`` (a list, or an object
    with ``.input_ids``) and, for substring matching, ``decode(ids) ->
    str``."""

    def __init__(self, keywords: Sequence[str], tokenizer, input_ids):
        self.keywords = list(keywords)
        self.tokenizer = tokenizer
        self.keyword_ids: List[int] = []
        for kw in self.keywords:
            ids = tokenizer(kw)
            ids = getattr(ids, "input_ids", ids)
            if isinstance(ids, (list, tuple)) and len(ids) == 1:
                self.keyword_ids.append(int(ids[0]))
        self.start_len = int(torch.as_tensor(input_ids).shape[1])

    def __call__(self, output_ids, scores=None, **kw) -> bool:
        out = torch.as_tensor(output_ids)
        if out.shape[1] <= self.start_len:
            return False
        row = out[0].tolist()
        if row[-1] in self.keyword_ids:
            return True
        if hasattr(self.tokenizer, "decode"):
            text = self.tokenizer.decode(row[self.start_len:])
            return any(kw_ in text for kw_ in self.keywords)
        return False


@torch.no_grad()
def generate_until(model, input_ids, *,
                   stopping_criteria: Optional[Callable] = None,
                   max_new_tokens: int = 128,
                   eos_token_id: Optional[int] = None,
                   sample_fn: Optional[Callable] = None,
                   cache=None, prefill_fn=None) -> torch.Tensor:
    """Greedy (or ``sample_fn(logits) -> ids``) cached decode with
    host-side stopping criteria, batch 1. Returns the token row ``[1,
    prompt + generated]`` (int32). Stops on an eos id (the config's by
    default), on ``stopping_criteria(tokens)``, or after
    ``max_new_tokens``.

    ``prefill_fn(input_ids, cache) -> (last_logits, cache)`` lets a
    multimodal wrapper supply its own prefill."""
    if eos_token_id is None:
        eos_token_id = getattr(model.config, "eos_token_id", None)
    _, eos_ids = normalize_eos(eos_token_id)
    input_ids = torch.as_tensor(input_ids, device=model.device).to(
        torch.int32)
    if input_ids.shape[0] != 1:
        raise ValueError("generate_until is a batch-1 driver")
    prompt_len = input_ids.shape[1]
    if cache is None:
        cache = model.init_cache(batch_size=1,
                                 max_len=prompt_len + max_new_tokens)
    if prefill_fn is None:
        out = model(input_ids, cache=cache, start_pos=0)
        logits, cache = out.logits[:, -1], out.kv_cache
    else:
        logits, cache = prefill_fn(input_ids, cache)

    tokens = input_ids
    for i in range(max_new_tokens):
        if sample_fn is None:
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            nxt = sample_fn(logits).to(torch.int32)
        tokens = torch.cat([tokens, nxt[:, None]], dim=1)
        if int(nxt[0]) in eos_ids:
            break
        if stopping_criteria is not None and stopping_criteria(tokens):
            break
        if i + 1 < max_new_tokens:
            out = model(nxt[:, None], cache=cache, start_pos=prompt_len + i)
            logits, cache = out.logits[:, -1], out.kv_cache
    return tokens
