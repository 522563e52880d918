"""Logits processors, masks and penalties (counterpart of
``vyomai_tpu.generation.sampling``).

A processor's ``__call__`` returns ``softmax(process(logits) / T)``;
``sample(probs, generator)`` draws a token ``[..., 1]`` from an explicit
``torch.Generator`` (greedy ignores it). The penalties are static-shape
functions of a fixed-size token buffer, as the JAX loops use them. Masked
logits take ``_MASKED`` (-1e20), as in the JAX package.
"""

import abc
from typing import Optional

import torch

_MASKED = -1e20  # masked-logit fill value, as in the JAX package


class LogitsProcessor(abc.ABC):
    def __init__(self, temperature: float = 1.0):
        self.temperature = temperature

    def __call__(self, logits: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self._process(logits) / self.temperature,
                             dim=-1)

    @abc.abstractmethod
    def _process(self, logits: torch.Tensor) -> torch.Tensor:
        ...

    def sample(self, probs: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """A draw ``[B, 1]`` from ``probs [B, V]`` (the JAX draw from
        ``log(probs + 1e-20)``)."""
        if generator is None:
            raise ValueError("sampling processors require a generator")
        return torch.multinomial(probs + 1e-20, 1, generator=generator)


class GreedyProcessor(LogitsProcessor):
    """Most probable token."""

    def _process(self, logits):
        return logits

    def sample(self, probs, generator=None):
        return torch.argmax(probs, dim=-1)[..., None]


class MultinomialProcessor(LogitsProcessor):
    """Random sampling from the full distribution."""

    def _process(self, logits):
        return logits


def _top_k_mask(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Keep the logits at or above the ``top_k``-th largest."""
    k = min(top_k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, _MASKED)


def _top_p_mask(logits: torch.Tensor, top_p) -> torch.Tensor:
    """Nucleus mask: keep the smallest prefix of descending-probability
    tokens whose mass reaches ``top_p`` (the first token above the
    threshold is kept). ``top_p``: scalar or ``[..., 1]``-broadcastable."""
    sorted_logits, sorted_idx = torch.sort(logits, dim=-1, descending=True,
                                           stable=True)
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    remove = cum > top_p
    remove = torch.cat([torch.zeros_like(remove[..., :1]), remove[..., :-1]],
                       dim=-1)
    sorted_logits = sorted_logits.masked_fill(remove, _MASKED)
    return torch.empty_like(logits).scatter_(-1, sorted_idx, sorted_logits)


def _min_p_mask(logits: torch.Tensor, min_p) -> torch.Tensor:
    """min-p mask: keep tokens whose probability is at least ``min_p``
    times the top token's."""
    probs = torch.softmax(logits, dim=-1)
    cutoff = min_p * probs.amax(dim=-1, keepdim=True)
    return logits.masked_fill(probs < cutoff, _MASKED)


class TopKProcessor(MultinomialProcessor):
    def __init__(self, temperature: float, top_k: int):
        super().__init__(temperature)
        self.top_k = top_k

    def _process(self, logits):
        return _top_k_mask(logits, self.top_k)


class NucleusProcessor(MultinomialProcessor):
    def __init__(self, temperature: float, top_p: float):
        super().__init__(temperature)
        self.top_p = top_p

    def _process(self, logits):
        return _top_p_mask(logits, self.top_p)


class TopKNucleusProcessor(MultinomialProcessor):
    def __init__(self, temperature: float, top_k: int, top_p: float):
        super().__init__(temperature)
        self.top_k = top_k
        self.top_p = top_p

    def _process(self, logits):
        return _top_p_mask(_top_k_mask(logits, self.top_k), self.top_p)


class MinPProcessor(MultinomialProcessor):
    def __init__(self, temperature: float, min_p: float):
        super().__init__(temperature)
        self.min_p = min_p

    def _process(self, logits):
        return _min_p_mask(logits, self.min_p)


# -- context-aware penalties ----------------------------------------------------

def _any_per_token(ids: torch.Tensor, flags: torch.Tensor,
                   vocab: int) -> torch.Tensor:
    """``[B, V]`` bool: for each row, whether some position with a set flag
    holds that id. Ids outside ``[0, V)`` are dropped, as a JAX scatter
    drops them."""
    inside = (ids >= 0) & (ids < vocab)
    hit = torch.zeros((ids.shape[0], vocab), dtype=torch.int32,
                      device=ids.device)
    hit.scatter_reduce_(1, ids.clamp(0, vocab - 1).long(),
                        (flags & inside).to(torch.int32), reduce="amax")
    return hit > 0


def apply_repetition_penalty(logits: torch.Tensor, token_ids: torch.Tensor,
                             penalty: float, valid=None) -> torch.Tensor:
    """CTRL-style repetition penalty (HF
    ``RepetitionPenaltyLogitsProcessor``): for every id in ``token_ids [B,
    T]`` (where ``valid [B, T]``, when given, is nonzero), positive logits
    are divided by ``penalty`` and negative ones multiplied by it."""
    if penalty == 1.0:
        return logits
    flags = torch.ones_like(token_ids, dtype=torch.bool) if valid is None \
        else valid != 0
    present = _any_per_token(token_ids, flags, logits.shape[-1])
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(present, penalized, logits)


def apply_no_repeat_ngram(logits: torch.Tensor, token_buf: torch.Tensor,
                          cur_len: int, ngram_size: int) -> torch.Tensor:
    """Ban the tokens that would complete an n-gram already in the first
    ``cur_len`` tokens of ``token_buf [B, L]`` (HF
    ``NoRepeatNGramLogitsProcessor``), by fixed-shape window comparisons.
    ``ngram_size`` >= 2."""
    n = int(ngram_size)
    if n < 2:
        raise ValueError("no_repeat_ngram_size must be >= 2")
    l = token_buf.shape[1]
    if l < n or cur_len < n - 1:
        return logits     # before n-1 tokens exist there is nothing to ban
    dev = token_buf.device
    start = min(max(cur_len - (n - 1), 0), l - (n - 1))
    prefix = token_buf[:, start:start + n - 1]
    starts = torch.arange(l - n + 1, device=dev)
    wins = token_buf[:, starts[:, None] + torch.arange(n - 1, device=dev)]
    match = (wins == prefix[:, None, :]).all(dim=-1)             # [B, S]
    observed = (starts + n - 1) < cur_len   # completion token already seen
    completion = token_buf[:, starts + n - 1]                    # [B, S]
    ban = _any_per_token(completion, match & observed[None],
                         logits.shape[-1])
    return logits.masked_fill(ban, _MASKED)


def apply_suppress_tokens(logits: torch.Tensor, token_ids) -> torch.Tensor:
    """Mask a fixed set of token ids everywhere (HF
    ``SuppressTokensLogitsProcessor``)."""
    ids = torch.atleast_1d(torch.as_tensor(token_ids, device=logits.device))
    sup = torch.zeros(logits.shape[-1], dtype=torch.bool,
                      device=logits.device)
    sup[ids.long()] = True
    return logits.masked_fill(sup[None, :], _MASKED)


def apply_forced_token(logits: torch.Tensor, forced_id, fire) -> torch.Tensor:
    """Force ``forced_id`` (HF ``ForcedBOS/EOSTokenLogitsProcessor``): where
    ``fire`` (a bool or a bool tensor) holds, every other id is masked."""
    keep = torch.zeros(logits.shape[-1], dtype=torch.bool,
                       device=logits.device)
    keep[int(forced_id)] = True
    forced = logits.masked_fill(~keep[None, :], _MASKED)
    fire = torch.as_tensor(fire, device=logits.device)
    return torch.where(fire, forced, logits)


def apply_min_new_tokens(logits: torch.Tensor, eos_token_id, new_len,
                         min_new_tokens: int) -> torch.Tensor:
    """Suppress eos (an id or a sequence of ids; a negative id counts from
    the end of the vocabulary, as a JAX index does) until
    ``min_new_tokens`` have been generated (HF
    ``MinNewTokensLengthLogitsProcessor``)."""
    if min_new_tokens <= 0:
        return logits
    suppressed = apply_suppress_tokens(logits, eos_token_id)
    return torch.where(torch.as_tensor(new_len < min_new_tokens,
                                       device=logits.device),
                       suppressed, logits)


def normalize_eos(eos_token_id):
    """(primary_id | None, tuple of all ids) from ``int | list | tuple |
    None`` (HF configs may list several eos ids)."""
    if eos_token_id is None:
        return None, ()
    if isinstance(eos_token_id, (list, tuple)):
        ids = tuple(int(t) for t in eos_token_id)
        return (ids[0] if ids else None), ids
    return int(eos_token_id), (int(eos_token_id),)
