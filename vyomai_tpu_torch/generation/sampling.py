"""Logit masks for sampling (counterpart of the masks in
``vyomai_tpu.generation.sampling``)."""

import torch

_MASKED = -1e20  # masked-logit fill value, as in the JAX package


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


def normalize_eos(eos_token_id):
    """(primary_id | None, tuple of all ids) from ``int | list | tuple |
    None`` (HF configs may list several eos ids)."""
    if eos_token_id is None:
        return None, ()
    if isinstance(eos_token_id, (list, tuple)):
        ids = tuple(int(t) for t in eos_token_id)
        return (ids[0] if ids else None), ids
    return int(eos_token_id), (int(eos_token_id),)
