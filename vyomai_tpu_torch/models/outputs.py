"""Model output containers (counterpart of ``vyomai_tpu.models.outputs``)."""

from typing import Any, NamedTuple, Optional

import torch


class EncoderOutput(NamedTuple):
    logits: torch.Tensor


class MLMOutput(NamedTuple):
    hidden_state: torch.Tensor
    logits: torch.Tensor


class CLMOutput(NamedTuple):
    hidden_state: torch.Tensor
    logits: torch.Tensor
    kv_cache: Optional[Any] = None
    # mean router load-balancing loss over MoE layers (None for dense
    # models)
    aux_loss: Optional[torch.Tensor] = None
