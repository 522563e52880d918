"""Feed-forward block (counterpart of ``vyomai_tpu.layers.ffn``): linear
(4x hidden) -> activation -> linear -> dropout -> post-LN residual.

The residual added before the LayerNorm is whatever the caller passes as
``input_tensor``; the decoder passes the *pre-attention* block input, a
quirk of the reference kept for parity.
"""

from typing import Optional

import torch
from torch import nn
from torch.nn.utils import skip_init

from ..core import nn as cnn


class FFN(nn.Module):
    """Weights of one feed-forward block: ``intermediate`` [4h, h], ``out``
    [h, 4h] (``nn.Linear`` layout, with biases) and ``layernorm``. The
    width is ``4 * hidden_size`` as in the JAX ``ffn_init``, whatever
    ``intermediate_size`` says."""

    def __init__(self, config, multiplier: float = 4, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        h = config.hidden_size
        inter = int(multiplier) * h
        kw = dict(device=device, dtype=dtype)
        self.intermediate = skip_init(nn.Linear, h, inter, **kw)
        self.out = skip_init(nn.Linear, inter, h, **kw)
        self.layernorm = skip_init(nn.LayerNorm, h, **kw)


def ffn_init_(p: FFN, config, generator: torch.Generator):
    std = config.initializer_range
    cnn.linear_init_(p.intermediate, std, generator)
    cnn.linear_init_(p.out, std, generator)
    cnn.layer_norm_init_(p.layernorm)


def ffn_apply(p: FFN, hidden: torch.Tensor, input_tensor: torch.Tensor,
              config, *, deterministic: bool = True,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    act = cnn.get_act(getattr(config, "hidden_act", None))
    h = act(cnn.linear(p.intermediate.weight, hidden, p.intermediate.bias))
    h = cnn.linear(p.out.weight, h, p.out.bias)
    h = cnn.dropout(h, config.hidden_dropout_prob,
                    deterministic=deterministic, generator=generator)
    return cnn.layer_norm(p.layernorm.weight, p.layernorm.bias,
                          h + input_tensor, eps=config.layer_norm_eps)
