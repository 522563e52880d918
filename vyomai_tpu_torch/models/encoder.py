"""Helpers of the encoder family that the decoder shares (counterpart of
``vyomai_tpu.models.encoder``): the LM head (dense -> exact GELU -> LN ->
vocab projection) and the layer stack. ``EncoderModel`` and
``EncoderForMaskedLM`` are not ported yet.

The JAX package stacks per-layer params on a leading ``[L]`` axis for
``lax.scan``; here the stack is an ``nn.ModuleList`` of layer modules, run
by a Python loop (``interop.from_jax`` unstacks).
"""

import torch
from torch import nn
from torch.nn.utils import skip_init

from ..core import nn as cnn
from ..layers import attention as attn
from ..layers import ffn as ffn_mod


class Layer(nn.Module):
    """One encoder/decoder block: ``attention`` and ``ffn``."""

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
