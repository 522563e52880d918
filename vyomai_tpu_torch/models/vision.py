"""Vision Transformer (counterpart of ``vyomai_tpu.models.vision.Vit``).

Patchify is a convolution with kernel == stride == patch size
(``F.conv2d``: a plain product, as the JAX package leaves it to XLA), then
the CLS token is prepended, the learned absolute position embeddings over
patches + 1 are added, and the encoder layers run with the fused-qkv
vision attention, which on the card takes the packed short-attention
kernels (K6 forward, K7 backward).

Parity quirks kept: the position add is doubled, ``2 * (tokens + pos)``
(the reference mutates its input in place and the caller adds it again),
and with no ``attention_mask`` no mask is built at all. The module tree
mirrors the JAX param tree (``pixel_seq.kernel`` in torch's ``[out, in,
kh, kw]`` layout, ``pixel_seq.bias``, ``cls_token``,
``position_embeddings.pos_embeddings``, ``layers.{i}``).
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import VisionConfig
from ..core.device import resolve_device
from ..core.masks import bidirectional_mask
from ..layers import attention as attn
from ..layers import ffn as ffn_mod
from ..layers import positional as pos
from .encoder import LayerStack, stacked_layers
from .outputs import EncoderOutput


def _param(*shape, device, dtype):
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


class PixelSeq(nn.Module):
    """The patchify convolution's ``kernel [hidden, C, ph, pw]`` and
    ``bias``."""

    def __init__(self, config: VisionConfig, *, device, dtype):
        super().__init__()
        ph, pw = config.patch_size
        self.kernel = _param(config.hidden_size, config.num_channels, ph, pw,
                             device=device, dtype=dtype)
        self.bias = _param(config.hidden_size, device=device, dtype=dtype)


class VitPositions(nn.Module):
    """The learned position table ``pos_embeddings [1, P+1, hidden]``."""

    def __init__(self, n: int, dim: int, *, device, dtype):
        super().__init__()
        self.pos_embeddings = _param(1, n, dim, device=device, dtype=dtype)


class Vit(LayerStack):
    """``model(pixel_values [B, C, H, W])``, the JAX ``apply``, returns
    ``EncoderOutput`` of ``[B, num_patches + 1, hidden]``. Builds on the
    card unless ``device`` names another."""

    def __init__(self, config: VisionConfig,
                 pos_embedding_type: Optional[str] = "absolute", *,
                 device=None, dtype=torch.float32):
        super().__init__(remat=False)
        device = resolve_device(device)
        self.config = config
        self.pos_embedding_type = pos_embedding_type
        kw = dict(device=device, dtype=dtype)
        self.pixel_seq = PixelSeq(config, **kw)
        self.cls_token = _param(1, 1, config.hidden_size, **kw)
        if pos_embedding_type == "absolute":
            self.position_embeddings = VitPositions(
                config.num_patches + 1, config.hidden_size, **kw)
        self.layers = stacked_layers(config, "vision", **kw)

    @property
    def device(self) -> torch.device:
        return self.cls_token.device

    @property
    def dtype(self) -> torch.dtype:
        return self.cls_token.dtype

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Vit":
        """Random init from ``generator`` (the JAX scheme: the conv kernel
        normal(0, initializer_range) with a zero bias, the CLS token and the
        position table standard normal, the layers as the encoder's).
        Returns ``self``."""
        cfg = self.config
        self.pixel_seq.kernel.normal_(0.0, cfg.initializer_range,
                                      generator=generator)
        self.pixel_seq.bias.zero_()
        self.cls_token.normal_(0.0, 1.0, generator=generator)
        if self.pos_embedding_type == "absolute":
            pos.vit_absolute_init_(self.position_embeddings.pos_embeddings,
                                   generator)
        for layer in self.layers:
            layer.init_(cfg, generator)
        return self

    def patchify(self, pixel_values):
        """``[B, C, H, W]`` -> ``[B, num_patches, hidden]``."""
        p = self.pixel_seq
        out = F.conv2d(pixel_values.to(p.kernel.dtype), p.kernel, p.bias,
                       stride=self.config.patch_size)
        return out.flatten(2).transpose(1, 2)

    def _layer(self, layer, h, deterministic, generator, *, mask):
        cfg = self.config
        out = attn.encoder_attention_apply(
            layer.attention, h, mask, cfg, kind="vision",
            deterministic=deterministic, generator=generator)
        return ffn_mod.ffn_apply(layer.ffn, out, h, cfg,
                                 deterministic=deterministic,
                                 generator=generator)

    def forward(self, pixel_values, attention_mask=None, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> EncoderOutput:
        hidden = self.patchify(pixel_values)
        cls = self.cls_token.to(hidden.dtype).expand(hidden.shape[0], -1, -1)
        hidden = torch.cat([cls, hidden], dim=1)
        if self.pos_embedding_type == "absolute":
            # the reference's in-place add, then its caller's add
            hidden = 2.0 * pos.vit_absolute_add(
                self.position_embeddings.pos_embeddings, hidden)
        mask = (None if attention_mask is None
                else bidirectional_mask(attention_mask))
        return EncoderOutput(logits=self.run_layers(
            hidden, mask=mask, deterministic=deterministic,
            generator=generator))
