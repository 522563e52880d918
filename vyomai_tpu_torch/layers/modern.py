"""Modern decoder-layer modules (counterpart of
``vyomai_tpu.layers.modern``): pre-norm RMSNorm, GQA attention projections
with optional per-head QK-norm, SwiGLU MLP, no biases.

The module tree mirrors the JAX param layout of ``modern_layer_init``
(``input_layernorm``, ``self_attn.{q,k,v,o}_proj``, ``self_attn.{q,k}_norm``,
``post_attention_layernorm``, ``mlp.{gate,up,down}_proj``), so a JAX param
path names the same tensor here. Modules are built with
``torch.nn.utils.skip_init`` and filled by :meth:`ModernLayer.init` from an
explicit ``torch.Generator``: the global RNG is never read.
"""

import torch
from torch import nn
from torch.nn.utils import skip_init

from ..core import nn as cnn


def _linear(in_dim: int, out_dim: int, device, dtype) -> nn.Linear:
    return skip_init(nn.Linear, in_dim, out_dim, bias=False,
                     device=torch.device("cpu" if device is None else device),
                     dtype=dtype)


class RMSNorm(nn.Module):
    """Holds an RMSNorm weight; ``core.nn.rms_norm`` applies it with the
    config's epsilon."""

    def __init__(self, dim: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device,
                                              dtype=dtype))


class Attention(nn.Module):
    """Projection weights of one attention block (the attention itself runs
    in ``serving.paged_model`` over the paged pool)."""

    def __init__(self, config, *, device=None, dtype=torch.float32):
        super().__init__()
        h, nh, nkv, hd = (config.hidden_size, config.num_attention_heads,
                          config.num_key_value_heads, config.head_dim)
        self.q_proj = _linear(h, nh * hd, device, dtype)
        self.k_proj = _linear(h, nkv * hd, device, dtype)
        self.v_proj = _linear(h, nkv * hd, device, dtype)
        self.o_proj = _linear(nh * hd, h, device, dtype)
        if config.qk_norm:
            self.q_norm = RMSNorm(hd, device=device, dtype=dtype)
            self.k_norm = RMSNorm(hd, device=device, dtype=dtype)
        else:
            self.q_norm = self.k_norm = None


class SwiGLU(nn.Module):
    def __init__(self, config, *, device=None, dtype=torch.float32):
        super().__init__()
        h, inter = config.hidden_size, config.intermediate_size
        self.gate_proj = _linear(h, inter, device, dtype)
        self.up_proj = _linear(h, inter, device, dtype)
        self.down_proj = _linear(inter, h, device, dtype)


def swiglu_apply(mlp: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    """``down(silu(gate(x)) * up(x))`` (float or quantized projections)."""
    gate = torch.nn.functional.silu(cnn.apply_linear(mlp.gate_proj, x))
    return cnn.apply_linear(mlp.down_proj,
                            gate * cnn.apply_linear(mlp.up_proj, x))


class ModernLayer(nn.Module):
    def __init__(self, config, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(config.hidden_size, **kw)
        self.self_attn = Attention(config, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, **kw)
        self.mlp = SwiGLU(config, **kw)

    @torch.no_grad()
    def init(self, generator: torch.Generator, std: float = 0.02):
        """The JAX init: normal(0, std) projections, unit norm weights."""
        for name, p in self.named_parameters():
            if name.endswith("_proj.weight"):
                p.normal_(0.0, std, generator=generator)
            else:
                p.fill_(1.0)
