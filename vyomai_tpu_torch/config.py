"""Configuration dataclasses for the PyTorch port.

``EncoderConfig``, ``VisionConfig`` and ``QwenConfig`` carry the same
fields and defaults as
their counterparts in ``vyomai_tpu.config`` (``QwenConfig``: Qwen3-0.6B's
published ``config.json``), so one config value describes the model in
both packages. Qwen features the port does not run yet raise
``NotImplementedError`` at construction. ``Lfm2MoeConfig`` is the port's
own (the JAX package has no such model): LFM2-8B-A1B's published
``config.json`` under its own key names.
"""

from dataclasses import dataclass, replace
from typing import Optional, Tuple, Union


@dataclass(frozen=True)
class EncoderConfig:
    """Text-model config of the encoder/decoder families (RoBERTa-base
    flavored defaults, 4 layers)."""

    hidden_size: int = 768
    num_attention_heads: int = 12
    max_position_embeddings: int = 514
    num_hidden_layers: int = 4
    vocab_size: int = 50265
    hidden_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-05
    hidden_act: str = "gelu"
    num_key_value_heads: int = 4
    attention_bias: bool = True
    pad_token_id: int = 1
    eos_token_id: int = 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def replace(self, **kw) -> "EncoderConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class VisionConfig:
    """ViT config (ViT-base/16 widths at 224 px, 4 layers)."""

    image_size: Tuple[int, int] = (224, 224)
    patch_size: Tuple[int, int] = (16, 16)
    num_channels: int = 3
    hidden_size: int = 768
    num_attention_heads: int = 12
    num_hidden_layers: int = 4
    hidden_dropout_prob: float = 0.1
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-05
    hidden_act: str = "gelu"
    attention_bias: bool = True
    initializer_range: float = 0.02

    @property
    def num_patches(self) -> int:
        return (self.image_size[0] // self.patch_size[0]) * (
            self.image_size[1] // self.patch_size[1])

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def replace(self, **kw) -> "VisionConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class QwenConfig:
    """Qwen2/3-flavored causal-LM config (RMSNorm, SwiGLU, GQA, RoPE,
    optional QK-norm, tied lm_head)."""

    vocab_size: int = 151936
    hidden_size: int = 1024
    intermediate_size: int = 3072
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    max_position_embeddings: int = 40960
    rms_norm_eps: float = 1e-06
    rope_theta: float = 1000000.0
    rope_scaling: Optional[dict] = None
    sliding_window: Optional[int] = None
    attention_sinks: int = 0
    attention_bias: bool = False
    qk_norm: bool = True
    tie_word_embeddings: bool = True
    pad_token_id: int = 151643
    eos_token_id: Union[int, Tuple[int, ...]] = 151645
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.01
    moe_impl: str = "einsum"

    def __post_init__(self):
        unported = {
            "rope_scaling": self.rope_scaling is not None,
            "sliding_window": self.sliding_window is not None,
            "attention_sinks": self.attention_sinks != 0,
            "num_experts": self.num_experts > 0,
            "attention_bias": self.attention_bias,
        }
        bad = [k for k, v in unported.items() if v]
        if bad:
            raise NotImplementedError(
                f"QwenConfig options not ported to PyTorch yet: {bad}")
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError("num_attention_heads must be a multiple of "
                             "num_key_value_heads")


LFM2_8B_A1B_LAYER_TYPES = tuple(
    "full_attention" if i in (2, 6, 10, 14, 18, 21) else "conv"
    for i in range(24))


@dataclass(frozen=True)
class Lfm2MoeConfig:
    """LFM2-MoE causal-LM config under the published ``config.json`` keys
    (defaults: LFM2-8B-A1B's): gated short-convolution layers
    (``conv_L_cache`` taps) and GQA layers with per-head QK-norm, as
    ``layer_types`` orders them; a dense SwiGLU of ``intermediate_size`` in
    the first ``num_dense_layers`` layers, then ``num_experts`` SwiGLU
    experts of ``moe_intermediate_size``, ``num_experts_per_tok`` chosen
    by a sigmoid router (with ``expert_bias`` in the choice only when
    ``use_expert_bias``). The head is tied to the token table (upstream's
    default; ``config.json`` has no key for it).

    ``head_dim``, ``rms_norm_eps``, ``qk_norm`` and ``rope_scaling`` are
    the names the shared attention code (``layers.modern``) reads."""

    vocab_size: int = 65536
    hidden_size: int = 2048
    intermediate_size: int = 7168
    moe_intermediate_size: int = 1792
    num_hidden_layers: int = 24
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 128000
    norm_eps: float = 1e-5
    rope_theta: float = 1000000.0
    conv_L_cache: int = 3
    conv_bias: bool = False
    layer_types: Tuple[str, ...] = LFM2_8B_A1B_LAYER_TYPES
    num_dense_layers: int = 2
    num_experts: int = 32
    num_experts_per_tok: int = 4
    use_expert_bias: bool = True
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    pad_token_id: int = 0
    eos_token_id: Union[int, Tuple[int, ...]] = 7

    def __post_init__(self):
        object.__setattr__(self, "layer_types", tuple(self.layer_types))
        if len(self.layer_types) != self.num_hidden_layers or not set(
                self.layer_types) <= {"conv", "full_attention"}:
            raise ValueError("layer_types: one of 'conv' or "
                             "'full_attention' per layer")
        if self.conv_bias:
            raise NotImplementedError("conv_bias=True is not ported yet")
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError("num_attention_heads must be a multiple of "
                             "num_key_value_heads")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def rms_norm_eps(self) -> float:
        return self.norm_eps

    qk_norm = True
    rope_scaling = None
