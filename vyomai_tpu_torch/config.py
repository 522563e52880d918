"""Configuration dataclasses for the PyTorch port.

``EncoderConfig``, ``VisionConfig`` and ``QwenConfig`` carry the same
fields and defaults as
their counterparts in ``vyomai_tpu.config`` (``QwenConfig``: Qwen3-0.6B's
published ``config.json``), so one config value describes the model in
both packages. Qwen features the port does not run yet raise
``NotImplementedError`` at construction. ``Lfm2MoeConfig`` and
``DeepseekV3Config`` are the port's own (the JAX package has no such
models): LFM2-8B-A1B's and Moonlight-16B-A3B's published ``config.json``
under their own key names.
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


@dataclass(frozen=True)
class DeepseekV3Config:
    """DeepSeek-V3-block causal-LM config under the published
    ``config.json`` keys (``model_type`` ``deepseek_v3``; defaults:
    Moonlight-16B-A3B's). Multi-head latent attention (MLA): ``q_proj``
    gives each of the ``num_attention_heads`` heads ``qk_nope_head_dim +
    qk_rope_head_dim`` query dims; ``kv_a_proj_with_mqa`` gives one latent
    row of ``kv_lora_rank`` (through ``kv_a_layernorm``) and one rotary key
    of ``qk_rope_head_dim`` that every head shares; ``kv_b_proj`` maps the
    latent to each head's ``qk_nope_head_dim`` key and ``v_head_dim``
    value. The first ``first_k_dense_replace`` layers have a dense SwiGLU
    of ``intermediate_size``; the others ``n_routed_experts`` experts of
    ``moe_intermediate_size``, ``num_experts_per_tok`` chosen by the
    sigmoid router (``noaux_tc``: the top-k of the sigmoid scores plus a
    correction bias, weighted by the scores over their sum times
    ``routed_scaling_factor``), beside one shared SwiGLU of
    ``n_shared_experts x moe_intermediate_size`` that every token takes.
    The head is untied.

    Not ported, and refused here: ``q_lora_rank`` (a low-rank query),
    ``rope_scaling`` (YaRN), ``n_group`` or ``topk_group`` above 1 (group
    routing), another ``scoring_func`` or ``topk_method``,
    ``attention_bias``, ``moe_layer_freq`` other than 1, another
    ``hidden_act``. ``num_key_value_heads``, ``ep_size``, ``seq_aux`` and
    ``num_nextn_predict_layers`` are kept as published and read by
    nothing (MLA has no K/V heads; the rest concern training and
    speculation)."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    n_shared_experts: int = 2
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 2.446
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    topk_method: str = "noaux_tc"
    scoring_func: str = "sigmoid"
    n_group: int = 1
    topk_group: int = 1
    norm_topk_prob: bool = True
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-5
    rope_theta: float = 50000.0
    rope_scaling: Optional[dict] = None
    attention_bias: bool = False
    hidden_act: str = "silu"
    tie_word_embeddings: bool = False
    ep_size: int = 1
    seq_aux: bool = True
    num_nextn_predict_layers: int = 0
    bos_token_id: int = 163584
    eos_token_id: Union[int, Tuple[int, ...]] = 163585

    # the published code builds kv_a_layernorm with its RMSNorm's default
    # epsilon, not rms_norm_eps
    kv_a_layernorm_eps = 1e-6

    def __post_init__(self):
        unported = {
            "q_lora_rank": self.q_lora_rank is not None,
            "rope_scaling": self.rope_scaling is not None,
            "n_group": self.n_group != 1 or self.topk_group != 1,
            "scoring_func": self.scoring_func != "sigmoid",
            "topk_method": self.topk_method != "noaux_tc",
            "attention_bias": self.attention_bias,
            "moe_layer_freq": self.moe_layer_freq != 1,
            "hidden_act": self.hidden_act != "silu",
        }
        bad = [k for k, v in unported.items() if v]
        if bad:
            raise NotImplementedError(
                f"DeepseekV3Config options not ported to PyTorch yet: {bad}")

    @property
    def qk_head_dim(self) -> int:
        """A head's query and key dims, the ones the softmax scale reads."""
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """The width of one cached token a layer: the latent and the rotary
        key."""
        return self.kv_lora_rank + self.qk_rope_head_dim
