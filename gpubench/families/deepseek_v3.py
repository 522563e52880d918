"""The ``deepseek_v3`` family: the port's ``DeepseekV3ForCausalLM`` over
``DeepseekV3Config`` (Moonlight-16B-A3B): multi-head latent attention in
every layer, a dense SwiGLU in the first ``first_k_dense_replace`` layers
and, after them, sigmoid-routed experts beside one shared SwiGLU; the head
untied. Names and shapes are the port's module paths
(``vyomai_tpu_torch/models/deepseek_v3.py`` maps them to upstream's); the
experts are stacked banks, ``[E, I, H]`` for gate and up and ``[E, H, I]``
for down."""

from typing import List, Tuple

from ..reference.deepseek_v3 import served_gaps  # noqa: F401


def port_model(cfg: dict, device, dtype):
    from vyomai_tpu_torch import DeepseekV3Config, DeepseekV3ForCausalLM
    fields = DeepseekV3Config.__dataclass_fields__
    conf = DeepseekV3Config(**{k: v for k, v in cfg.items() if k in fields})
    return DeepseekV3ForCausalLM(conf, device=device, dtype=dtype)


def groups(cfg: dict) -> List[str]:
    """The token table, each layer, the final norm and the head."""
    return (["embed"] + [f"layer.{i}" for i in range(
        cfg["num_hidden_layers"])] + ["final", "head"])


def _moe(cfg: dict, i: int) -> bool:
    return i >= cfg["first_k_dense_replace"]


def _mla(cfg: dict):
    """``(heads, nope, rope, v, latent)``."""
    return (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
            cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"])


def _shared(cfg: dict) -> int:
    return cfg["n_shared_experts"] * cfg["moe_intermediate_size"]


def shapes(cfg: dict, group: str) -> List[Tuple[str, tuple, bool]]:
    """``(name, shape, is_norm)`` of a group's tensors."""
    h, v = cfg["hidden_size"], cfg["vocab_size"]
    if group == "embed":
        return [("embed_tokens.weight", (v, h), False)]
    if group == "final":
        return [("norm.weight", (h,), True)]
    if group == "head":
        return [("lm_head.weight", (v, h), False)]
    nh, nope, rope, vd, c = _mla(cfg)
    i = int(group.split(".")[1])
    p = f"layers.{i}."
    a = p + "self_attn."
    out = [(p + "input_layernorm.weight", (h,), True),
           (p + "post_attention_layernorm.weight", (h,), True),
           (a + "q_proj.weight", (nh * (nope + rope), h), False),
           (a + "kv_a_proj_with_mqa.weight", (c + rope, h), False),
           (a + "kv_a_layernorm.weight", (c,), True),
           (a + "kv_b_proj.weight", (nh * (nope + vd), c), False),
           (a + "o_proj.weight", (h, nh * vd), False)]
    if not _moe(cfg, i):
        inter = cfg["intermediate_size"]
        return out + [(p + "mlp.gate_proj.weight", (inter, h), False),
                      (p + "mlp.up_proj.weight", (inter, h), False),
                      (p + "mlp.down_proj.weight", (h, inter), False)]
    e, mi, s = cfg["n_routed_experts"], cfg["moe_intermediate_size"], \
        _shared(cfg)
    sh = p + "mlp.shared_experts."
    return out + [(p + "mlp.gate.weight", (e, h), False),
                  (p + "mlp.expert_bias", (e,), False),
                  (p + "mlp.w1", (e, mi, h), False),
                  (p + "mlp.w3", (e, mi, h), False),
                  (p + "mlp.w2", (e, h, mi), False),
                  (sh + "gate_proj.weight", (s, h), False),
                  (sh + "up_proj.weight", (s, h), False),
                  (sh + "down_proj.weight", (h, s), False)]


def linears(cfg: dict) -> List[Tuple[int, int]]:
    """What one token passes through: each layer's MLA projections (q,
    kv_a, kv_b, o: the absorbed form multiplies as many weights of kv_b a
    token), the dense layers' gate, up and down, each MoE layer's router,
    its chosen experts' and the shared expert's gate, up and down; then
    the head."""
    h = cfg["hidden_size"]
    nh, nope, rope, vd, c = _mla(cfg)
    mi, k, s = (cfg["moe_intermediate_size"], cfg["num_experts_per_tok"],
                _shared(cfg))
    out = []
    for i in range(cfg["num_hidden_layers"]):
        out += [(nh * (nope + rope), h), (c + rope, h),
                (nh * (nope + vd), c), (h, nh * vd)]
        if _moe(cfg, i):
            out += ([(cfg["n_routed_experts"], h)]
                    + [(mi, h), (mi, h), (h, mi)] * k
                    + [(s, h), (s, h), (h, s)])
        else:
            inter = cfg["intermediate_size"]
            out += [(inter, h), (inter, h), (h, inter)]
    return out + [(cfg["vocab_size"], h)]


def attn_layers(cfg: dict) -> int:
    return cfg["num_hidden_layers"]
