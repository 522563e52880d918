"""The ``lfm2_moe`` family: the port's ``Lfm2MoeForCausalLM`` over
``Lfm2MoeConfig`` (LFM2-8B-A1B): gated short-convolution and GQA layers as
``layer_types`` orders them, a dense SwiGLU in the first
``num_dense_layers`` layers and a sigmoid-routed mixture of experts after,
the head tied to the token table. Names and shapes are the port's module
paths (``vyomai_tpu_torch/models/lfm2.py`` maps them to upstream's); the
experts are stacked banks, ``[E, I, H]`` for gate and up and ``[E, H, I]``
for down."""

from typing import List, Tuple

from ..reference.lfm2_moe import served_gaps  # noqa: F401
from ..work import dims


def port_model(cfg: dict, device, dtype):
    from vyomai_tpu_torch import Lfm2MoeConfig, Lfm2MoeForCausalLM
    fields = Lfm2MoeConfig.__dataclass_fields__
    conf = Lfm2MoeConfig(**{k: v for k, v in cfg.items() if k in fields})
    return Lfm2MoeForCausalLM(conf, device=device, dtype=dtype)


def groups(cfg: dict) -> List[str]:
    """The token table, each layer, the final norm (the head is tied)."""
    return (["embed"] + [f"layer.{i}" for i in range(
        cfg["num_hidden_layers"])] + ["final"])


def _attention(cfg: dict, i: int) -> bool:
    return cfg["layer_types"][i] == "full_attention"


def _moe(cfg: dict, i: int) -> bool:
    return i >= cfg["num_dense_layers"]


def shapes(cfg: dict, group: str) -> List[Tuple[str, tuple, bool]]:
    """``(name, shape, is_norm)`` of a group's tensors."""
    d = dims(cfg)
    h, nh, nkv, hd = d["h"], d["nh"], d["nkv"], d["hd"]
    if group == "embed":
        return [("embed_tokens.weight", (d["v"], h), False)]
    if group == "final":
        return [("norm.weight", (h,), True)]
    i = int(group.split(".")[1])
    p = f"layers.{i}."
    out = [(p + "input_layernorm.weight", (h,), True),
           (p + "post_attention_layernorm.weight", (h,), True)]
    if _attention(cfg, i):
        out += [(p + "self_attn.q_norm.weight", (hd,), True),
                (p + "self_attn.k_norm.weight", (hd,), True),
                (p + "self_attn.q_proj.weight", (nh * hd, h), False),
                (p + "self_attn.k_proj.weight", (nkv * hd, h), False),
                (p + "self_attn.v_proj.weight", (nkv * hd, h), False),
                (p + "self_attn.o_proj.weight", (h, nh * hd), False)]
    else:
        out += [(p + "conv.in_proj.weight", (3 * h, h), False),
                (p + "conv.conv.weight", (h, 1, cfg["conv_L_cache"]), False),
                (p + "conv.out_proj.weight", (h, h), False)]
    if not _moe(cfg, i):
        return out + [(p + "mlp.gate_proj.weight", (d["i"], h), False),
                      (p + "mlp.up_proj.weight", (d["i"], h), False),
                      (p + "mlp.down_proj.weight", (h, d["i"]), False)]
    e, mi = cfg["num_experts"], cfg["moe_intermediate_size"]
    return out + [(p + "mlp.gate.weight", (e, h), False),
                  (p + "mlp.expert_bias", (e,), False),
                  (p + "mlp.w1", (e, mi, h), False),
                  (p + "mlp.w3", (e, mi, h), False),
                  (p + "mlp.w2", (e, h, mi), False)]


def linears(cfg: dict) -> List[Tuple[int, int]]:
    """What one token passes through: each conv layer's in and out
    projections or each attention layer's q, k, v, o; each dense layer's
    gate, up and down, each MoE layer's router and its chosen experts'
    gate, up and down; then the tied head."""
    d = dims(cfg)
    h, nh, nkv, hd = d["h"], d["nh"], d["nkv"], d["hd"]
    mi, k = cfg["moe_intermediate_size"], cfg["num_experts_per_tok"]
    out = []
    for i in range(cfg["num_hidden_layers"]):
        if _attention(cfg, i):
            out += [(nh * hd, h), (nkv * hd, h), (nkv * hd, h), (h, nh * hd)]
        else:
            out += [(3 * h, h), (h, h)]
        if _moe(cfg, i):
            out += [(cfg["num_experts"], h)] + [(mi, h), (mi, h), (h, mi)] * k
        else:
            out += [(d["i"], h), (d["i"], h), (h, d["i"])]
    return out + [(d["v"], h)]


def attn_layers(cfg: dict) -> int:
    return sum(_attention(cfg, i) for i in range(cfg["num_hidden_layers"]))
