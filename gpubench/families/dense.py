"""The ``dense`` family, the default: the port's ``ModelForCausalLM`` over
``QwenConfig``, attention and a SwiGLU MLP in every layer, no experts
(Qwen3, Mistral). Names and shapes are those of the published checkpoints
(``[out, in]`` linears), which are also the port's module paths."""

from typing import List, Tuple

from ..reference.dense import served_gaps  # noqa: F401
from ..work import dims


def port_model(cfg: dict, device, dtype):
    from vyomai_tpu_torch import ModelForCausalLM, QwenConfig
    fields = QwenConfig.__dataclass_fields__
    conf = QwenConfig(**{k: v for k, v in cfg.items() if k in fields})
    return ModelForCausalLM(conf, device=device, dtype=dtype)


def groups(cfg: dict) -> List[str]:
    """The token table, each decoder layer, the final norm and (untied) the
    head."""
    names = ["embed"] + [f"layer.{i}" for i in range(
        cfg["num_hidden_layers"])] + ["final"]
    return names + ([] if cfg["tie_word_embeddings"] else ["head"])


def shapes(cfg: dict, group: str) -> List[Tuple[str, tuple, bool]]:
    """``(name, shape, is_norm)`` of a group's tensors."""
    d = dims(cfg)
    h, i, nh, nkv, hd = d["h"], d["i"], d["nh"], d["nkv"], d["hd"]
    if group == "embed":
        return [("embed_tokens.weight", (d["v"], h), False)]
    if group == "final":
        return [("norm.weight", (h,), True)]
    if group == "head":
        return [("lm_head.weight", (d["v"], h), False)]
    p = f"layers.{group.split('.')[1]}."
    out = [(p + "input_layernorm.weight", (h,), True),
           (p + "post_attention_layernorm.weight", (h,), True)]
    if cfg.get("qk_norm"):
        out += [(p + "self_attn.q_norm.weight", (hd,), True),
                (p + "self_attn.k_norm.weight", (hd,), True)]
    return out + [
        (p + "self_attn.q_proj.weight", (nh * hd, h), False),
        (p + "self_attn.k_proj.weight", (nkv * hd, h), False),
        (p + "self_attn.v_proj.weight", (nkv * hd, h), False),
        (p + "self_attn.o_proj.weight", (h, nh * hd), False),
        (p + "mlp.gate_proj.weight", (i, h), False),
        (p + "mlp.up_proj.weight", (i, h), False),
        (p + "mlp.down_proj.weight", (h, i), False)]


def linears(cfg: dict) -> List[Tuple[int, int]]:
    """Each layer's q, k, v, o, gate, up and down projections, then the
    head (tied or not)."""
    d = dims(cfg)
    h, i, nh, nkv, hd = d["h"], d["i"], d["nh"], d["nkv"], d["hd"]
    per_layer = [(nh * hd, h), (nkv * hd, h), (nkv * hd, h), (h, nh * hd),
                 (i, h), (i, h), (h, i)]
    return per_layer * cfg["num_hidden_layers"] + [(d["v"], h)]


def attn_layers(cfg: dict) -> int:
    return cfg["num_hidden_layers"]
