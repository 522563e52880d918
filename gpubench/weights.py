"""Seeded random weights of the ``QwenConfig`` family, made on the device.

The weights come in groups: the token table, each decoder layer, the final
norm and (untied) the head. Each group is one buffer filled by one
``normal_`` call of a ``torch.Generator`` on the device, seeded from the
run seed and the group's index, so any group can be made again alone: the
program gets every group at set-up, the plain reference makes them again
one layer at a time. Matrices are views of the buffer (normal, std
``init_std``); norm weights are ``1 + 5 x`` of their slice of it, so a
fault that drops a norm's weight shows.

Names and shapes are those of the published checkpoints (``[out, in]``
linears), which are also the port's module paths.
"""

from typing import Dict, List, Tuple

import numpy as np
import torch

from .work import dims

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def groups(cfg: dict) -> List[str]:
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


def group_seed(seed: int, index: int) -> int:
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, index])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


@torch.no_grad()
def make_group(cfg: dict, seed: int, group: str, device,
               dtype=torch.bfloat16, std: float = 0.02
               ) -> Dict[str, torch.Tensor]:
    """One group's tensors: one buffer, one ``normal_`` call."""
    index = groups(cfg).index(group)
    spec = shapes(cfg, group)
    total = sum(int(np.prod(s)) for _, s, _ in spec)
    gen = torch.Generator(device=device)
    gen.manual_seed(group_seed(seed, index))
    buf = torch.empty(total, dtype=dtype, device=device)
    buf.normal_(0.0, std, generator=gen)
    out, off = {}, 0
    for name, shape, is_norm in spec:
        n = int(np.prod(shape))
        t = buf[off:off + n].view(shape)
        out[name] = 1.0 + 5.0 * t if is_norm else t
        off += n
    return out
