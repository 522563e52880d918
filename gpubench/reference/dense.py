"""Float32 forward of the ``dense`` family, written from the published
architecture (Qwen3 / Mistral modelling code): pre-norm RMSNorm, GQA
attention with RoPE (rotate-half convention) and, for Qwen3, RMSNorm over
each head of q and k before the rotation; SwiGLU MLP; no biases; the head
tied to the token table or not.

It runs one layer at a time over every sequence, making each layer's
weights again from the seed (``gpubench.weights``), so it holds one layer
in float32 at a time. With ``quant="int8"`` every matmul weight and the
token table go through :func:`~.common.quantize_int8` first, as a
weight-only int8 deployment stores them. TF32 is switched off: every
product is float32.
"""

from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import common as C
from ..work import dims


def _layer(h, p, pre, cfg, cos, sin):
    d = dims(cfg)
    t = h.shape[0]
    nh, nkv, hd = d["nh"], d["nkv"], d["hd"]
    eps = cfg["rms_norm_eps"]
    x = C.rms(h, p[pre + "input_layernorm.weight"], eps)
    q = (x @ p[pre + "self_attn.q_proj.weight"].T).view(t, nh, hd)
    k = (x @ p[pre + "self_attn.k_proj.weight"].T).view(t, nkv, hd)
    v = (x @ p[pre + "self_attn.v_proj.weight"].T).view(t, nkv, hd)
    if cfg.get("qk_norm"):
        q = C.rms(q, p[pre + "self_attn.q_norm.weight"], eps)
        k = C.rms(k, p[pre + "self_attn.k_norm.weight"], eps)
    q, k = C.rotate(q, cos, sin), C.rotate(k, cos, sin)
    g = nh // nkv
    q = q.view(t, nkv, g, hd).permute(1, 2, 0, 3)          # [kv, g, T, D]
    k, v = k.permute(1, 0, 2)[:, None], v.permute(1, 0, 2)[:, None]
    s = (q @ k.transpose(-1, -2)) / hd ** 0.5                # [kv, g, T, T]
    causal = torch.ones(t, t, dtype=torch.bool, device=h.device).tril()
    s = s.masked_fill(~causal, float("-inf")).softmax(-1)
    o = (s @ v).permute(2, 0, 1, 3).reshape(t, nh * hd)
    h = h + o @ p[pre + "self_attn.o_proj.weight"].T
    x = C.rms(h, p[pre + "post_attention_layernorm.weight"], eps)
    gate = torch.nn.functional.silu(x @ p[pre + "mlp.gate_proj.weight"].T)
    up = x @ p[pre + "mlp.up_proj.weight"].T
    return h + (gate * up) @ p[pre + "mlp.down_proj.weight"].T


@torch.no_grad()
def served_gaps(cfg: dict, seed: int, seqs: Sequence[Tuple[np.ndarray, int]],
                device, *, weight_dtype=torch.bfloat16, std: float = 0.02,
                quant=None, head_rows: int = 256) -> List[np.ndarray]:
    """For each ``(tokens, n_prompt)``: the gap of every served token
    below the reference's best logit at its position
    (:func:`~.common.head_gaps`)."""
    with C.float32_products():
        args = (device, weight_dtype, std, quant)
        toks = C.tokens(seqs, device)
        emb = C.group(cfg, seed, "embed", *args)["embed_tokens.weight"]
        hs = [emb[t] for t in toks]
        if not cfg["tie_word_embeddings"]:
            del emb
        d = dims(cfg)
        for li in range(d["layers"]):
            p = C.group(cfg, seed, f"layer.{li}", *args)
            pre = f"layers.{li}."
            for j, h in enumerate(hs):
                cos, sin = C.rope(h.shape[0], d["hd"], cfg["rope_theta"],
                                  device)
                hs[j] = _layer(h, p, pre, cfg, cos, sin)
            del p
        norm = C.group(cfg, seed, "final", *args)["norm.weight"]
        head = (emb if cfg["tie_word_embeddings"] else
                C.group(cfg, seed, "head", *args)["lm_head.weight"])
        return C.head_gaps(seqs, toks, hs, norm, head, cfg["rms_norm_eps"],
                           head_rows)
