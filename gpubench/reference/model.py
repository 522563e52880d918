"""Float32 forward of the ``QwenConfig`` family, written from the published
architecture (Qwen3 / Mistral modelling code): pre-norm RMSNorm, GQA
attention with RoPE (rotate-half convention) and, for Qwen3, RMSNorm over
each head of q and k before the rotation; SwiGLU MLP; no biases; the head
tied to the token table or not.

It runs one layer at a time over every sequence, making each layer's
weights again from the seed (``gpubench.weights``), so it holds one layer
in float32 at a time. With ``quant="int8"`` every matmul weight and the
token table go through :func:`quantize_int8` first, as a weight-only int8
deployment stores them. TF32 is switched off: every product is float32.
"""

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import weights as W
from ..work import dims


def quantize_int8(w: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 per output row of ``w [out, in]`` (a token table: per
    token), returned dequantized in float32: ``round(w / s)`` clipped to
    +-127, times ``s = max|row| / 127`` (1 for an all-zero row)."""
    w = w.to(torch.float32)
    amax = w.abs().amax(dim=1, keepdim=True)
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.clamp(torch.round(w / s), -127, 127) * s


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _rope(t: int, hd: int, theta: float, device):
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=device) / hd)
    ang = torch.arange(t, dtype=torch.float64, device=device)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos().float()[:, None], ang.sin().float()[:, None]


def _rotate(x, cos, sin):
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


def _layer(h, p, pre, cfg, cos, sin):
    d = dims(cfg)
    t = h.shape[0]
    nh, nkv, hd = d["nh"], d["nkv"], d["hd"]
    eps = cfg["rms_norm_eps"]
    x = _rms(h, p[pre + "input_layernorm.weight"], eps)
    q = (x @ p[pre + "self_attn.q_proj.weight"].T).view(t, nh, hd)
    k = (x @ p[pre + "self_attn.k_proj.weight"].T).view(t, nkv, hd)
    v = (x @ p[pre + "self_attn.v_proj.weight"].T).view(t, nkv, hd)
    if cfg.get("qk_norm"):
        q = _rms(q, p[pre + "self_attn.q_norm.weight"], eps)
        k = _rms(k, p[pre + "self_attn.k_norm.weight"], eps)
    q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
    g = nh // nkv
    q = q.view(t, nkv, g, hd).permute(1, 2, 0, 3)          # [kv, g, T, D]
    k, v = k.permute(1, 0, 2)[:, None], v.permute(1, 0, 2)[:, None]
    s = (q @ k.transpose(-1, -2)) / hd ** 0.5                # [kv, g, T, T]
    causal = torch.ones(t, t, dtype=torch.bool, device=h.device).tril()
    s = s.masked_fill(~causal, float("-inf")).softmax(-1)
    o = (s @ v).permute(2, 0, 1, 3).reshape(t, nh * hd)
    h = h + o @ p[pre + "self_attn.o_proj.weight"].T
    x = _rms(h, p[pre + "post_attention_layernorm.weight"], eps)
    gate = torch.nn.functional.silu(x @ p[pre + "mlp.gate_proj.weight"].T)
    up = x @ p[pre + "mlp.up_proj.weight"].T
    return h + (gate * up) @ p[pre + "mlp.down_proj.weight"].T


def _group(cfg, seed, group, device, dtype, std, quant):
    out = {}
    for name, t in W.make_group(cfg, seed, group, device, dtype,
                                std).items():
        out[name] = (quantize_int8(t) if quant == "int8" and t.dim() == 2
                     else t.to(torch.float32))
    return out


@torch.no_grad()
def served_gaps(cfg: dict, seed: int, seqs: Sequence[Tuple[np.ndarray, int]],
                device, *, weight_dtype=torch.bfloat16, std: float = 0.02,
                quant=None, head_rows: int = 256) -> List[np.ndarray]:
    """For each ``(tokens, n_prompt)``: the reference's logits at every
    position that chose a served token (``n_prompt - 1`` to the one before
    last), and for each the gap ``max logit - logit of the served token``
    (0 where the served token is the reference's best)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        args = (device, weight_dtype, std, quant)
        toks = [torch.as_tensor(np.asarray(t, dtype=np.int64), device=device)
                for t, _ in seqs]
        emb = _group(cfg, seed, "embed", *args)["embed_tokens.weight"]
        hs = [emb[t] for t in toks]
        if not cfg["tie_word_embeddings"]:
            del emb
        d = dims(cfg)
        for li in range(d["layers"]):
            p = _group(cfg, seed, f"layer.{li}", *args)
            pre = f"layers.{li}."
            for j, h in enumerate(hs):
                cos, sin = _rope(h.shape[0], d["hd"], cfg["rope_theta"],
                                 device)
                hs[j] = _layer(h, p, pre, cfg, cos, sin)
            del p
        norm = _group(cfg, seed, "final", *args)["norm.weight"]
        head = (emb if cfg["tie_word_embeddings"] else
                _group(cfg, seed, "head", *args)["lm_head.weight"])
        gaps = []
        for (tok, n_prompt), t, h in zip(seqs, toks, hs):
            x = _rms(h[n_prompt - 1:-1], norm, cfg["rms_norm_eps"])
            target = t[n_prompt:]
            out = []
            for a in range(0, x.shape[0], head_rows):
                logits = x[a:a + head_rows] @ head.T
                best = logits.max(-1).values
                got = logits.gather(1, target[a:a + head_rows, None])[:, 0]
                out.append((best - got).cpu())
            gaps.append(torch.cat(out).numpy().astype(np.float64))
        return gaps
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
