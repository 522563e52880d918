"""Plain forward of the ``lfm2_moe`` family, written from the published
architecture (``transformers``' LFM2 modelling code and its LFM2-MoE
sparse block), independent of the program:

- RMSNorm ``w * x / sqrt(mean(x²) + eps)`` (the weight multiplies
  directly, not ``1 + w``) before each operator and each FFN, and at the
  end (upstream ``embedding_norm``); pre-norm residuals;
- conv layers: ``[B | C | x̃] = split₃(x W_inᵀ)``, ``u = B * x̃``, a causal
  depthwise convolution of ``conv_L_cache`` taps over ``u`` with zeros
  before the first token, ``(C * y) W_outᵀ``, no biases;
- attention layers: q, k, v projections, RMSNorm over each head of q and
  of k, rotate-half RoPE on the whole head (upstream's angles: float32
  inverse frequencies times float32 positions), causal GQA, ``out_proj``;
- the first ``num_dense_layers`` layers: ``W2(silu(W1 x) * W3 x)``;
- the others: ``s = sigmoid(x W_gᵀ)``, the top ``num_experts_per_tok`` of
  ``s + expert_bias``, weights ``s / (Σ s + 1e-6) * routed_scaling_factor``
  (``norm_topk_prob``), each chosen expert a SwiGLU;
- the head tied to the token table.

The forward reads a parameter dict under the port's module paths and runs
at the dict's dtype: :func:`logits` over a whole dict (the port's tests,
in float64), :func:`served_gaps` in float32 one layer at a time over every
sampled sequence, making each layer's weights again from the seed
(``gpubench.weights``). Departures from upstream: every product and sum is
at the dict's dtype (upstream rounds each module's output to bf16). With
``quant="int8"`` every matrix (router and token table too; not the stacked
expert banks, nor the conv taps ``[H, 1, L]``) goes through
:func:`~.common.quantize_int8` first. TF32 is switched off.

Which served tokens are read. bf16 rounding moves the router's scores by
a few thousandths, so where a token's 4th and 5th best expert scores lie
closer than that in some layer, the program may run another expert there:
a different, equally valid computation whose logits differ by far more
than rounding. A gap read there measures that coin toss, not the
arithmetic, and random weights make such near-ties common: the least
margin over the 22 MoE layers has a median of ~0.0009. So
:func:`served_gaps` reads a served token only where the reference's
routing margin (4th minus 5th best of ``s + expert_bias``) at the
position that chose it is at least ``ROUTING_MARGIN`` in every MoE layer,
~4 % of the tokens. The tokens after a near-tie are still read (their
context holds whatever expert ran there); dropping them as well left a
twentieth as many tokens and no steadier reading.
"""

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import common as C

# The program's mean gap falls steeply as the margin read from rises to
# 0.004 (0.13 at 0, 0.03-0.04 at 0.004), the control's hardly (0.27, 0.19):
# below it, bf16's expert flips set the program's reading
ROUTING_MARGIN = 0.004


def rope(t: int, hd: int, theta: float, dtype, device):
    """``(cos, sin)`` of positions ``0..t-1``, each ``[t, 1, hd]``."""
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=device) / hd)
    ang = torch.arange(t, dtype=torch.float32, device=device)[:, None] * inv
    ang = torch.cat([ang, ang], -1)[:, None]
    return ang.cos().to(dtype), ang.sin().to(dtype)


def short_conv(x, p, pre, cfg):
    """The conv operator over one sequence ``x [T, H]``; ``pre`` names the
    ``conv.`` module."""
    t = x.shape[0]
    b, c, xt = (x @ p[pre + "in_proj.weight"].T).chunk(3, dim=-1)
    u = b * xt
    w = p[pre + "conv.weight"][:, 0, :]                      # [H, L]
    taps = w.shape[1]
    ext = torch.cat([u.new_zeros(taps - 1, u.shape[1]), u])
    y = sum(ext[j:j + t] * w[:, j] for j in range(taps))
    return (c * y) @ p[pre + "out_proj.weight"].T


def attention(x, p, pre, cfg):
    """Causal GQA over one sequence ``x [T, H]``; ``pre`` names the
    ``self_attn.`` module."""
    t = x.shape[0]
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // nh
    eps = cfg["norm_eps"]
    q = (x @ p[pre + "q_proj.weight"].T).view(t, nh, hd)
    k = (x @ p[pre + "k_proj.weight"].T).view(t, nkv, hd)
    v = (x @ p[pre + "v_proj.weight"].T).view(t, nkv, hd)
    q = C.rms(q, p[pre + "q_norm.weight"], eps)
    k = C.rms(k, p[pre + "k_norm.weight"], eps)
    cos, sin = rope(t, hd, cfg["rope_theta"], x.dtype, x.device)
    q, k = C.rotate(q, cos, sin), C.rotate(k, cos, sin)
    g = nh // nkv
    q = q.view(t, nkv, g, hd).permute(1, 2, 0, 3)            # [kv, g, T, D]
    k, v = k.permute(1, 0, 2)[:, None], v.permute(1, 0, 2)[:, None]
    s = (q @ k.transpose(-1, -2)) / hd ** 0.5
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf")).softmax(-1)
    o = (s @ v).permute(2, 0, 1, 3).reshape(t, nh * hd)
    return o @ p[pre + "o_proj.weight"].T


def swiglu(x, w1, w3, w2):
    return (F.silu(x @ w1.T) * (x @ w3.T)) @ w2.T


def experts(x, p, pre, cfg):
    """``(out, margin)``: the sparse block over every token ``x [N, H]``
    (``pre`` names the ``mlp.`` module), and each token's routing margin,
    its ``k``-th best score ``s + expert_bias`` less its ``k+1``-th (inf
    with no ``k+1``-th expert)."""
    e, k = p[pre + "w1"].shape[0], cfg["num_experts_per_tok"]
    s = torch.sigmoid(x @ p[pre + "gate.weight"].T)           # [N, E]
    score = s + p[pre + "expert_bias"] if cfg["use_expert_bias"] else s
    top = torch.topk(score, min(k + 1, e), dim=-1)
    sel = top.indices[:, :k]
    margin = (top.values[:, k - 1] - top.values[:, k] if e > k
              else torch.full_like(s[:, 0], float("inf")))
    w = s.gather(1, sel)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-6)
    w = w * cfg["routed_scaling_factor"]
    out = torch.zeros_like(x)
    for j in range(e):
        tok, slot = (sel == j).nonzero(as_tuple=True)
        if tok.numel():
            y = swiglu(x[tok], p[pre + "w1"][j], p[pre + "w3"][j],
                       p[pre + "w2"][j])
            out.index_add_(0, tok, y * w[tok, slot, None])
    return out, margin


def layer(hs: list, p: dict, i: int, cfg: dict):
    """``(hs, margin)``: layer ``i`` over the hidden states ``hs`` (one
    ``[T, H]`` a sequence), and each token's routing margin there (None in
    a dense layer). The FFN runs once over every token of every
    sequence."""
    pre, eps = f"layers.{i}.", cfg["norm_eps"]
    out = []
    for h in hs:
        x = C.rms(h, p[pre + "input_layernorm.weight"], eps)
        if cfg["layer_types"][i] == "full_attention":
            out.append(h + attention(x, p, pre + "self_attn.", cfg))
        else:
            out.append(h + short_conv(x, p, pre + "conv.", cfg))
    flat = torch.cat(out)
    x = C.rms(flat, p[pre + "post_attention_layernorm.weight"], eps)
    margin = None
    if i < cfg["num_dense_layers"]:
        ffn = swiglu(x, p[pre + "mlp.gate_proj.weight"],
                     p[pre + "mlp.up_proj.weight"],
                     p[pre + "mlp.down_proj.weight"])
    else:
        ffn, margin = experts(x, p, pre + "mlp.", cfg)
    return list((flat + ffn).split([h.shape[0] for h in hs])), margin


def logits(p: dict, cfg: dict, ids) -> torch.Tensor:
    """Logits ``[T, V]`` of the token list ``ids`` from position 0, from a
    whole parameter dict (a model's ``state_dict()``)."""
    hs = [p["embed_tokens.weight"][torch.as_tensor(ids)]]
    for i in range(cfg["num_hidden_layers"]):
        hs, _ = layer(hs, p, i, cfg)
    x = C.rms(hs[0], p["norm.weight"], cfg["norm_eps"])
    return x @ p["embed_tokens.weight"].T


def clear(margin: np.ndarray, n_prompt: int, served: int,
          at_least: float = None) -> np.ndarray:
    """Which of a sequence's ``served`` tokens to read: those whose
    choosing position (``n_prompt - 1`` on) has a routing margin (the
    least over MoE layers, ``margin [T]``) of at least ``at_least``
    (``ROUTING_MARGIN``)."""
    at_least = ROUTING_MARGIN if at_least is None else at_least
    return margin[n_prompt - 1:n_prompt - 1 + served] >= at_least


@torch.no_grad()
def margins_and_gaps(cfg: dict, seed: int,
                     seqs: Sequence[Tuple[np.ndarray, int]], device, *,
                     weight_dtype=torch.bfloat16, std: float = 0.02,
                     quant=None, head_rows: int = 256):
    """``(gaps, margins)``: for each ``(tokens, n_prompt)`` the gap of
    every served token below the reference's best logit at its position
    (:func:`~.common.head_gaps`), and each position's least routing margin
    over the MoE layers."""
    with C.float32_products():
        args = (device, weight_dtype, std, quant)
        toks = C.tokens(seqs, device)
        emb = C.group(cfg, seed, "embed", *args)["embed_tokens.weight"]
        hs = [emb[t] for t in toks]
        least = torch.full((sum(len(t) for t in toks),), float("inf"),
                           device=device)
        for i in range(cfg["num_hidden_layers"]):
            p = C.group(cfg, seed, f"layer.{i}", *args)
            hs, margin = layer(hs, p, i, cfg)
            if margin is not None:
                least = torch.minimum(least, margin)
            del p
        norm = C.group(cfg, seed, "final", *args)["norm.weight"]
        gaps = C.head_gaps(seqs, toks, hs, norm, emb, cfg["norm_eps"],
                           head_rows)
        margins = [m.cpu().numpy() for m in least.split(
            [len(t) for t in toks])]
        return gaps, margins


def served_gaps(cfg: dict, seed: int, seqs: Sequence[Tuple[np.ndarray, int]],
                device, *, weight_dtype=torch.bfloat16, std: float = 0.02,
                quant=None, head_rows: int = 256) -> List[np.ndarray]:
    """For each ``(tokens, n_prompt)``: the gaps of the served tokens whose
    routing is clear (:func:`clear`), in order."""
    gaps, margins = margins_and_gaps(cfg, seed, seqs, device,
                                     weight_dtype=weight_dtype, std=std,
                                     quant=quant, head_rows=head_rows)
    return [g[clear(m, n, g.size)] for g, m, (_, n) in zip(gaps, margins,
                                                            seqs)]
