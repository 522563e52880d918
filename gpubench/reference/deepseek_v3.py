"""Plain forward of the ``deepseek_v3`` family, written from the published
architecture (DeepSeek-V3's modelling code, as Moonlight-16B-A3B ships
it: ``model_type`` ``deepseek_v3``, no ``q_lora_rank``), independent of the
program:

- RMSNorm ``w * x / sqrt(mean(x²) + eps)`` before the attention and the
  FFN, and at the end; pre-norm residuals;
- multi-head latent attention, decompressed as upstream runs it:
  ``q = x W_qᵀ`` split per head into ``q_nope`` and ``q_pe``; ``[c | k_pe]
  = x W_kv_aᵀ``, ``c`` through ``kv_a_layernorm`` (epsilon 1e-6, the
  published RMSNorm's default, not ``rms_norm_eps``), ``[k_nope | v] = c
  W_kv_bᵀ`` per head; RoPE on ``q_pe`` and the one shared ``k_pe`` with
  the interleaved pairs put in rotate-half order first (upstream's
  ``view(..., d/2, 2).transpose``), float32 angles; causal softmax of
  ``[q_nope, q_pe]·[k_nope, k_pe] / sqrt(qk_nope + qk_rope)`` over the
  values; ``o_proj``;
- the first ``first_k_dense_replace`` layers: ``W2(silu(W1 x) * W3 x)``;
- the others: ``noaux_tc`` routing, ``s = sigmoid(x W_gᵀ)``, choice scores
  ``s + e_score_correction_bias`` (here ``expert_bias``), the best
  ``topk_group`` of ``n_group`` groups by the sum of each group's two best
  choice scores, the top ``num_experts_per_tok`` choice scores within them,
  weights ``s / (Σ s + 1e-20) * routed_scaling_factor``
  (``norm_topk_prob``); each chosen expert a SwiGLU; plus the shared
  expert, one SwiGLU of ``n_shared_experts x moe_intermediate_size``, on
  every token;
- the untied head.

The forward reads a parameter dict under the port's module paths
(``models/deepseek_v3.py`` maps them to upstream's) and runs at the dict's
dtype: :func:`logits` over a whole dict (the port's tests, in float64),
:func:`served_gaps` in float32 one layer at a time over every sampled
sequence, making each layer's weights again from the seed
(``gpubench.weights``). Departures from upstream: every product and sum is
at the dict's dtype (upstream rounds each module's output to bf16); and
where sampled sequences share a prefix (a document asked several times),
:func:`served_gaps` computes its rows once for all of them, which changes
nothing, since a row depends only on the tokens up to it. With
``quant="int8"`` every matrix (router and token table too; not the
stacked expert banks) goes through :func:`~.common.quantize_int8` first.
TF32 is switched off.

Which served tokens are read: as for ``lfm2_moe``, bf16 rounding moves the
router's scores by a few thousandths, and a token whose 6th and 7th best
choice scores lie closer than that in some layer may run another expert
there in the program, a different computation whose logits differ by far
more than rounding. :func:`served_gaps` reads a served token only where
the reference's routing margin at the position that chose it is at least
``ROUTING_MARGIN`` in every MoE layer.
"""

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import common as C

# The program's mean gap falls as the margin read from rises (0.37-0.39
# over every token, 0.16-0.17 at 0.002), the control's much less (0.79-0.80,
# 0.60-0.67): below it, bf16's expert flips set the program's reading; at
# 0.003 fewer than 200 tokens a run are left (cells/moonlight-16b-a3b.docqa)
ROUTING_MARGIN = 0.002
KV_A_EPS = 1e-6          # kv_a_layernorm's epsilon in the published code
ROWS = 16384             # rows of an FFN pass
QUERIES = 1024           # queries of an attention pass


def rope(start: int, t: int, r: int, theta: float, device):
    """``(cos, sin)`` of positions ``start..start+t-1``, each ``[t, 1,
    r]``: float32 inverse frequencies times float32 positions."""
    inv = 1.0 / theta ** (torch.arange(0, r, 2, dtype=torch.float32,
                                       device=device) / r)
    pos = torch.arange(start, start + t, dtype=torch.float32, device=device)
    ang = torch.outer(pos, inv)
    ang = torch.cat([ang, ang], -1)[:, None]
    return ang.cos(), ang.sin()


def rotate_interleaved(x, cos, sin):
    """Upstream's rotation of the rotary dims ``x [..., r]``."""
    *lead, r = x.shape
    x = x.reshape(*lead, r // 2, 2).transpose(-1, -2).reshape(*lead, r)
    return C.rotate(x, cos.to(x.dtype), sin.to(x.dtype))


def attention(x, p, pre, cfg, start: int, past=None):
    """``(out, (k, v))``: MLA over one sequence's tokens ``x [T, H]`` at
    positions ``start..``, attending ``past`` (the ``(k, v)`` of positions
    ``0..start-1``) and themselves, causal; ``pre`` names the
    ``self_attn.`` module. ``k [start + T, heads, n + r]``, ``v [start + T,
    heads, v]``."""
    t = x.shape[0]
    nh = cfg["num_attention_heads"]
    n, r = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    c = cfg["kv_lora_rank"]
    q = (x @ p[pre + "q_proj.weight"].T).view(t, nh, n + r)
    ckv = x @ p[pre + "kv_a_proj_with_mqa.weight"].T
    lat = C.rms(ckv[:, :c], p[pre + "kv_a_layernorm.weight"], KV_A_EPS)
    kv = (lat @ p[pre + "kv_b_proj.weight"].T).view(t, nh, -1)
    cos, sin = rope(start, t, r, cfg["rope_theta"], x.device)
    q_pe = rotate_interleaved(q[..., n:], cos, sin)
    k_pe = rotate_interleaved(ckv[:, None, c:], cos, sin)
    q = torch.cat([q[..., :n], q_pe], -1)
    k = torch.cat([kv[..., :n], k_pe.expand(t, nh, r)], -1)
    v = kv[..., n:]
    if past is not None:
        k, v = torch.cat([past[0], k]), torch.cat([past[1], v])
    keys = torch.arange(k.shape[0], device=x.device)
    scale = (n + r) ** -0.5
    out = []
    for a in range(0, t, QUERIES):
        qq = q[a:a + QUERIES].transpose(0, 1)                 # [nh, Q, d]
        s = qq @ k.permute(1, 2, 0) * scale                   # [nh, Q, K]
        seen = keys[None] <= start + torch.arange(
            a, a + qq.shape[1], device=x.device)[:, None]
        s = s.masked_fill(~seen, float("-inf")).softmax(-1)
        out.append((s @ v.transpose(0, 1)).transpose(0, 1).reshape(
            qq.shape[1], -1))
    return torch.cat(out) @ p[pre + "o_proj.weight"].T, (k, v)


def swiglu(x, w1, w3, w2):
    return (F.silu(x @ w1.T) * (x @ w3.T)) @ w2.T


def route(x, p, pre, cfg):
    """``(sel [N, k], w [N, k], margin [N])``: ``noaux_tc`` over the tokens
    ``x [N, H]``, and each token's margin, its ``k``-th best choice score
    less its ``k+1``-th among the groups chosen."""
    e, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    groups, keep = cfg["n_group"], cfg["topk_group"]
    s = torch.sigmoid(x @ p[pre + "gate.weight"].T)            # [N, E]
    choice = s + p[pre + "expert_bias"]
    by_group = choice.view(-1, groups, e // groups)
    best = by_group.topk(min(2, e // groups), dim=-1).values.sum(-1)
    chosen = best.topk(keep, dim=-1).indices
    mask = torch.zeros_like(best).scatter_(1, chosen, 1.0).bool()
    choice = by_group.masked_fill(~mask[..., None], float("-inf")).view(
        -1, e)
    top = choice.topk(min(k + 1, e), dim=-1)
    sel = top.indices[:, :k]
    margin = (top.values[:, k - 1] - top.values[:, k] if e > k
              else torch.full_like(s[:, 0], float("inf")))
    w = s.gather(1, sel)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return sel, w * cfg["routed_scaling_factor"], margin


def experts(x, p, pre, cfg):
    """``(out, margin)``: the sparse block with its shared expert over
    every token ``x [N, H]``; ``pre`` names the ``mlp.`` module."""
    sel, w, margin = route(x, p, pre, cfg)
    out = torch.zeros_like(x)
    for j in range(cfg["n_routed_experts"]):
        tok, slot = (sel == j).nonzero(as_tuple=True)
        if tok.numel():
            y = swiglu(x[tok], p[pre + "w1"][j], p[pre + "w3"][j],
                       p[pre + "w2"][j])
            out.index_add_(0, tok, y * w[tok, slot, None])
    sh = pre + "shared_experts."
    return out + swiglu(x, p[sh + "gate_proj.weight"],
                        p[sh + "up_proj.weight"],
                        p[sh + "down_proj.weight"]), margin


def ffn(x, p, i, cfg):
    """``(out, margin)`` of layer ``i``'s FFN over ``x [N, H]`` (margin
    None in a dense layer), ``ROWS`` rows at a time."""
    pre = f"layers.{i}.mlp."
    outs, margins = [], []
    for a in range(0, x.shape[0], ROWS):
        xa = x[a:a + ROWS]
        if i < cfg["first_k_dense_replace"]:
            outs.append(swiglu(xa, p[pre + "gate_proj.weight"],
                               p[pre + "up_proj.weight"],
                               p[pre + "down_proj.weight"]))
        else:
            y, m = experts(xa, p, pre, cfg)
            outs.append(y)
            margins.append(m)
    return torch.cat(outs), (torch.cat(margins) if margins else None)


def layer(units: list, p: dict, i: int, cfg: dict):
    """``margin``: layer ``i`` over ``units`` in place, each ``{"h": [T,
    H], "start": position of its first token, "parent": index of the unit
    that holds positions 0..start-1, or None}``, parents before their
    children; each row's routing margin, over the units' rows in order
    (None in a dense layer). The FFN runs once over every row."""
    pre, eps = f"layers.{i}.", cfg["rms_norm_eps"]
    parents = {unit["parent"] for unit in units}
    kv, out = {}, []
    for u, unit in enumerate(units):
        x = C.rms(unit["h"], p[pre + "input_layernorm.weight"], eps)
        past = None if unit["parent"] is None else kv[unit["parent"]]
        a, keys = attention(x, p, pre + "self_attn.", cfg, unit["start"],
                            past)
        if u in parents:
            kv[u] = keys
        out.append(unit["h"] + a)
    del kv
    flat = torch.cat(out)
    y, margin = ffn(C.rms(flat, p[pre + "post_attention_layernorm.weight"],
                          eps), p, i, cfg)
    for unit, h in zip(units, (flat + y).split([h.shape[0] for h in out])):
        unit["h"] = h
    return margin


def logits(p: dict, cfg: dict, ids) -> torch.Tensor:
    """Logits ``[T, V]`` of the token list ``ids`` from position 0, from a
    whole parameter dict (a model's ``state_dict()``)."""
    units = [{"h": p["embed_tokens.weight"][torch.as_tensor(ids)],
              "start": 0, "parent": None}]
    for i in range(cfg["num_hidden_layers"]):
        layer(units, p, i, cfg)
    x = C.rms(units[0]["h"], p["norm.weight"], cfg["rms_norm_eps"])
    return x @ p["lm_head.weight"].T


def shared_prefixes(seqs: Sequence[Tuple[np.ndarray, int]],
                    probe: int = 32) -> List[int]:
    """For each ``(tokens, n_prompt)``, the length of the prefix it shares
    with the other sequences that begin with the same ``probe`` tokens (0
    alone), at most the shortest such prompt less one, so that every read
    position lies past it."""
    groups = {}
    for j, (t, _) in enumerate(seqs):
        if len(t) > probe:
            groups.setdefault(tuple(np.asarray(t[:probe]).tolist()),
                              []).append(j)
    out = [0] * len(seqs)
    for members in groups.values():
        if len(members) < 2:
            continue
        first = np.asarray(seqs[members[0]][0])
        n = min(len(seqs[j][0]) for j in members)
        same = np.ones(n, dtype=bool)
        for j in members[1:]:
            same &= np.asarray(seqs[j][0][:n]) == first[:n]
        lcp = int(np.argmin(same)) if not same.all() else n
        lcp = min(lcp, min(seqs[j][1] for j in members) - 1)
        for j in members:
            out[j] = max(lcp, 0)
    return out


@torch.no_grad()
def margins_and_gaps(cfg: dict, seed: int,
                     seqs: Sequence[Tuple[np.ndarray, int]], device, *,
                     weight_dtype=torch.bfloat16, std: float = 0.02,
                     quant=None, head_rows: int = 256):
    """``(gaps, margins)``: for each ``(tokens, n_prompt)`` the gap of
    every served token below the reference's best logit at its position
    (:func:`~.common.head_gaps`), and the least routing margin over the MoE
    layers at each position from ``n_prompt - 1`` on. A prefix that several
    sequences share (:func:`shared_prefixes`) is one unit, computed once."""
    if not seqs:
        return [], []
    with C.float32_products():
        args = (device, weight_dtype, std, quant)
        toks = C.tokens(seqs, device)
        pre = shared_prefixes(seqs)
        emb = C.group(cfg, seed, "embed", *args)["embed_tokens.weight"]
        units, own, parent_of = [], [], {}
        for t, p_len in zip(toks, pre):
            parent = None
            if p_len:
                key = (p_len, tuple(t[:32].tolist()))
                if key not in parent_of:
                    parent_of[key] = len(units)
                    units.append({"h": emb[t[:p_len]], "start": 0,
                                  "parent": None})
                parent = parent_of[key]
            own.append(len(units))
            units.append({"h": emb[t[p_len:]], "start": p_len,
                          "parent": parent})
        del emb
        sizes = [u["h"].shape[0] for u in units]
        least = torch.full((sum(sizes),), float("inf"), device=device)
        for i in range(cfg["num_hidden_layers"]):
            p = C.group(cfg, seed, f"layer.{i}", *args)
            margin = layer(units, p, i, cfg)
            if margin is not None:
                least = torch.minimum(least, margin)
            del p
        final = C.group(cfg, seed, "final", *args)["norm.weight"]
        head = C.group(cfg, seed, "head", *args)["lm_head.weight"]
        parts = least.split(sizes)
        mine = [((t[p_len:].cpu().numpy(), n - p_len))
                for (t, p_len, (_, n)) in zip(toks, pre, seqs)]
        gaps = C.head_gaps(mine, [t[p_len:] for t, p_len in zip(toks, pre)],
                           [units[u]["h"] for u in own], final, head,
                           cfg["rms_norm_eps"], head_rows)
        margins = [parts[u][n - p_len - 1:].cpu().numpy()
                   for u, p_len, (_, n) in zip(own, pre, seqs)]
        return gaps, margins


def clear(margin: np.ndarray, served: int, at_least: float = None):
    """Which of a sequence's ``served`` tokens to read: those whose
    choosing position has a routing margin (``margin``, from ``n_prompt -
    1`` on) of at least ``at_least`` (``ROUTING_MARGIN``)."""
    at_least = ROUTING_MARGIN if at_least is None else at_least
    return margin[:served] >= at_least


def served_gaps(cfg: dict, seed: int, seqs: Sequence[Tuple[np.ndarray, int]],
                device, *, weight_dtype=torch.bfloat16, std: float = 0.02,
                quant=None, head_rows: int = 256) -> List[np.ndarray]:
    """For each ``(tokens, n_prompt)``: the gaps of the served tokens whose
    routing is clear (:func:`clear`), in order."""
    gaps, margins = margins_and_gaps(cfg, seed, seqs, device,
                                     weight_dtype=weight_dtype, std=std,
                                     quant=quant, head_rows=head_rows)
    return [g[clear(m, g.size)] for g, m in zip(gaps, margins)]
