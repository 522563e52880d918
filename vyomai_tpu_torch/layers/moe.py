"""Mixture-of-experts FFN (counterpart of ``vyomai_tpu.layers.moe``,
dropless inference): a router, a top-k choice and stacked SwiGLU experts
run through K11 (``ops.grouped_matmul``).

Two routers:

- ``"softmax"``, the JAX ``moe_apply``'s: ``p = softmax(x Wᵀ)``, the top
  ``k`` of ``p``, their weights renormalised to sum to 1;
- ``"sigmoid"``, LFM2-MoE's: ``s = sigmoid(x Wᵀ)``, the top ``k`` of ``s +
  expert_bias`` (the bias steers the choice only), weighted by their ``s``
  over ``Σ s + norm_eps`` (``norm_topk_prob``; ``norm_eps`` 1e-6, LFM2's)
  times ``routed_scaling_factor``. DeepSeek-V3's ``noaux_tc`` router with
  one group is this router (its ``e_score_correction_bias`` the
  ``expert_bias``, ``norm_eps`` 1e-20).

A layer may also hold ``shared_experts``, one SwiGLU that every token
passes through (DeepSeek-V3's), added to the experts' sum.

Routing runs in fp32. The (token, choice) rows are grouped by expert on
the device with no read-back (a rank within each expert from a cumulative
count, then each expert's first row), so a CUDA graph captures the layer
whatever the routing; rows of tokens marked invalid (padded prefill slots,
dead decode lanes) go to no expert and cost K11 nothing. The routing
weights are applied in the combine, which sums each token's ``k`` rows in
fp32. The module tree holds ``gate`` (the router, ``[E, H]``), ``w1``,
``w3 [E, I, H]`` (gate and up), ``w2 [E, H, I]`` (down) and, for the
sigmoid router with ``use_expert_bias``, ``expert_bias [E]``, and with
``shared_inter`` the ``shared_experts.{gate,up,down}_proj``; JAX's
``router.kernel``, ``w_gate``, ``w_in`` and ``w_out`` are their
transposes. ``quant.quantize_model`` quantizes the router and the shared
expert (each an ``nn.Linear``) and leaves the banks in their dtype.
"""

from types import SimpleNamespace
from typing import Optional

import torch
from torch import nn

from ..core import nn as cnn
from ..ops.grouped_matmul import grouped_swiglu
from .modern import SwiGLU, _linear, swiglu_apply

ROUTERS = ("softmax", "sigmoid")


class MoE(nn.Module):
    def __init__(self, hidden: int, inter: int, num_experts: int,
                 top_k: int, *, router: str = "softmax",
                 expert_bias: bool = False, norm_topk_prob: bool = True,
                 routed_scaling_factor: float = 1.0, norm_eps: float = 1e-6,
                 shared_inter: int = 0, device=None, dtype=torch.float32):
        super().__init__()
        if router not in ROUTERS:
            raise ValueError(f"router {router!r}: one of {ROUTERS}")
        self.router, self.top_k = router, min(top_k, num_experts)
        self.norm_topk_prob = norm_topk_prob
        self.routed_scaling_factor = float(routed_scaling_factor)
        self.norm_eps = float(norm_eps)
        self.gate = _linear(hidden, num_experts, device, dtype)
        kw = dict(device=device, dtype=dtype)
        self.w1 = nn.Parameter(torch.empty(num_experts, inter, hidden, **kw))
        self.w3 = nn.Parameter(torch.empty(num_experts, inter, hidden, **kw))
        self.w2 = nn.Parameter(torch.empty(num_experts, hidden, inter, **kw))
        self.expert_bias = (nn.Parameter(torch.zeros(num_experts, **kw))
                            if router == "sigmoid" and expert_bias else None)
        self.shared_experts = (SwiGLU(SimpleNamespace(
            hidden_size=hidden, intermediate_size=shared_inter), **kw)
            if shared_inter else None)

    @property
    def num_experts(self) -> int:
        return self.w1.shape[0]


def router_logits(gate: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``x Wᵀ`` in fp32 (fp64 for fp64): a float router multiplies in fp32,
    a quantized one runs its own kernel and widens the result."""
    acc = torch.promote_types(x.dtype, torch.float32)
    if isinstance(gate, nn.Linear):
        return cnn.linear(gate.weight.to(acc), x.to(acc))
    return cnn.apply_linear(gate, x).to(acc)


def route(moe: MoE, logits: torch.Tensor):
    """``(weights [T, k], experts [T, k])`` of fp32 ``logits [T, E]``."""
    k = moe.top_k
    if moe.router == "softmax":
        w, sel = torch.topk(torch.softmax(logits, dim=-1), k, dim=-1)
        return w / w.sum(-1, keepdim=True), sel
    s = torch.sigmoid(logits)
    score = s if moe.expert_bias is None else s + moe.expert_bias.to(s.dtype)
    sel = torch.topk(score, k, dim=-1).indices
    w = s.gather(-1, sel)
    if moe.norm_topk_prob:
        w = w / (w.sum(-1, keepdim=True) + moe.norm_eps)
    return w * moe.routed_scaling_factor, sel


def dispatch(sel: torch.Tensor, num_experts: int,
             valid: Optional[torch.Tensor] = None):
    """Group the ``T x k`` (token, choice) rows by expert, on the device:
    ``(pos [T*k], src [T*k], offsets [E + 1])`` with ``pos`` each row's
    place in expert order (stable: token order within an expert), ``src``
    the token of each place, ``offsets`` the first place of each expert
    and, last, the rows in use. A row of an invalid token goes to a
    sentinel group after the last expert."""
    t, k = sel.shape
    e = num_experts
    flat = sel.reshape(-1)
    if valid is not None:
        flat = torch.where(valid.reshape(-1, 1).expand(t, k).reshape(-1),
                           flat, e)
    # [E+1, T*k]: a scan along each group's contiguous row, which the
    # card runs a block a group (down the transpose's E+1 columns it runs
    # one thread a column, serially over every row)
    onehot = (torch.arange(e + 1, device=flat.device)[:, None] == flat
              ).to(torch.int32)
    seen = torch.cumsum(onehot, 1)                  # rows of each group so far
    counts = seen[:, -1]
    starts = torch.cumsum(counts, 0) - counts                   # [E + 1]
    rank = seen.gather(0, flat[None])[0] - 1
    pos = starts[flat] + rank
    rows = torch.arange(t * k, device=flat.device)
    src = torch.empty_like(rows).scatter_(0, pos.long(), rows // k)
    return pos.long(), src, starts.to(torch.int32)


def moe_apply(moe: MoE, x: torch.Tensor, valid: Optional[torch.Tensor] = None,
              counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The layer over ``x [..., H]``; ``valid [...]`` bool marks the tokens
    to route (None: all), the others give 0 from the experts (the shared
    expert, where there is one, runs on every token, its sum with the
    routed one rounded once). ``counts`` (int64 ``[2]``, on x's device),
    when given, gains in place the rows K11 ran and the experts that got
    at least one."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    t, e = x2.shape[0], moe.num_experts
    w, sel = route(moe, router_logits(moe.gate, x2))
    pos, src, offsets = dispatch(sel, e, valid)
    y = grouped_swiglu(x2.contiguous(), src, offsets, moe.w1, moe.w3,
                       moe.w2)
    out = (y[pos].view(t, moe.top_k, -1).to(w.dtype) * w[..., None]).sum(1)
    if valid is not None:
        # rows past offsets[E] hold nothing K11 wrote
        out = torch.where(valid.reshape(-1, 1), out, 0.0)
    if counts is not None:
        counts[0] += offsets[e]
        counts[1] += (offsets[1:] > offsets[:-1]).sum()
    if moe.shared_experts is not None:
        out = out + swiglu_apply(moe.shared_experts, x2)
    return out.to(x.dtype).reshape(shape)
