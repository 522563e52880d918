"""K11's work in the traced slice, for its two roofline readers (not a
metric: it has no ``NAME``). From the engine's MoE counters
(``moe_rows_<phase>``, ``moe_expert_visits_<phase>``) over the slice:
FLOPs 2 x 3 x I x H a row K11 ran (gate, up and down); bytes, each expert
that got a row in a layer's call reading its three I x H matrices once
(``visits``), plus each row's activations in and out (H values each).
The counters stand as of the last tick harvested and the last prefill read,
so a tick in flight at an edge of the slice counts on one side of it; the
kernels' time is what ``_replays`` puts in decode replays or in prefill
calls."""

from .. import work
from ._replays import split
from ._tokens import delta

KERNELS = ("k11_gate_up_kernel", "k11_down_kernel")


def counts(cfg: dict, rows: float, visits: float, dtype: str = "bfloat16"):
    """``(flops, bytes)`` of ``rows`` routed rows over ``visits`` (layer,
    call, expert) visits."""
    h, mi = cfg["hidden_size"], cfg["moe_intermediate_size"]
    e = work.ELEM[dtype]
    flops = 2.0 * 3 * mi * h * rows
    nbytes = 3.0 * mi * h * e * visits + 2.0 * h * e * rows
    return flops, nbytes


def share(run, trace, cell, phase: str):
    """K11's share of its roofline in ``phase`` (``decode`` or
    ``prefill``); None without a trace, the counters or the kernels."""
    if not trace:
        return None
    rows = delta(run, f"moe_rows_{phase}")
    visits = delta(run, f"moe_expert_visits_{phase}")
    if not rows or not visits:
        return None
    decode, prefill = split(trace, KERNELS)
    secs = sum(s for s, _ in (decode if phase == "decode" else prefill))
    if secs <= 0:
        return None
    cfg = cell["config"]
    flops, nbytes = counts(cfg, rows, visits, cfg["weights"]["dtype"])
    return 100.0 * work.bound_s(flops, nbytes) / secs
