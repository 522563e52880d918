"""The whole step's share of the card's bf16 peak: model FLOPs of the
tokens processed (each uncached prompt token and each decode step's token
once: 2 per weight it multiplies, head included, plus attention over its
live context) over seconds x 989 TFLOP/s. The seconds are the host
clock's, over the traced run's window outside the profiled slice (for
calls, over the calls not profiled), so that the profiler's cost on the
host stays out of it; nothing is read from the trace."""

from .. import work
from ._tokens import decode_tokens, delta, prefilled, untraced

NAME, UNIT, SOURCE = "mfu.tok_s", "%", "host_clock"
LAYER, MOVES = "whole step", "output_tok_s"
KERNELS = ()


def read(run, trace, cell):
    if not trace or not run.get("slice"):
        return None
    cfg = cell["config"]
    if "calls" in run:
        p, n, rows = run["prompt_len"], run["new_tokens"], run["batch"]
        per_call = rows * (work.prompt_flops(cfg, 0, p) + sum(
            work.token_flops(cfg, pos + 1) for pos in range(p, p + n - 1)))
        spans = [e - s for s, e in run["calls"] if (s, e) != run["slice"]]
        if not spans:
            return None
        return 100.0 * per_call * len(spans) / (sum(spans)
                                                 * work.PEAK_FLOPS_BF16)
    inside, secs = untraced(run)
    sent = delta(run, "prompt_tokens", ("open", "close"))
    cached = delta(run, "cached_prompt_tokens", ("open", "close"))
    fresh = 1.0 - (cached / sent if sent else 0.0)
    flops = fresh * sum(work.prompt_flops(cfg, 0, p)
                        for p in prefilled(run, inside))
    flops += sum(work.token_flops(cfg, p + j)
                 for p, j in decode_tokens(run, inside))
    return 100.0 * flops / (secs * work.PEAK_FLOPS_BF16)
