"""Share of the prompt tokens submitted in the slice that the radix cache
served (engine counters ``cached_prompt_tokens`` / ``prompt_tokens``)."""

from ._tokens import delta

NAME, UNIT, SOURCE = "prefix_hit_share", "%", "program_counter"
LAYER, MOVES = "engine (radix cache)", "ttft_p95_ms"
KERNELS = ()


def read(run, trace, cell):
    p, c = delta(run, "prompt_tokens"), delta(run, "cached_prompt_tokens")
    if not p:
        return None
    return 100.0 * c / p
