"""Mean wall time of the eager prefill calls before the traced slice, from
building their inputs to appending their first tokens (engine counters
``prefill_ns`` / ``prefill_calls``; ``_before_slice`` says why there)."""

from ._before_slice import delta

NAME, UNIT, SOURCE = "prefill_call_ms", "ms", "program_span"
LAYER, MOVES = "paged_model (eager prefill)", "ttft_p95_ms"
KERNELS = ()


def read(run, trace, cell):
    ns, n = delta(run, "prefill_ns"), delta(run, "prefill_calls")
    if not n or ns is None:
        return None
    return ns / n / 1e6
