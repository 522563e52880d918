"""Share of the prefill calls before the traced slice that a captured
graph's replay served (engine counters ``prefill_graph_calls`` /
``prefill_calls``; ``_before_slice`` says why there): 0 on the card where
every call ran eagerly. None where no prefill ran, where the program has
no such counter, or where the run was not on the card (its trace holds no
kernel; the CPU's prefill is eager by design)."""

from ._before_slice import delta

NAME, UNIT, SOURCE = "prefill_graph_share", "%", "program_counter"
LAYER, MOVES = "paged_model (eager prefill)", "ttft_p95_ms"
KERNELS = ()


def share(run, trace):
    n, g = delta(run, "prefill_calls"), delta(run, "prefill_graph_calls")
    if not n or g is None or not (trace and trace["kernels"]):
        return None
    return 100.0 * g / n


def read(run, trace, cell):
    return share(run, trace)
