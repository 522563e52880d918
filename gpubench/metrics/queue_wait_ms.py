"""Mean wait of the requests admitted before the traced slice, from their
submit (or their requeue after a preemption) to their move into the
prefill queue (engine counters ``queue_wait_ns`` / ``requests_admitted``,
recorded at the scheduler's span edges; ``_before_slice`` says why
there)."""

from ._before_slice import delta

NAME, UNIT, SOURCE = "queue_wait_ms", "ms", "program_span"
LAYER, MOVES = "engine (admission)", "ttft_p95_ms"
KERNELS = ()


def read(run, trace, cell):
    w, n = delta(run, "queue_wait_ns"), delta(run, "requests_admitted")
    if not n or w is None:
        return None
    return w / n / 1e6
