"""Mean wait of the requests whose first prefill call started before the
traced slice, from their admission to that start (engine counters
``prefill_wait_ns`` / ``requests_prefilled``; ``_before_slice`` says why
there)."""

from ._before_slice import delta

NAME, UNIT, SOURCE = "prefill_wait_ms", "ms", "program_span"
LAYER, MOVES = "engine (prefill scheduling)", "ttft_p95_ms"
KERNELS = ()


def read(run, trace, cell):
    w, n = delta(run, "prefill_wait_ns"), delta(run, "requests_prefilled")
    if not n or w is None:
        return None
    return w / n / 1e6
