"""Share of the prefill calls' time, before the traced slice, spent until
the forward has returned: building and copying up the inputs and queueing
the kernels, ahead of the read-back that waits for the device (engine
counters ``prefill_dispatch_ns`` / ``prefill_ns``; ``_before_slice`` says
why there). Near 100 %, the host sets the prefill's pace."""

from ._before_slice import delta

NAME, UNIT, SOURCE = "prefill_dispatch_share", "%", "program_span"
LAYER, MOVES = "paged_model (eager prefill)", "ttft_p95_ms"
KERNELS = ()


def read(run, trace, cell):
    d, ns = delta(run, "prefill_dispatch_ns"), delta(run, "prefill_ns")
    if not ns or d is None:
        return None
    return 100.0 * d / ns
