"""Share of the host-clock seconds before the traced slice that the engine
spent in eager prefill calls (engine counter ``prefill_ns``;
``_before_slice`` says why there): while one runs, no decode tick is
dispatched."""

from ._before_slice import delta, seconds

NAME, UNIT, SOURCE = "prefill_time_share.tok_s", "%", "program_span"
LAYER, MOVES = "paged_model (eager prefill)", "output_tok_s"
KERNELS = ()


def read(run, trace, cell):
    ns = delta(run, "prefill_ns")
    if ns is None or not run.get("slice"):
        return None
    return 100.0 * ns / (seconds(run) * 1e9)
