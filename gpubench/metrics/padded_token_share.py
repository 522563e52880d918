"""Share of the prefill slots (``prefill_group`` rows x the call's bucket)
before the traced slice that held padding rather than a real suffix token
(engine counters ``prefill_tokens`` / ``prefill_slots``;
``_before_slice`` says why there)."""

from ._before_slice import delta

NAME, UNIT, SOURCE = "padded_token_share", "%", "program_span"
LAYER, MOVES = "engine (prefill batching)", "ttft_p95_ms"
KERNELS = ()


def read(run, trace, cell):
    t, slots = delta(run, "prefill_tokens"), delta(run, "prefill_slots")
    if not slots or t is None:
        return None
    return 100.0 * (1.0 - t / slots)
