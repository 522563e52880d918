"""Mean host time of the decode ticks before the traced slice, less their
waits on the device: building and staging a tick's inputs, launching its
graph replays, harvesting its tokens (engine counters ``tick_host_ns`` /
``decode_ticks``; ``_before_slice`` says why there)."""

from ._before_slice import delta

NAME, UNIT, SOURCE = "tick_host_ms.tok_s", "ms", "program_span"
LAYER, MOVES = "paged_model (HorizonGraph tick)", "output_tok_s"
KERNELS = ()


def read(run, trace, cell):
    ns, n = delta(run, "tick_host_ns"), delta(run, "decode_ticks")
    if not n or ns is None:
        return None
    return ns / n / 1e6
