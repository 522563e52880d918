"""Share of the slice's decode ticks dispatched from the in-flight tick's
carry (engine counters ``chained_ticks`` / ``decode_ticks``)."""

from ._tokens import delta

NAME, UNIT, SOURCE = "chained_tick_share", "%", "program_counter"
LAYER, MOVES = "engine (pipelined ticks)", "output_tok_s"
KERNELS = ()


def read(run, trace, cell):
    d, c = delta(run, "decode_ticks"), delta(run, "chained_ticks")
    if not d:
        return None
    return 100.0 * c / d
