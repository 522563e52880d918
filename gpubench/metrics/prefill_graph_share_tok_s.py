"""``prefill_graph_share`` in the cells that report ``output_tok_s``."""

from .prefill_graph_share import share

NAME, UNIT, SOURCE = "prefill_graph_share.tok_s", "%", "program_counter"
LAYER, MOVES = "paged_model (eager prefill)", "output_tok_s"
KERNELS = ()


def read(run, trace, cell):
    return share(run, trace)
