"""Rows each expert visit of a decode step carries: the slice's change of
the engine counters ``moe_rows_decode`` over ``moe_expert_visits_decode``
(the rows over which one expert's weights are read once). None where the
program has no such counters or no MoE layer ran."""

from ._tokens import delta

NAME, UNIT, SOURCE = "expert_rows_per_visit.tok_s", "rows", "program_counter"
LAYER, MOVES = "moe (routing)", "output_tok_s"
KERNELS = ()


def read(run, trace, cell):
    rows = delta(run, "moe_rows_decode")
    visits = delta(run, "moe_expert_visits_decode")
    if not rows or not visits:
        return None
    return rows / visits
