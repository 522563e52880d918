"""Lanes that read each latent row in a decode step: the slice's change of
the engine counters ``mla_rows_decode`` over ``mla_distinct_rows_decode``
(1 where no two lanes share a cached block; the lanes on one cached
document where they do). None where the program has no such counters or
no MLA layer ran."""

from ._tokens import delta

NAME, UNIT, SOURCE = "latent_lanes_per_row.tok_s", "lanes", "program_counter"
LAYER, MOVES = "paged_model (latent pool)", "output_tok_s"
KERNELS = ()


def read(run, trace, cell):
    rows = delta(run, "mla_rows_decode")
    distinct = delta(run, "mla_distinct_rows_decode")
    if not rows or not distinct:
        return None
    return rows / distinct
