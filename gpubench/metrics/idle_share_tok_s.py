"""Share of the slice in which no kernel, memcpy or memset ran on the
device."""

from .. import trace as T

NAME, UNIT, SOURCE = "idle_share.tok_s", "%", "device_trace"
LAYER, MOVES = "device", "output_tok_s"
KERNELS = ()


def read(run, trace, cell):
    return T.idle_share(trace) if trace else None
