"""K4, the paged-decode attention (both kernels of the split pair): the
bytes the slice's decode steps need for attention (q, the live tokens' K/V
rows and scales, the table entries, out; from each lane's context length)
over 3.35 TB/s, against K4's device time."""

from .. import trace as T, work
from ._tokens import decode_tokens

NAME, UNIT, SOURCE = "k4_roofline.tok_s", "%", "device_trace"
LAYER, MOVES = "kernel K4 (paged decode)", "output_tok_s"
KERNELS = ("paged_decode_split_kernel", "paged_decode_combine_kernel")


def read(run, trace, cell):
    if not trace:
        return None
    secs = T.kernel_seconds(trace, KERNELS)
    if secs <= 0:
        return None
    flops = nbytes = 0.0
    for p, j in decode_tokens(run):
        f, b = work.paged_decode(cell["config"], p + j, run["pool"],
                                 run["block_size"])
        flops += f
        nbytes += b
    return 100.0 * work.bound_s(flops, nbytes) / secs
