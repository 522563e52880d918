"""K13, MLA attention over the latent pool, in decode steps: the slice's
latent (lane, row) pairs and distinct rows (``_k13``), bound by bytes over
3.35 TB/s or FLOPs over 989 TFLOP/s, against the device time of K13's
decode pair (``k13_decode_split_kernel``, ``k13_decode_combine_kernel``).
None where the program has no such counters or kernels."""

from ._k13 import DECODE as KERNELS, share  # noqa: F401

NAME, UNIT, SOURCE = "k13_roofline.decode.tok_s", "%", "device_trace"
LAYER, MOVES = "kernel K13 (MLA attention)", "output_tok_s"


def read(run, trace, cell):
    return share(run, trace, cell, "decode")
