"""K13, MLA attention over the latent pool, in prefill calls: the slice's
live (query, key) pairs and each call's distinct rows (``_k13``), bound by
bytes over 3.35 TB/s or FLOPs over 989 TFLOP/s, against the device time of
``k13_prefill_kernel``. None where the program has no such counters or
kernels."""

from ._k13 import PREFILL as KERNELS, share  # noqa: F401

NAME, UNIT, SOURCE = "k13_roofline.prefill.tok_s", "%", "device_trace"
LAYER, MOVES = "kernel K13 (MLA attention)", "output_tok_s"


def read(run, trace, cell):
    return share(run, trace, cell, "prefill")
