"""K11, the grouped SwiGLU expert matmul, in the serving prefill (replayed
or launched one by one, ``_replays``): the slice's prefill rows (real
suffix tokens only) and expert visits (``_k11``), bound by bytes over
3.35 TB/s or FLOPs over 989 TFLOP/s, against the device time of those K11
kernels."""

from ._k11 import KERNELS, share  # noqa: F401

NAME, UNIT, SOURCE = "k11_roofline.prefill.tok_s", "%", "device_trace"
LAYER, MOVES = "kernel K11 (grouped expert matmul)", "output_tok_s"


def read(run, trace, cell):
    return share(run, trace, cell, "prefill")
