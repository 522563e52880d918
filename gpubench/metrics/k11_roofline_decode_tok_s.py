"""K11, the grouped SwiGLU expert matmul, in the replayed decode step
alone: the slice's decode rows and expert visits (``_k11``), bound by
bytes over 3.35 TB/s or FLOPs over 989 TFLOP/s, against the device time
of the K11 kernels that decode replays ran (``_replays``)."""

from ._k11 import KERNELS, share  # noqa: F401

NAME, UNIT, SOURCE = "k11_roofline.decode.tok_s", "%", "device_trace"
LAYER, MOVES = "kernel K11 (grouped expert matmul)", "output_tok_s"


def read(run, trace, cell):
    return share(run, trace, cell, "decode")
