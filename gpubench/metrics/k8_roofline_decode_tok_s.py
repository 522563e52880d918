"""K8, the int8 weight-only matmul, in the replayed decode step alone: per
replay, every int8 weight and its scales read once plus the activations,
over 3.35 TB/s, against the device time of the K8 kernels that decode
replays ran (``_replays``); the captured prefill's K8 is left out
(``k8_roofline.prefill.tok_s`` reads it)."""

from .. import work
from ._replays import split

NAME, UNIT, SOURCE = "k8_roofline.decode.tok_s", "%", "device_trace"
LAYER, MOVES = "kernel K8 (int8 weight-only matmul)", "output_tok_s"
KERNELS = ("int8_matmul_kernel",)


def read(run, trace, cell):
    if not trace:
        return None
    decode, _ = split(trace, KERNELS)
    secs = sum(s for s, _ in decode)
    replays = len({c for _, c in decode})
    if secs <= 0 or not replays:
        return None
    flops, nbytes = work.weight_only_step(cell["config"], run["lanes"], 8)
    return 100.0 * replays * work.bound_s(flops, nbytes) / secs
