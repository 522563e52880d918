"""K8, the int8 weight-only matmul, in the replayed decode step: per
replay, every int8 weight and its scales read once plus the activations,
over 3.35 TB/s, against the device time of the K8 kernels that the slice's
graph replays (``cudaGraphLaunch``) ran; eager prefill launches are left
out."""

from .. import trace as T, work

NAME, UNIT, SOURCE = "k8_roofline.tok_s", "%", "device_trace"
LAYER, MOVES = "kernel K8 (int8 weight-only matmul)", "output_tok_s"
KERNELS = ("int8_matmul_kernel",)
LAUNCHER = "cudaGraphLaunch"


def read(run, trace, cell):
    if not trace:
        return None
    secs = T.kernel_seconds(trace, KERNELS, LAUNCHER)
    replays = T.launches(trace, KERNELS, LAUNCHER)
    if secs <= 0 or not replays:
        return None
    flops, nbytes = work.weight_only_step(cell["config"], run["lanes"], 8)
    return 100.0 * replays * work.bound_s(flops, nbytes) / secs
