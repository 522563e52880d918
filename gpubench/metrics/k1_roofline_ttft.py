"""K1, the flash forward, in the engine's eager prefill: the attention the
slice's prefill calls need (engine counters), each real suffix token
against the keys it attends (``prefill_attn_pairs``), its q read and its
out written once (``prefill_tokens``), each row's K/V context read once a
layer (``prefill_ctx_tokens``), bound by bytes over 3.35 TB/s or FLOPs over
989 TFLOP/s, against the device time of the K1 kernels that
``cudaLaunchKernel`` launched (the graph tick launches none). Summed counts
give a bound no larger than the sum of the calls' bounds, so the share errs
low."""

from .. import trace as T, work
from ._tokens import delta

NAME, UNIT, SOURCE = "k1_roofline.ttft", "%", "device_trace"
LAYER, MOVES = "kernel K1 (flash forward)", "ttft_p95_ms"
KERNELS = ("flash_fwd_kernel",)
LAUNCHER = "cudaLaunchKernel"


def read(run, trace, cell):
    if not trace:
        return None
    pairs, toks, ctx = (delta(run, k) for k in (
        "prefill_attn_pairs", "prefill_tokens", "prefill_ctx_tokens"))
    if not pairs or toks is None or ctx is None:
        return None
    secs = T.kernel_seconds(trace, KERNELS, LAUNCHER)
    if secs <= 0:
        return None
    d = work.dims(cell["config"])
    flops = 4.0 * d["nh"] * d["hd"] * d["layers"] * pairs
    nbytes = d["layers"] * (
        2 * d["nh"] * d["hd"] * work.ELEM["bfloat16"] * toks
        + 2 * d["nkv"] * d["hd"] * work.ELEM[run["pool"]] * ctx)
    return 100.0 * work.bound_s(flops, nbytes) / secs
