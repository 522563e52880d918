"""K1, the flash forward, in the engine's prefill under any launcher: the
work of ``k1_roofline.ttft`` (``prefill_attn_pairs``, ``prefill_tokens``,
``prefill_ctx_tokens`` over the slice) against the device time of every
K1 kernel in the slice, launched one by one or replayed in a captured
prefill (``k1_roofline.ttft`` reads only the former; the decode graph
launches no K1). Summed counts give a bound no larger than the sum of the
calls' bounds, so the share errs low."""

from .. import trace as T, work
from ._tokens import delta

NAME, UNIT, SOURCE = "k1_roofline.prefill.ttft", "%", "device_trace"
LAYER, MOVES = "kernel K1 (flash forward)", "ttft_p95_ms"
KERNELS = ("flash_fwd_kernel",)


def read(run, trace, cell):
    if not trace:
        return None
    pairs, toks, ctx = (delta(run, k) for k in (
        "prefill_attn_pairs", "prefill_tokens", "prefill_ctx_tokens"))
    if not pairs or toks is None or ctx is None:
        return None
    secs = T.kernel_seconds(trace, KERNELS)
    if secs <= 0:
        return None
    d = work.dims(cell["config"])
    flops = 4.0 * d["nh"] * d["hd"] * d["layers"] * pairs
    nbytes = d["layers"] * (
        2 * d["nh"] * d["hd"] * work.ELEM["bfloat16"] * toks
        + 2 * d["nkv"] * d["hd"] * work.ELEM[run["pool"]] * ctx)
    return 100.0 * work.bound_s(flops, nbytes) / secs
