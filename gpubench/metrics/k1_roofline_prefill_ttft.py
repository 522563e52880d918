"""K1, the flash forward, in the engine's prefill under any launcher: the
attention the slice's prefill calls need (engine counters) in every
attention layer, each real suffix token against the keys it attends
(``prefill_attn_pairs``), its q read and its out written once
(``prefill_tokens``), each row's K/V context read once
(``prefill_ctx_tokens``), bound by bytes over 3.35 TB/s or FLOPs over 989
TFLOP/s, against the device time of every K1 kernel in the slice, launched
one by one or replayed in a captured prefill (the decode graph launches no
K1). Summed counts give a bound no larger than the sum of the calls'
bounds, so the share errs low."""

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
    flops = 4.0 * d["nh"] * d["hd"] * d["attn_layers"] * pairs
    nbytes = d["attn_layers"] * (
        2 * d["nh"] * d["hd"] * work.ELEM["bfloat16"] * toks
        + 2 * d["nkv"] * d["hd"] * work.ELEM[run["pool"]] * ctx)
    return 100.0 * work.bound_s(flops, nbytes) / secs
