"""K8, the int8 weight-only matmul, in the serving prefill (replayed or
launched one by one, ``_replays``): each prefill call in the slice reads
every int8 weight and its per-channel fp32 scales once; each real suffix
token (``prefill_tokens``) passes the layers' projections, and one row a
call passes the head (the last real token's logits; a call has at least
one live row); activations read once and outputs written once, in bf16.
Bound by bytes over 3.35 TB/s or FLOPs over 989 TFLOP/s, against the
device time of those K8 kernels. Padded rows are left out of the work, so
the share errs low."""

from .. import work
from ._replays import split
from ._tokens import delta

NAME, UNIT, SOURCE = "k8_roofline.prefill.tok_s", "%", "device_trace"
LAYER, MOVES = "kernel K8 (int8 weight-only matmul)", "output_tok_s"
KERNELS = ("int8_matmul_kernel",)


def read(run, trace, cell):
    if not trace:
        return None
    calls, toks = delta(run, "prefill_calls"), delta(run, "prefill_tokens")
    if not calls or not toks:
        return None
    _, prefill = split(trace, KERNELS)
    secs = sum(s for s, _ in prefill)
    if secs <= 0:
        return None
    mats = work.linears(cell["config"])
    layers, (hn, hk) = mats[:-1], mats[-1]
    act = work.ELEM["bfloat16"]
    flops = 2.0 * (toks * sum(n * k for n, k in layers) + calls * hn * hk)
    nbytes = (calls * sum(n * k + 4 * n for n, k in mats)
              + act * (toks * sum(n + k for n, k in layers)
                       + calls * (hn + hk)))
    return 100.0 * work.bound_s(flops, nbytes) / secs
