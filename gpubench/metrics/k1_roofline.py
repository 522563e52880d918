"""K1, the flash forward, in static-cache generation: each traced call's
causal prefill and its Lq = 1 steps over their live keys (not the whole
static buffer), in every attention layer, each launch bound by bytes over
3.35 TB/s or FLOPs over 989 TFLOP/s, against K1's device time."""

from .. import trace as T, work

NAME, UNIT, SOURCE = "k1_roofline.gen", "%", "device_trace"
LAYER, MOVES = "kernel K1 (flash forward)", "generate_tok_s"
KERNELS = ("flash_fwd_kernel",)


def read(run, trace, cell):
    if not trace or "calls" not in run:
        return None
    secs = T.kernel_seconds(trace, KERNELS)
    if secs <= 0:
        return None
    d = work.dims(cell["config"])
    b, p, n = run["batch"], run["prompt_len"], run["new_tokens"]
    args = (b, d["nh"], d["nkv"])
    bound = work.bound_s(*work.flash_prefill(*args, p, d["hd"]))
    for pos in range(p, p + n - 1):
        bound += work.bound_s(*work.flash_step(*args, pos + 1, d["hd"]))
    return 100.0 * bound * d["attn_layers"] / secs
