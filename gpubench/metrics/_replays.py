"""Which launch ran a kernel in the serving engine's traced slice (not a
metric: it has no ``NAME``). The engine replays two captured graphs, its
decode step (K4, and no K1) and a prefill call (K1 in every layer), each
replay one ``cudaGraphLaunch`` whose kernels all carry that call's
correlation id; a prefill that is not captured launches its kernels one by
one. A replay cut by the slice's edge may lose its K1 and read as a
decode replay: at most one at each edge."""

GRAPH = "cudaGraphLaunch"
K1 = ("flash_fwd_kernel",)


def _named(name, names):
    return any(k in name for k in names)


def split(trace: dict, names):
    """``(decode, prefill)``: the kernels whose name holds one of
    ``names``, as ``(seconds, correlation)``, that decode replays ran and
    that prefill calls ran, replayed or launched one by one."""
    kernels = trace["kernels"]
    prefill_replays = {c for n, _, _, via, c in kernels
                       if GRAPH in via and _named(n, K1)}
    decode, prefill = [], []
    for n, a, b, via, c in kernels:
        if not _named(n, names):
            continue
        if GRAPH in via and c not in prefill_replays:
            decode.append((b - a, c))
        else:
            prefill.append((b - a, c))
    return decode, prefill
