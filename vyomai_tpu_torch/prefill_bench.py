"""The serving prefill, eager against its captured graph, per bucket, on one
NVIDIA card.

    python -m vyomai_tpu_torch.prefill_bench [--int8]

At Qwen3-0.6B's widths (``QwenConfig()``; random weights; bf16 weights
and pool, or with ``--int8`` int8 weights (K8) and an int8 pool), a call
of the serving engine's shape: 4 rows, each a 1,024-token cached prefix
and a suffix that fills the bucket, over 193 table entries of 16-token
blocks (the chat cell's 3,088-key gathered context), for buckets 32 to
512. One JSON line per bucket and mode (``eager``:
``paged_model.prefill``; ``graph``: ``PrefillGraph.start`` and ``run``),
medians of 10 calls, each started on an idle card:

- ``host_ms``: from the call until it returns to the host;
- ``call_ms``: until the device has finished it too;
- ``device_ms``: the time the card was busy in the call, the union of
  its kernels, copies and fills in a ``torch.profiler`` trace of 3 calls
  (None where the trace shows no device time);
- graph lines add ``capture_s``, the graph's construction (warm-up and
  capture), and the last line ``graphs_bytes``: device memory the five
  graphs hold, allocated and reserved, sharing one pool as the engine's do.
"""

import argparse
import json
import statistics
import time

import torch

from . import ModelForCausalLM, QwenConfig, quantize_model
from .serving import paged_model as pm

GROUP, BS, MAXB, CACHED = 4, 16, 193, 1024
BUCKETS = (32, 64, 128, 256, 512)


def inputs(bucket: int) -> dict:
    """Host arrays of one call, in ``PrefillGraph.stage()``'s names."""
    g = torch.Generator().manual_seed(bucket)
    ctx = CACHED + bucket
    pos = CACHED + torch.arange(bucket)
    tables = torch.arange(GROUP * MAXB, dtype=torch.int32).reshape(GROUP,
                                                                   MAXB)
    return {"ids": torch.randint(0, QwenConfig().vocab_size,
                                 (GROUP, bucket), generator=g),
            "positions": pos.repeat(GROUP, 1),
            "slot_blocks": tables[:, pos // BS],
            "slot_offsets": (pos % BS).repeat(GROUP, 1),
            "tables": tables,
            "ctx_len": torch.full((GROUP,), ctx),
            "true_len": torch.full((GROUP,), bucket)}


def timed(fn, iters: int = 10) -> dict:
    """Medians of ``host_ms`` and ``call_ms``, and ``device_ms``."""
    fn()
    host, call = [], []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host.append((t1 - t0) * 1e3)
        call.append((time.perf_counter() - t0) * 1e3)
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    # the device's kernels, copies and fills; not the spans' device-side
    # ranges, which run from a span's first kernel to its last
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    busy, end = 0.0, float("-inf")
    for a, b in spans:                  # the union of the intervals, in us
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return {"host_ms": statistics.median(host),
            "call_ms": statistics.median(call),
            "device_ms": busy / 3e3 if busy else None}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--int8", action="store_true",
                    help="int8 weights (K8) and an int8 pool")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("prefill_bench: needs an NVIDIA card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = ModelForCausalLM(QwenConfig(), device=dev,
                             dtype=torch.bfloat16)
    model.init(torch.Generator(device=dev).manual_seed(0))
    model.requires_grad_(False)
    if args.int8:
        quantize_model(model, bits=8)
    pool = pm.init_pool(model.config, GROUP * MAXB, BS,
                        dtype=torch.int8 if args.int8 else torch.bfloat16,
                        device=dev)
    for t in pm.pool_parts(pool):
        if t is None:
            continue
        if t.dtype == torch.bfloat16:
            t.normal_()
        elif t.dtype == torch.int8:
            t.random_(-127, 128)
        else:                                   # an int8 pool's scales
            t.fill_(0.02)
    card = {"card": torch.cuda.get_device_name(0),
            "case": "int8" if args.int8 else "bf16"}
    torch.cuda.synchronize()
    alloc0, res0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    mempool = torch.cuda.graph_pool_handle()
    graphs, capture_s = {}, {}
    for b in BUCKETS:
        t0 = time.perf_counter()
        graphs[b] = pm.PrefillGraph(model, pool, GROUP, b, MAXB,
                                    mempool=mempool)
        torch.cuda.synchronize()
        capture_s[b] = time.perf_counter() - t0
    held = {"allocated": torch.cuda.memory_allocated() - alloc0,
            "reserved": torch.cuda.memory_reserved() - res0}
    for b in BUCKETS:
        x = inputs(b)
        dev_x = [t.to(dev) for t in x.values()]
        graph = graphs[b]
        staged = graph.stage()
        for name, t in x.items():
            staged[name][...] = t.numpy()

        def replay():
            graph.start()
            graph.run()
        for mode, fn in (("eager", lambda: pm.prefill(model, pool, *dev_x)),
                         ("graph", replay)):
            rec = {**card, "bucket": b, "mode": mode, **timed(fn)}
            if mode == "graph":
                rec["capture_s"] = capture_s[b]
            print(json.dumps(rec), flush=True)
    print(json.dumps({**card, "graphs_bytes": held}), flush=True)


if __name__ == "__main__":
    main()
