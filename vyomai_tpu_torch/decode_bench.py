"""K4, the paged-decode attention, at the serving shapes on one NVIDIA card.

    python -m vyomai_tpu_torch.decode_bench
    python vyomai_tpu_torch/decode_bench.py --root DIR

The second form times the port of another checkout at ``DIR`` (its
``vyomai_tpu_torch`` is imported instead of this one), so two trees can be
compared in turns on one card. Cases (B=16, H=16, H_kv=8, BS=16, MAXB=64
unless named): ``ragged``, the lengths of ``chip_smoke.py`` phase 2 (1 to
1,500 tokens, a dead lane, ``-1`` table entries); ``tick``, phase 5's
traced decode tick (every lane at 508 tokens); ``one_lane``, B=1 at 1,024
tokens. Each at bf16 D=128, fp32 D=128 and bf16 D=64, over a float, an
int8 and an int4 pool. One JSON line per case: the plan (``P``, ``S``,
grid) where the checkout has one, the kernel's ms (both kernels of the
split pair), the bound and the share of it; with ``--profile`` also each
kernel's device ms from a ``torch.profiler`` trace (launch gaps excluded).

Times are medians of CUDA-event launches, each behind an L2 flush and a
~1 ms sleep kernel (``quant_bench.time_ms``). The bound is the larger of
the bytes a call must move (q, the live tokens' K and V rows and their
scales, the tables, the output; not the split pair's workspace) over 3.35
TB/s and its FLOPs over the inputs' peak rate.
"""

import argparse
import json
import sys
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PHASE2_LENS = (1, 16, 17, 100, 255, 256, 300, 511, 512, 513, 700, 999, 1023,
               1024, 0, 1500)
SHAPES = {"ragged": (16, PHASE2_LENS), "tick": (16, (508,) * 16),
          "one_lane": (1, (1024,))}
H, H_KV, BS, MAXB = 16, 8, 16, 64


def make_case(torch, kind: str, dtype, d: int, b: int, lens, seed: int = 0):
    """q, pool, tables, lengths and scales (None for a float pool) on the
    card, from a seed; lane 3 of a batch of 16 reads ``-1`` entries past
    its seventh block."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    nb = b * MAXB
    q = torch.randn(b, H, d, device=dev, generator=g).to(dtype)
    if kind == "float":
        pool = torch.randn(nb, 2, BS, H_KV * d, device=dev,
                           generator=g).to(dtype)
        sc = None
    else:
        width = H_KV * d // (2 if kind == "int4" else 1)
        pool = torch.randint(-128, 128, (nb, 2, BS, width), device=dev,
                             generator=g).to(torch.int8)
        shape = (nb, 2, H_KV, BS) if kind == "int4" else (nb, 2, BS)
        sc = torch.rand(shape, device=dev, generator=g) * 0.05
    bt = torch.randperm(nb, device=dev, generator=g).reshape(b, MAXB).int()
    if b > 3:
        bt[3, 7:] = -1
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, pool, bt, sl, sc


def bound(torch, q, pool, bt, sl, sc) -> dict:
    """The least time for this call: bytes the work moves over the memory
    rate, FLOPs over the inputs' peak rate, whichever is larger."""
    b, h, d = q.shape
    live = int(torch.clamp(sl.long(), 0, MAXB * BS).sum())
    row = pool.shape[-1] * pool.element_size()
    if sc is not None:
        row += 4 * (H_KV if sc.dim() == 4 else 1)
    nbytes = (2 * q.numel() * q.element_size() + 2 * live * row
              + bt.numel() * 4 + sl.numel() * 4)
    flops = 4 * d * h * live
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = flops / PEAK_FLOPS[str(q.dtype)[6:]]
    return {"bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def kernel_ms(torch, fn, flush, iters: int = 10) -> dict:
    """Mean device ms per call of each kernel ``fn`` launches, from a
    ``torch.profiler`` trace of ``iters`` calls, each behind an L2 flush
    (kernel durations only: launch gaps are not counted)."""
    act = torch.profiler.ProfilerActivity
    fn()
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if "paged_decode" not in e.key:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t:
            name = e.key.split("<")[0].split("(")[0].split(" ")[-1]
            out[name] = out.get(name, 0.0) + t / 1e3 / iters
    return out


def run(torch, pd, time_ms, iters: int = 20, profile: bool = False):
    """Yield one record per case."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for shape, (b, lens) in SHAPES.items():
        for kind in ("float", "int8", "int4"):
            for d, dtype in ((128, torch.bfloat16), (128, torch.float32),
                             (64, torch.bfloat16)):
                q, pool, bt, sl, sc = make_case(torch, kind, dtype, d, b,
                                                lens)
                fn = lambda: pd.paged_decode(q, pool, bt, sl, H_KV,  # noqa
                                             scales=sc)
                ms = time_ms(fn, flush, iters=iters)
                rec = {"case": shape, "pool": kind, "dtype": str(dtype)[6:],
                       "D": d, "B": b, "ms": ms,
                       **bound(torch, q, pool, bt, sl, sc)}
                if hasattr(pd, "_decode_plan"):
                    p, s = pd._decode_plan(b, H_KV, BS, MAXB)
                    rec.update(P=p, S=s, grid=b * H_KV * s)
                rec["share"] = rec["bound_ms"] / ms
                if profile:
                    rec["kernel_ms"] = kernel_ms(torch, fn, flush)
                yield rec
                del q, pool, bt, sl, sc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None,
                    help="checkout whose vyomai_tpu_torch is timed")
    ap.add_argument("--profile", action="store_true",
                    help="also each kernel's device ms (torch.profiler)")
    args = ap.parse_args(argv)
    here = Path(__file__).resolve().parent
    if sys.path and Path(sys.path[0] or ".").resolve() == here:
        sys.path.pop(0)   # run by path: not the package's own directory
    root = Path(args.root or here.parent).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("decode_bench: needs an NVIDIA card")
    from vyomai_tpu_torch.ops import paged_decode as pd
    from vyomai_tpu_torch.quant_bench import time_ms
    check = Path(pd.__file__).resolve()
    if root not in check.parents:
        raise SystemExit(f"decode_bench: imported {check}, not {root}")
    card = torch.cuda.get_device_name(0)
    for rec in run(torch, pd, time_ms, profile=args.profile):
        print(json.dumps({"root": str(root), "card": card, **rec}),
              flush=True)


if __name__ == "__main__":
    main()
