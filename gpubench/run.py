"""Run one cell of ``BENCHMARK.json`` once.

    python -m gpubench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the cell's cards. Prints
one JSON line last on standard output (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
then ``checks``), and each number compared beside its limit as the last
lines on standard error. ``--trace 0`` reports the cell's end-to-end
metrics; ``--trace 1`` profiles a slice of the window and reports its
per-layer metrics. Exits non-zero, printing no result, without enough CUDA
cards, or if JAX or the JAX package is loaded once the window has closed.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".gpubench_cache"
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)

FORBIDDEN = {"jax", "jaxlib", "flax", "vyomai_tpu"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device="cuda", which: str = "program", t_start: float = None):
    """Set up, measure, check. Returns ``(result, checks, run)``."""
    import torch
    from . import check, spec, stats
    from .trace import Tracer
    from .weights import DTYPES
    t_start = T_START if t_start is None else t_start
    cfg = cell["config"]
    cuda = torch.device(device).type == "cuda"
    t_setup = time.monotonic()
    ent = spec.entry(cell["traffic"]["entry"]).Entry(cell, seed, seconds,
                                                     device, which)
    ent.setup()
    # what set-up made stays out of the collector's passes in the window
    gc.collect()
    gc.freeze()
    # the window's peak: set-up transients (a model held in bf16 until it
    # is quantized) are noted apart
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    slice_at = 0.4 * seconds
    tracer = Tracer(trace, slice_at, slice_at + min(4.0, 0.3 * seconds))
    run = ent.window(tracer)
    run["setup_s"] = run["t0"] - t_start
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    tracer.reduce()
    limits = spec.limits(cell["name"])
    seqs = check.served(run, check.sample(run, seed,
                                          check.reads_whole(limits)))
    ent.close()
    del ent
    gc.unfreeze()
    w = cfg["weights"]
    t_check = time.monotonic()
    gaps = spec.family(cfg).served_gaps(
        cfg, seed, seqs, device, weight_dtype=DTYPES[w["dtype"]],
        std=w["init_std"], quant=cfg["reference"]["quant"])
    check_s = time.monotonic() - t_check
    checks = check.judge(run, cfg["vocab_size"], gaps, limits)
    metrics, bad = {}, []
    if trace:
        mods = spec.layer_metrics()
        for m in cell["per_layer"]:
            v = mods[m["name"]].read(run, tracer.result, cell)
            if v is None:
                continue
            if v > 105.0 and ("roofline" in m["name"] or "mfu" in m["name"]):
                bad.append(f"{m['name']} = {v}")
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        mods = spec.e2e_metrics()
        for m in cell["end_to_end"]:
            v = mods[m["name"]].read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if bad:
        raise RuntimeError("share of a peak over 105%, a fault in the "
                           "count: " + ", ".join(bad))
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": check.passed(checks),
              "attempted": run["attempted"], "failed": run["failed"],
              "metrics": metrics, "device": dev}
    if trace and tracer.result:
        dev["busy_s"] = tracer.result["busy_s"]
        dev["window_s"] = tracer.result["window_s"]
        result["breakdown"] = tracer.result["breakdown"]
    result["checks"] = checks
    ttft = stats.ttfts(run["requests"])
    run["notes"] = {"ttft_s": stats.summary(ttft), "lag_s": run["lag_s"],
                    "requests": len(run["requests"]),
                    "sampled": len(seqs),
                    "read_len_p50": stats.percentile(
                        [len(t) for t, _ in seqs], 50),
                    "check_s": check_s,
                    "before_setup_s": t_setup - t_start,
                    "setup_phases_s": run.get("setup_phases_s"),
                    "setup_peak_bytes": setup_peak,
                    "call_s": [e - s for s, e in run.get("calls", [])]}
    return result, checks, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    from . import spec
    torch.set_num_threads(1)     # one process, few threads: steadier load
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    result, checks, run = run_cell(cell, args.seed, args.seconds,
                                   bool(args.trace))
    print(json.dumps({"notes": run["notes"]}), file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} "
              f"{'at least' if c.get('at_least') else 'limit'} {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
