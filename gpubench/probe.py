"""Several runs of one cell in one process: the readings that the limits
of ``correct`` are set from, the control, and the chat mix's rate sweep.

    python -m gpubench.probe --workload <cell> --seeds 1,2,3 --seconds 15 \\
        [--which control] [--rate 12] [--trace 1] [--out file.jsonl]

``--which control`` runs the configuration's ``control`` (the program one
precision step lower), which ``correct`` has to fail. ``--rate`` replaces
an open-loop mix's arrival rate. Each run prints one JSON line with its
metrics, checks and notes (for an open loop, the 95th percentile of the
time to first token in each quarter of the window, and the requests still
waiting for a first token at its close); ``--out`` appends them to a file.
Set-up times here share one process, so they are not ``setup_s``.
"""

import argparse
import json
import sys
import time


def quarters(run: dict) -> dict:
    from . import stats
    t0, t1 = run["t0"], run["t1"]
    span = (t1 - t0) / 4
    out = []
    for q in range(4):
        a, b = t0 + q * span, t0 + (q + 1) * span
        out.append(stats.percentile([r["first"] - r["due"]
                                     for r in run["requests"]
                                     if a <= r["due"] < b
                                     and r["first"] is not None], 95))
    waiting = sum(r["due"] <= t1 and (r["first"] is None or r["first"] > t1)
                  for r in run["requests"])
    return {"ttft_p95_s_by_quarter": out, "waiting_at_close": waiting}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--which", default="program")
    ap.add_argument("--rate", type=float)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    from . import spec
    from .run import run_cell
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    cell = spec.cell(args.workload)
    if args.rate:
        cell["traffic"]["arrivals"]["rate_per_s"] = args.rate
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.monotonic()
        result, checks, run = run_cell(cell, seed, args.seconds,
                                       bool(args.trace), which=args.which,
                                       t_start=t)
        line = {"workload": args.workload, "seed": seed,
                "which": args.which, "rate": args.rate,
                "seconds": args.seconds, **result, "notes": run["notes"]}
        if cell["traffic"]["kind"] == "open_loop":
            line["notes"].update(quarters(run))
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
