"""Output tokens that reached the client inside the window, per second of
the window (for whole calls, the window ends with the last call)."""

from .. import stats

NAME, UNIT = "output_tok_s", "tokens/s"


def read(run):
    times = [t for r in run["requests"] for t in r["times"]]
    return stats.rate(times, run["t0"], run["t1"])
