"""95th percentile, over the window's requests with two or more output
tokens, of (last token's arrival - first token's) / (tokens - 1)."""

from .. import stats

NAME, UNIT = "tpot_p95_ms", "ms"


def read(run):
    v = stats.percentile(stats.tpots(run["requests"]), 95)
    return None if v is None else v * 1e3
