"""95th percentile, over every request due in the window, of the time from
when it was due to when its first token reached the client."""

from .. import stats

NAME, UNIT = "ttft_p95_ms", "ms"


def read(run):
    v = stats.percentile(stats.ttfts(run["requests"]), 95)
    return None if v is None else v * 1e3
