"""Statistics over a run's whole record: every request, the whole window."""

from typing import Dict, List, Optional, Sequence

import numpy as np


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile (linear between order statistics), None for
    no values."""
    if not len(values):
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def ttfts(reqs: List[dict]) -> List[float]:
    """Seconds from due to first token, of every request that got one."""
    return [r["first"] - r["due"] for r in reqs if r["first"] is not None]


def tpots(reqs: List[dict]) -> List[float]:
    """Seconds per token after the first, of every request with two or
    more tokens: (last arrival - first arrival) / (tokens - 1)."""
    return [(r["last"] - r["first"]) / (r["n"] - 1) for r in reqs
            if r["n"] >= 2]


def rate(token_times: Sequence[float], t0: float, t1: float) -> float:
    """Tokens that arrived in ``[t0, t1]``, per second of it."""
    t = np.asarray(token_times, dtype=np.float64)
    return float(((t >= t0) & (t <= t1)).sum()) / (t1 - t0)


def summary(values: Sequence[float]) -> Dict[str, float]:
    v = np.asarray(values, dtype=np.float64)
    return {"n": int(v.size), "p50": percentile(v, 50),
            "p95": percentile(v, 95), "max": float(v.max()) if v.size
            else None}
