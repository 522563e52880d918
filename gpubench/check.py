"""How ``correct`` is decided.

Once the window has closed, a sample drawn from the seed of the requests
that finished is compared with the plain float32 reference
(``reference/``): the reference runs once over each sampled prompt with
its served tokens, and at each served token reads the gap by which that
token's logit lies below the reference's best (0 where it is the best).
The sample is the longest finished request, all its tokens, and up to
``SAMPLE_MOST - 1`` others, each with its first ``SAMPLE_FIRST`` served
tokens. Greedy decoding of random weights falls into loops, so the later
tokens of one request repeat one context and say little more; the first
tokens of many requests are many independent contexts, through the
prefill (and the radix cache) and the first decode ticks.

Two numbers are compared: the widest gap over every token read, and the
mean gap, a mean over the sampled requests of each one's mean over its
first ``SAMPLE_FIRST`` served tokens (so the long request's loop, which
repeats one near-tie many times over, weighs as one request). A cell whose
limits name ``late_mean_logit_gap`` (one whose layers work at long
contexts) has every sampled request read whole, and compares a third
number: the same mean over each one's last ``SAMPLE_FIRST`` served tokens,
the decode steps at its longest context. Every finished request must also
have all the tokens it asked for, each inside the vocabulary, and every
request due in the window must have finished.
"""

from typing import Dict, List, Tuple

import numpy as np

from . import traffic as T

SAMPLE_MOST = 96        # requests in the sample, the longest among them
SAMPLE_FIRST = 24       # served tokens read of each but the longest


def sample(run: dict, seed: int, whole: bool = False
           ) -> List[Tuple[int, int]]:
    """``(request id, served tokens to read)`` of the sampled requests:
    the first ``SAMPLE_FIRST`` of each but the longest, or all of them
    (``whole``)."""
    done = [r for r in run["requests"] if r["done"] is not None]
    if not done:
        return []
    longest = max(done, key=lambda r: (r["n"], -r["id"]))
    picks = [(longest["id"], longest["n"])]
    for i in T.rng(seed + 0xC4EC).permutation(len(done)):
        if len(picks) >= SAMPLE_MOST:
            break
        r = done[i]
        if r["id"] != longest["id"]:
            picks.append((r["id"], r["n"] if whole
                          else min(r["n"], SAMPLE_FIRST)))
    return picks


def served(run: dict, picks) -> list:
    """``(prompt + the served tokens read, prompt length)`` of each pick."""
    by_id = {r["id"]: r for r in run["requests"]}
    return [(np.concatenate([by_id[i]["prompt"],
                             np.asarray(by_id[i]["tokens"][:n], np.int64)]),
             len(by_id[i]["prompt"])) for i, n in picks]


def judge(run: dict, vocab: int, gaps, limits: dict) -> Dict[str, dict]:
    """Each number compared, with its limit (None where no limit is set
    yet, which fails)."""
    done = [r for r in run["requests"] if r["done"] is not None]
    short = sum(r["n"] != r["max_new"] for r in done)
    outside = sum(int(not all(0 <= t < vocab for t in r["tokens"]))
                  for r in run["requests"])
    gaps = [g for g in gaps if g.size]
    widest = max((float(g.max()) for g in gaps), default=None)
    mean = (float(np.mean([g[:SAMPLE_FIRST].mean() for g in gaps]))
            if gaps else None)
    out = {
        "unfinished": {"value": run["failed"], "limit": 0},
        "wrong_length": {"value": short, "limit": 0},
        "outside_vocab": {"value": outside, "limit": 0},
        "sampled_tokens": {"value": int(sum(g.size for g in gaps)),
                           "limit": 1, "at_least": True},
        "max_logit_gap": {"value": widest,
                          "limit": limits.get("max_logit_gap")},
        "mean_logit_gap": {"value": mean,
                           "limit": limits.get("mean_logit_gap")},
    }
    if reads_whole(limits):
        late = (float(np.mean([g[-SAMPLE_FIRST:].mean() for g in gaps]))
                if gaps else None)
        out["late_mean_logit_gap"] = {
            "value": late, "limit": limits["late_mean_logit_gap"]}
    return out


def reads_whole(limits: dict) -> bool:
    """Whether the cell reads its sampled requests whole, for the late
    mean gap."""
    return "late_mean_logit_gap" in limits


def passed(checks: Dict[str, dict]) -> bool:
    for c in checks.values():
        v, lim = c["value"], c["limit"]
        if v is None or lim is None:
            return False
        if (v < lim) if c.get("at_least") else (v > lim):
            return False
    return True
