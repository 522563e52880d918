"""The one traffic generator. A mix is a data file (``traffic/<name>.json``)
of lengths, sharing and arrivals; this module turns it and a seed into
requests.

The sizes (lengths, shared-prefix picks, gaps between arrivals) are drawn
from the mix's own ``base_seed``, so every run seed serves the same
multiset of sizes; the run seed orders them and draws every token id. That
keeps the work of a run fixed while the inputs change with the seed.

Kinds of mix:

- ``open_loop``: requests due on a schedule (``arrivals``), whether or not
  earlier ones have finished; ``ceil(rate * seconds)`` of them, the gaps
  scaled so that all of them fall due inside the window;
- ``backlog``: ``requests`` requests with no due time, sent as fast as the
  entry takes them;
- ``calls``: ``calls`` batches of ``batch`` prompts of ``prompt_len``
  tokens, each to get ``new_tokens`` tokens.
"""

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class Request:
    prompt: np.ndarray          # int64 token ids
    max_new: int
    due: Optional[float] = None  # seconds after the window opens
    prefix: int = -1             # index of its shared prefix, -1 for none


def rng(seed: int) -> np.random.Generator:
    """A numpy generator for any whole ``seed`` (negative and over 64 bits
    too)."""
    return np.random.default_rng(int(seed) % 2 ** 64)


def sizes(gen: np.random.Generator, spec: dict, n: int) -> np.ndarray:
    """``n`` whole sizes from a length spec: ``lognormal`` (``median``,
    ``sigma``), ``uniform`` or ``fixed`` (``value``), clipped to ``[min,
    max]``."""
    dist = spec["dist"]
    if dist == "lognormal":
        x = gen.lognormal(math.log(spec["median"]), spec["sigma"], size=n)
    elif dist == "uniform":
        x = gen.integers(spec["min"], spec["max"], size=n, endpoint=True)
    elif dist == "fixed":
        x = np.full(n, spec["value"])
    else:
        raise ValueError(f"length dist {dist!r}: lognormal, uniform, fixed")
    lo, hi = spec.get("min", 1), spec.get("max", np.inf)
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def gaps(gen: np.random.Generator, spec: dict, n: int) -> np.ndarray:
    """``n`` gaps between arrivals (seconds): ``poisson`` or ``gamma`` (with
    coefficient of variation ``cv``) at ``rate_per_s``."""
    rate = spec["rate_per_s"]
    if spec["process"] == "poisson":
        return gen.exponential(1.0 / rate, size=n)
    if spec["process"] == "gamma":
        shape = 1.0 / spec["cv"] ** 2
        return gen.gamma(shape, 1.0 / (rate * shape), size=n)
    raise ValueError(f"arrival process {spec['process']!r}: poisson, gamma")


def picks(gen: np.random.Generator, spec: dict, count: int,
          n: int) -> np.ndarray:
    """``n`` indices into ``count`` shared prefixes: ``zipf`` with exponent
    ``s`` over ranks 1..count, or ``uniform``."""
    if spec["dist"] == "zipf":
        w = np.arange(1, count + 1, dtype=np.float64) ** -spec["s"]
    elif spec["dist"] == "uniform":
        w = np.ones(count)
    else:
        raise ValueError(f"pick dist {spec['dist']!r}: zipf, uniform")
    return gen.choice(count, size=n, p=w / w.sum())


def count(traffic: dict, seconds: float) -> int:
    """How many requests (or calls) a run of ``seconds`` draws."""
    kind = traffic["kind"]
    if kind == "open_loop":
        return math.ceil(traffic["arrivals"]["rate_per_s"] * seconds)
    return traffic["requests" if kind == "backlog" else "calls"]


def requests(traffic: dict, seed: int, vocab: int,
             seconds: float) -> List[Request]:
    """The run's requests, in the order they are sent."""
    kind = traffic["kind"]
    n = count(traffic, seconds)
    base, run = rng(traffic["base_seed"]), rng(seed)
    if kind == "calls":
        b, t = traffic["batch"], traffic["prompt_len"]
        ids = run.integers(0, vocab, size=(n * b, t))
        return [Request(ids[i], traffic["new_tokens"]) for i in range(n * b)]
    shared = traffic.get("shared_prefix")
    prefix_len = (sizes(base, shared["length"], shared["count"])
                  if shared else None)
    which = (picks(base, shared["pick"], shared["count"], n) if shared
             else np.full(n, -1))
    own = sizes(base, traffic["prompt"], n)
    out = sizes(base, traffic["output"], n)
    due = None
    if kind == "open_loop":
        g = gaps(base, traffic["arrivals"], n)
        g = run.permutation(g) * (seconds / g.sum())
        due = np.concatenate([[0.0], np.cumsum(g)[:-1]])
    elif kind != "backlog":
        raise ValueError(f"traffic kind {kind!r}: open_loop, backlog, calls")
    order = run.permutation(n)
    which, own, out = which[order], own[order], out[order]
    prefixes = ([run.integers(0, vocab, size=int(k)) for k in prefix_len]
                if shared else [])
    reqs = []
    for i in range(n):
        body = run.integers(0, vocab, size=int(own[i]))
        if which[i] >= 0:
            body = np.concatenate([prefixes[which[i]], body])
        reqs.append(Request(body.astype(np.int64), int(out[i]),
                            None if due is None else float(due[i]),
                            int(which[i])))
    return reqs


def prefix_lengths(traffic: dict) -> np.ndarray:
    """The lengths of the mix's shared prefixes (fixed by ``base_seed``)."""
    shared = traffic["shared_prefix"]
    return sizes(rng(traffic["base_seed"]), shared["length"], shared["count"])


def longest(traffic: dict) -> int:
    """The most tokens (prompt and output) one request of the mix holds."""
    if traffic["kind"] == "calls":
        return traffic["prompt_len"] + traffic["new_tokens"]
    pre = traffic.get("shared_prefix")
    pre_max = pre["length"]["max"] if pre else 0
    return pre_max + traffic["prompt"]["max"] + traffic["output"]["max"]
