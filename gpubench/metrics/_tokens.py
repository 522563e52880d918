"""Shared reading of a run's tokens inside the traced slice (not a
metric: it has no ``NAME``)."""


def decode_tokens(run, inside=None):
    """``(prompt length, index)`` of every output token after the first
    (each from one decode step) whose arrival ``inside(t)`` holds (default:
    in the traced slice). The step that made token ``j`` attended ``prompt
    + j`` keys."""
    inside = inside or in_slice(run)
    for r in run["requests"]:
        p = len(r["prompt"])
        for j, t in enumerate(r["times"]):
            if j >= 1 and inside(t):
                yield p, j


def prefilled(run, inside):
    """Prompt lengths of the requests whose first token's arrival
    ``inside(t)`` holds."""
    return [len(r["prompt"]) for r in run["requests"]
            if r["first"] is not None and inside(r["first"])]


def in_slice(run):
    a, b = run["slice"]
    return lambda t: a <= t <= b


def untraced(run):
    """Inside the window and outside the traced slice, and that span's
    seconds: the profiler's own cost stays out of what is read there."""
    a, b = run["slice"]
    t0, t1 = run["t0"], run["t1"]
    return (lambda t: t0 <= t < a or b < t <= t1), (t1 - t0) - (b - a)


def delta(run, key, edges=("begin", "end")):
    """A counter's change between two of the entry's snapshots (``open``,
    ``begin``, ``end``, ``close``)."""
    c0, c1 = (run["counters"].get(e, {}) for e in edges)
    if key not in c0 or key not in c1:
        return None
    return c1[key] - c0[key]
