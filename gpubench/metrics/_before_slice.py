"""The engine's span-edge counters read over a traced run's window from
its opening to the start of the profiled slice (not a metric: it has no
``NAME``). The counters are always on, and before the slice neither
``record_function`` nor the profiler's tracing of each launch slows the
host, so the host times they hold are the program's own. Inside the slice
a tick's graph launches alone hold the host for tens of milliseconds;
after it, the requests that fell due while the profiler stopped arrive at
once, and an open loop's queue waits for seconds."""

from ._tokens import delta as _delta


def delta(run, key):
    """``key``'s change from the window's opening to the slice's start;
    None where a snapshot lacks it."""
    return _delta(run, key, ("open", "begin"))


def seconds(run) -> float:
    """Host-clock seconds from the window's opening to the slice's
    start."""
    return run["slice"][0] - run["t0"]
