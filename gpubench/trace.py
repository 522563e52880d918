"""A ``torch.profiler`` trace of a slice of the window, reduced to what the
per-layer metrics read: the device's busy intervals, each kernel's time and
the runtime call that launched it, and a breakdown of device time and of
idle time by what the host was doing.

The slice is marked by a ``gpubench.slice`` annotation; everything is
clipped to it. Busy time is the union of kernel, memcpy and memset
intervals on the device.
"""

import bisect
import json
import os
import re
import tempfile
from collections import defaultdict
from typing import Dict, Optional

import torch

SLICE = "gpubench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
GAPS_LABELLED = 20000   # the longest idle gaps, labelled by the host's work


class Tracer:
    """Profiles ``[start, end)`` of the host clock, or what :meth:`begin`
    and :meth:`end` enclose; :meth:`reduce`, after the window, reads the
    trace into ``result``. Disabled, every call does nothing."""

    def __init__(self, enabled: bool, start: float = 0.0, end: float = 0.0):
        self.enabled = enabled
        self.start, self.stop = start, end
        self.prof = self.mark = None
        self.done = False
        self.result: Optional[dict] = None
        self.hooks = []          # called with "begin"/"end" at the edges

    def poll(self, now: float):
        if not self.enabled or self.done:
            return
        if self.prof is None and now >= self.start:
            self.begin()
        elif self.prof is not None and now >= self.stop:
            self.end()

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.done

    def begin(self):
        if not self.enabled or self.prof is not None or self.done:
            return
        act = torch.profiler.ProfilerActivity
        acts = [act.CPU] + ([act.CUDA] if torch.cuda.is_available() else [])
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.mark = torch.profiler.record_function(SLICE)
        self.mark.__enter__()
        for hook in self.hooks:
            hook("begin")

    def end(self):
        if not self.active:
            return
        for hook in self.hooks:
            hook("end")
        self.mark.__exit__(None, None, None)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        self.done = True

    def reduce(self):
        """Export the trace and read it (outside the window: it takes tens
        of seconds)."""
        if not self.done or self.result is not None:
            return
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            self.result = reduce(path)
        self.prof = None


def short(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters."""
    name = re.sub(r"^void ", "", name)
    name = name.split("(")[0]
    return name.split("<")[0][:96]


def _merge(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(path: str) -> dict:
    """Read a Chrome trace: the slice ``(s0, s1)`` (seconds, trace clock),
    ``kernels`` as ``(name, start, end, launcher, correlation)`` clipped to
    it, ``busy_s``, ``window_s`` and ``breakdown``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    s0 = s1 = None
    main_tid = None
    for e in events:
        if e.get("ph") == "X" and e.get("name") == SLICE and \
                e.get("cat") == "user_annotation":
            s0, s1 = e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6
            main_tid = (e.get("pid"), e.get("tid"))
    if s0 is None:
        raise RuntimeError("trace has no slice annotation")
    launcher = {}
    device, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            a, b = e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6
            if b > s0 and a < s1:
                device.append((e["name"], max(a, s0), min(b, s1), cat,
                               (e.get("args") or {}).get("correlation")))
        elif cat in HOST_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                launcher[corr] = e["name"]
            if (e.get("pid"), e.get("tid")) == main_tid and e["name"] != SLICE:
                host.append((e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0))
                             * 1e-6, e["name"]))
    kernels = [(n, a, b, launcher.get(c, ""), c)
               for n, a, b, cat, c in device if cat == "kernel"]
    busy = _merge([[a, b] for _, a, b, _, _ in device])
    busy_s = sum(b - a for a, b in busy)
    by_op: Dict[str, float] = defaultdict(float)
    for n, a, b, cat, _ in device:
        by_op[short(n) if cat == "kernel" else n] += b - a
    gaps = []
    edges = [s0] + [x for iv in busy for x in iv] + [s1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((b - a, a, b))
    gaps.sort(reverse=True)
    host.sort()
    starts = [h[0] for h in host]
    by_host: Dict[str, float] = defaultdict(float)
    for dur, a, b in gaps[:GAPS_LABELLED]:
        by_host[_host_at(host, starts, (a + b) / 2)] += dur
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:10]]
    return {"slice": (s0, s1), "window_s": s1 - s0, "busy_s": busy_s,
            "kernels": kernels,
            "breakdown": {"device_ops": top(by_op),
                          "idle_gaps": top(by_host)}}


def _host_at(host, starts, t: float) -> str:
    """The innermost host event of the main thread that spans ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 1000, -1), -1):
        a, b, name = host[j]
        if b >= t:
            return name[:96]
    return "(host Python, between profiled ops)"


def kernel_seconds(trace: dict, names) -> float:
    """Device seconds of the kernels whose name holds one of ``names``."""
    return sum(b - a for n, a, b, _, _ in trace["kernels"]
               if any(k in n for k in names))


def idle_share(trace: dict) -> Optional[float]:
    if not trace["kernels"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
