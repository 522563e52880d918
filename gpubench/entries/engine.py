"""The serving entry: ``ContinuousBatchEngine.submit`` and ``stream``.

One thread plays client and server, as a one-process server does: it
submits each request when due (``open_loop``) or keeps the waiting room
``depth`` requests deep beyond the lanes (``backlog``), and pulls tokens
from ``stream()``, stamping each when the client gets it. The generator is
asked for due requests between tokens; a request that fell due while the
engine worked is submitted late, and its time counts from when it was due.

Set-up: the model and the engine; one request per prefill bucket the mix
can reach, whose decode ticks capture the graph; a mix's shared prefixes
(its system prompts) prefilled once, so the radix cache holds them as a
running service's does; for a backlog, the first fill of every lane.
"""

import gc
import time
from collections import deque

import torch
from torch.profiler import record_function

from .. import program, traffic as T

clock = time.monotonic


class Entry:
    def __init__(self, cell, seed, seconds, device, which="program"):
        self.cfg, self.mix = cell["config"], cell["traffic"]
        self.seed, self.seconds = seed, seconds
        self.device, self.which = device, which
        self.recs = {}
        self.gen = None
        self.open = 0            # submitted and not yet finished
        self.traced = False      # inside the traced slice

    # -- set-up -------------------------------------------------------------
    def setup(self):
        from vyomai_tpu_torch import ContinuousBatchEngine
        cfg, mix = self.cfg, self.mix
        e = cfg["engine"]
        t = clock()
        self.model = program.build_model(cfg, self.seed, self.device,
                                         self.which)
        self.phases = {"model": clock() - t}
        bs = e["block_size"]
        maxb = -(-T.longest(mix) // bs) + 1
        self.lanes = e["max_batch"]
        self.engine = ContinuousBatchEngine(
            self.model, num_blocks=self.lanes * maxb, block_size=bs,
            max_batch=self.lanes, max_blocks_per_seq=maxb,
            max_new_tokens=mix["output"]["max"], eos_token_id=-1,
            prefill_buckets=e["prefill_buckets"],
            dtype=program.pool_dtype(cfg, self.which),
            decode_horizon=e["decode_horizon"],
            prefill_group=e["prefill_group"],
            radix_cache=e["radix_cache"],
            max_prefill_per_tick=e["max_prefill_per_tick"],
            device=self.device)
        self.reqs = deque(T.requests(mix, self.seed, cfg["vocab_size"],
                                     self.seconds))
        self.phases["engine"] = clock() - t - self.phases["model"]
        self._warm()
        self.phases["warm"] = clock() - t - sum(self.phases.values())
        if mix["kind"] == "backlog":
            self._top_up()
            while sum(r["first"] is not None for r in self.recs.values()) \
                    < self.lanes:
                self._pull()
            self.phases["fill"] = clock() - t - sum(self.phases.values())

    def _warm(self):
        """One request per bucket up to the longest prompt of the mix, each
        long enough for chained ticks; their tokens are not recorded."""
        e = self.cfg["engine"]
        gen = T.rng(self.seed + 0x5EED)
        longest = max(T.longest(self.mix) - self.mix["output"]["max"], 1)
        for b in e["prefill_buckets"]:
            self.engine.submit(gen.integers(0, self.cfg["vocab_size"], b),
                               max_new_tokens=min(
                                   2 * e["decode_horizon"] + 1,
                                   self.mix["output"]["max"]))
            if b >= longest:
                break
        for _ in self.engine.stream():
            pass
        if self.mix.get("shared_prefix"):
            lengths = T.prefix_lengths(self.mix)
            first = {}
            for r in self.reqs:
                first.setdefault(r.prefix, r.prompt[:lengths[r.prefix]])
            for k in sorted(first):
                self.engine.submit(first[k], max_new_tokens=1)
            for _ in self.engine.stream():
                pass

    # -- the client ---------------------------------------------------------
    def _submit(self, req, due):
        now = clock()
        sid = self.engine.submit(req.prompt, max_new_tokens=req.max_new)
        self.recs[sid] = {"prompt": req.prompt, "max_new": req.max_new,
                          "due": now if due is None else due, "submit": now,
                          "first": None, "last": None, "done": None, "n": 0,
                          "tokens": [], "times": [], "prefix": req.prefix}
        self.open += 1

    def _top_up(self):
        while self.open < self.lanes + self.mix["depth"]:
            if not self.reqs:
                raise RuntimeError("backlog mix ran out of requests; raise "
                                   "its 'requests'")
            self._submit(self.reqs.popleft(), None)

    def _pull(self) -> bool:
        """One token from the stream; False when it has drained."""
        if self.gen is None:
            self.gen = self.engine.stream()
        if self.traced:
            with record_function("engine.stream"):
                item = next(self.gen, None)
        else:
            item = next(self.gen, None)
        if item is None:
            self.gen = None
            return False
        sid, tok, fin = item
        t = clock()
        r = self.recs.get(sid)
        if r is None:
            return True
        if r["first"] is None:
            r["first"] = t
        r["last"] = t
        r["n"] += 1
        r["tokens"].append(tok)
        r["times"].append(t)
        if fin:
            r["done"] = t
            self.open -= 1
        return True

    def window(self, tracer):
        eng = self.engine
        snaps = {}

        def edge(name):
            snaps[name] = (clock(), dict(eng.counters))
            if name in ("begin", "end"):
                self.traced = name == "begin"
        tracer.hooks.append(edge)
        t0 = clock()
        edge("open")
        t1 = t0 + self.seconds
        tracer.start += t0
        tracer.stop += t0
        backlog = self.mix["kind"] == "backlog"
        due = deque((t0 + r.due, r) for r in self.reqs) if not backlog \
            else deque()
        if not backlog:
            self.reqs.clear()
        lag = 0.0
        while True:
            now = clock()
            tracer.poll(now)
            if backlog:
                if now >= t1:
                    break
                self._top_up()
            else:
                while due and due[0][0] <= now:
                    at, req = due.popleft()
                    lag = max(lag, now - at)
                    self._submit(req, at)
                if not due and (self.open == 0 or now > t1 + 120.0):
                    break
            if not self._pull() and due:
                time.sleep(max(0.0, min(due[0][0] - clock(), 0.005)))
        tracer.end()
        edge("close")
        # every recorded request is the window's: warm-up requests go to
        # the engine unrecorded, and a backlog's first fill feeds the window
        reqs = [dict(r, id=i) for i, r in sorted(self.recs.items())]
        # a backlog's requests still in flight at the close are not due;
        # an open loop's are all due in the window, and drained after it
        failed = 0 if backlog else sum(r["done"] is None for r in reqs)
        sl = None
        if "begin" in snaps and "end" in snaps:
            sl = (snaps["begin"][0], snaps["end"][0])
        return {"t0": t0, "t1": t1, "requests": reqs, "lag_s": lag,
                "attempted": len(reqs), "failed": failed, "slice": sl,
                "counters": {k: v[1] for k, v in snaps.items()},
                "setup_phases_s": self.phases,
                "lanes": self.lanes, "block_size": self.cfg["engine"][
                    "block_size"], "pool": program.precision(
                        self.cfg, self.which)["pool"]["dtype"]}

    def close(self):
        if self.device != "cpu" and torch.cuda.is_available():
            torch.cuda.synchronize()
        self.gen = None
        self.engine = self.model = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

