"""The generation entry: ``generate_hf`` over the static KV cache, greedy,
in back-to-back calls of one batch each. A call's tokens reach the client
when it returns. The window is whole calls: they run until ``seconds``
have passed, and the last one ends the window. Set-up makes the model and
runs one call on a batch of its own."""

import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from .. import program, traffic as T

clock = time.monotonic


class Entry:
    def __init__(self, cell, seed, seconds, device, which="program"):
        self.cfg, self.mix = cell["config"], cell["traffic"]
        self.seed, self.seconds = seed, seconds
        self.device, self.which = device, which

    def setup(self):
        from vyomai_tpu_torch import generate_hf
        self.generate_hf = generate_hf
        mix = self.mix
        t = clock()
        self.model = program.build_model(self.cfg, self.seed, self.device,
                                         self.which)
        self.phases = {"model": clock() - t}
        b = mix["batch"]
        reqs = T.requests(mix, self.seed, self.cfg["vocab_size"],
                          self.seconds)
        ids = np.stack([r.prompt for r in reqs]).reshape(
            mix["calls"], b, mix["prompt_len"])
        self.batches = torch.as_tensor(ids, dtype=torch.int32,
                                       device=self.device)
        warm = T.rng(self.seed + 0x5EED).integers(
            0, self.cfg["vocab_size"], (b, mix["prompt_len"]))
        self._call(torch.as_tensor(warm, dtype=torch.int32,
                                   device=self.device))
        self.phases["warm"] = clock() - t - self.phases["model"]

    def _call(self, ids):
        out = self.generate_hf(self.model, ids,
                               max_new_tokens=self.mix["new_tokens"],
                               eos_token_id=-1,
                               pad_token_id=self.cfg["pad_token_id"])
        return out.cpu().numpy()

    def window(self, tracer):
        mix = self.mix
        p = mix["prompt_len"]
        reqs, calls = [], []
        t0 = clock()
        i = 0
        while True:
            if i == min(1, mix["calls"] - 1):
                tracer.begin()
            ids = self.batches[i % mix["calls"]]
            start = clock()
            with record_function("generate_hf"):
                out = self._call(ids)
            end = clock()
            if tracer.active:
                tracer.end()
                traced = len(calls)
            calls.append((start, end))
            prompts = ids.cpu().numpy()
            for row in range(out.shape[0]):
                toks = out[row, p:].astype(np.int64).tolist()
                reqs.append({"id": len(reqs), "prompt": prompts[row].astype(
                    np.int64), "max_new": mix["new_tokens"], "due": start,
                    "submit": start, "first": end, "last": end,
                    "done": end, "n": len(toks), "tokens": toks,
                    "times": [end] * len(toks), "prefix": -1})
            i += 1
            if end - t0 >= self.seconds and (not tracer.enabled
                                             or tracer.done):
                break
        sl = calls[traced] if tracer.enabled else None
        return {"t0": t0, "t1": calls[-1][1], "requests": reqs, "lag_s": 0.0,
                "attempted": len(reqs), "failed": 0, "slice": sl,
                "calls": calls, "setup_phases_s": self.phases,
                "batch": mix["batch"], "prompt_len": p,
                "new_tokens": mix["new_tokens"]}

    def close(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.model = self.batches = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
