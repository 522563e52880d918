"""Continuous-batching serving engine (counterpart of
``vyomai_tpu.serving.engine.ContinuousBatchEngine``, plain path).

Host-side scheduler (waiting room, block-budget admission, radix prefix
match, preemption, finished harvest) around the paged model steps:

- prefill: up to ``prefill_group`` admissions per call, each suffix padded
  to the group's bucket; suffixes longer than the largest bucket are
  chunked across calls;
- decode: all active sequences in one ``max_batch``-wide batch (dead lanes
  masked), up to ``decode_horizon`` tokens per tick, each tick one
  ``paged_model.HorizonGraph``: on the card, replays of one captured CUDA
  graph of the decode step; on the CPU, the same step run eagerly.

Ticks are pipelined (``pipeline_decode=True``, the JAX default): while a
tick is in flight the next one is dispatched from its device carry (final
tokens and eos flags) before the first is read back, whenever the batch is
unchanged and every lane can take another step (``_try_chain``); otherwise
the tick is read back at once and the next one is scheduled from the host
(``pipeline_decode=False`` always does that). A tick's inputs go up from
pinned staging buffers and its tokens come back into one, behind an event,
so neither copy waits for a tick in flight. Greedy by default;
``do_sample`` draws with engine-wide temperature/top-p/min-p from a seeded
``torch.Generator``.
"""

import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import paged_model
from .kv_manager import PagedKVManager, SequenceState
from ..generation.sampling import normalize_eos

# engine features of the JAX package that this port does not run yet
_UNPORTED_ENGINE_ARGS = (
    "draft_model", "draft_params", "draft_plus_one", "gamma", "spec_rounds",
    "ngram_speculation", "medusa_params", "fsms", "loras",
    "presence_penalty", "frequency_penalty", "repetition_penalty",
    "return_logprobs", "mesh", "position_offset", "kv_backend",
    "plus_one", "cache_aware_admission")
_UNPORTED_SUBMIT_ARGS = (
    "temperature", "top_p", "min_p", "presence_penalty", "frequency_penalty",
    "repetition_penalty", "min_tokens", "ignore_eos", "logit_bias", "seed",
    "fsm_id", "lora_id", "stop", "best_of", "prefix_embeds", "prefix_lm",
    "media_key")


def _reject(unsupported: dict, ported: tuple, where: str):
    for name in unsupported:
        if name in ported:
            raise NotImplementedError(
                f"{where}({name}=...) is not ported to PyTorch yet")
        raise TypeError(f"{where}() got an unexpected keyword argument "
                        f"{name!r}")


def check_card_config(cfg):
    """Raise ``NotImplementedError`` for a config whose attention the
    card's kernels do not take yet: a GQA group above 8 (K4) or a head_dim
    other than 64 and 128 (K1 and K4). The plain path on the CPU serves
    both, so the engine checks only where it runs on a CUDA device."""
    group = cfg.num_attention_heads // cfg.num_key_value_heads
    if group > 8:
        raise NotImplementedError(
            f"GQA group {group}: the K4 group > 8 variant (paged decode) is "
            "not ported to the card yet")
    if cfg.head_dim not in (64, 128):
        raise NotImplementedError(
            f"head_dim {cfg.head_dim}: the K1/K4 D={cfg.head_dim} variants "
            "(flash prefill, paged decode) are not ported to the card yet; "
            "they take D in (64, 128)")


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt suffix of {n} tokens exceeds the largest "
                     f"prefill bucket {buckets[-1]}")


class ContinuousBatchEngine:
    def __init__(self, model, *, num_blocks: int = 256, block_size: int = 16,
                 max_batch: int = 8, max_blocks_per_seq: int = 32,
                 max_new_tokens: int = 128,
                 eos_token_id: Optional[int] = None,
                 prefill_buckets: Sequence[int] = (32, 64, 128, 256, 512),
                 dtype=torch.bfloat16, decode_horizon: int = 8,
                 prefill_group: int = 4, do_sample: bool = False,
                 temperature: float = 1.0, top_p: float = 1.0,
                 min_p: float = 0.0, seed: int = 0,
                 radix_cache: bool = True,
                 max_prefill_per_tick: Optional[int] = 4,
                 pipeline_decode: bool = True, device=None, **unsupported):
        """``model``: a ``models.qwen.ModelForCausalLM`` on ``device``
        (default: the model's device), float or quantized
        (``quant.quantize_model``). ``dtype`` is the pool's storage dtype:
        a float dtype, ``torch.int8`` or ``"int4"`` (quantized pools,
        ``paged_model.init_pool``). ``radix_cache=False`` disables prefix
        caching.
        ``max_prefill_per_tick`` caps prefill calls per tick while
        sequences are decoding (None = drain all prefills first).
        ``pipeline_decode=False`` reads every decode tick back before the
        next one is scheduled."""
        _reject(unsupported, _UNPORTED_ENGINE_ARGS, "ContinuousBatchEngine")
        # normalised through a tensor: "cuda" and "cuda:0" name one device
        self.device = torch.empty(0, device=device if device is not None
                                  else model.device).device
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine device "
                             f"is {self.device}")
        if self.device.type == "cuda":
            check_card_config(model.config)
        self.model = model
        self.cfg = model.config
        self.kv = PagedKVManager(num_blocks, block_size)
        self.block_size = block_size
        self.max_batch = max_batch
        self.max_blocks_per_seq = max_blocks_per_seq
        self.max_new_tokens = max_new_tokens
        self.eos_token_id, self.eos_ids = normalize_eos(
            eos_token_id if eos_token_id is not None
            else getattr(self.cfg, "eos_token_id", None))
        self.prefill_buckets = tuple(prefill_buckets)
        self.decode_horizon = max(1, decode_horizon)
        self.prefill_group = max(1, prefill_group)
        self.max_prefill_per_tick = (None if max_prefill_per_tick is None
                                     else max(1, max_prefill_per_tick))
        self.do_sample = do_sample
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.min_p = float(min_p)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.radix_cache = bool(radix_cache)
        self.pipeline_decode = bool(pipeline_decode)
        self._sampling = paged_model.sampling_tensors(
            self.device, self.temperature, self.top_p, self.min_p)
        self._graph = None        # the decode tick, built at the first one
        self._stages = []         # its two sets of staging buffers
        self._inflight = None
        self.pool = paged_model.init_pool(self.cfg, num_blocks, block_size,
                                          dtype=dtype, device=self.device)
        self.waiting: deque = deque()
        self.active: Dict[int, SequenceState] = {}
        self.needs_prefill: deque = deque()
        self.finished: Dict[int, SequenceState] = {}
        self._next_id = 0
        self.counters = {
            "requests_submitted": 0, "requests_completed": 0,
            "prompt_tokens": 0, "cached_prompt_tokens": 0,
            "tokens_generated": 0, "prefill_calls": 0,
            "decode_ticks": 0, "chained_ticks": 0, "preemptions": 0,
        }
        self._ttft: List[float] = []
        self._t_start = time.monotonic()

    def _put(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(self.device)

    # -- API ------------------------------------------------------------------
    def submit(self, prompt: Sequence[int], *,
               max_new_tokens: Optional[int] = None, **unsupported) -> int:
        """Queue a request; returns its id. ``max_new_tokens`` may lower
        (not raise) the engine's limit for this request."""
        _reject(unsupported, _UNPORTED_SUBMIT_ARGS, "submit")
        if not len(prompt):
            raise ValueError("empty prompt (prefill would attend nothing "
                             "and emit an arbitrary first token)")
        if max_new_tokens is not None and \
                not (1 <= max_new_tokens <= self.max_new_tokens):
            raise ValueError(
                f"per-request max_new_tokens={max_new_tokens} outside "
                f"[1, {self.max_new_tokens}] (the engine's limit sizes "
                "pool budgeting)")
        max_pos = self.cfg.max_position_embeddings
        if len(prompt) + self.max_new_tokens > max_pos:
            raise ValueError(
                f"prompt of {len(prompt)} + max_new_tokens "
                f"{self.max_new_tokens} exceeds max_position_embeddings "
                f"{max_pos}")
        sid = self._next_id
        self._next_id += 1
        state = SequenceState(sid, prompt)
        state.no_radix = not self.radix_cache
        state.max_new = (self.max_new_tokens if max_new_tokens is None
                         else max_new_tokens)
        state.t_submit = time.monotonic()
        self.counters["requests_submitted"] += 1
        self.counters["prompt_tokens"] += len(prompt)
        self.waiting.append(state)
        return sid

    def run(self) -> Dict[int, List[int]]:
        """Drain all requests; returns {seq_id: generated tokens} for the
        sequences that finished since the last ``run`` (results are
        consumed)."""
        while self.waiting or self.active or self.needs_prefill:
            self.step()
        done = {sid: s.tokens[s.prompt_len:]
                for sid, s in self.finished.items()}
        self.finished.clear()
        return done

    def abort(self, seq_id: int) -> bool:
        """Cancel a request wherever it is; its blocks are freed at once
        and a decode tick in flight drops the lane at harvest. That tick
        may still write the lane's freed blocks, but every launch is on one
        stream, so whatever reuses them runs after it, and no tick is
        chained once the batch has changed. Returns False if the id is
        unknown or already finished."""
        for q in (self.waiting, self.needs_prefill):
            for state in q:
                if state.seq_id == seq_id:
                    q.remove(state)
                    self.kv.release_sequence(state)
                    return True
        state = self.active.pop(seq_id, None)
        if state is None:
            return False
        state.finished = True
        self.kv.free(state, cache_prefix=not state.no_radix)
        return True

    def metrics(self) -> Dict[str, float]:
        """Running counters plus ``ttft_mean_s``/``ttft_max_s``,
        ``cache_hit_rate``, ``tokens_per_s`` since construction, and the
        device bytes the pool (``pool_bytes``, scales included) and the
        model's weights (``weight_bytes``, quantized buffers included)
        hold."""
        out = dict(self.counters)
        out.update(self.kv.cache_stats())
        out["ttft_mean_s"] = (sum(self._ttft) / len(self._ttft)
                              if self._ttft else 0.0)
        out["ttft_max_s"] = max(self._ttft, default=0.0)
        out["cache_hit_rate"] = (
            self.counters["cached_prompt_tokens"]
            / max(self.counters["prompt_tokens"], 1))
        out["tokens_per_s"] = self.counters["tokens_generated"] / max(
            time.monotonic() - self._t_start, 1e-9)
        out["pool_bytes"] = paged_model.pool_bytes(self.pool)
        out["weight_bytes"] = sum(t.numel() * t.element_size()
                                  for t in self.model.state_dict().values())
        return out

    def stream(self):
        """Drain all requests, yielding ``(seq_id, token_id, finished)``
        after each tick; finished results are consumed as they stream."""
        emitted: Dict[int, int] = {}
        while self.waiting or self.active or self.needs_prefill:
            self.step()
            for src in (self.active, self.finished):
                for sid, s in list(src.items()):
                    start = emitted.get(sid, s.prompt_len)
                    fresh = s.tokens[start:]
                    emitted[sid] = len(s.tokens)
                    for i, tok in enumerate(fresh):
                        yield (sid, int(tok),
                               s.finished and start + i + 1 == len(s.tokens))
            for sid in list(self.finished):
                del self.finished[sid]
                emitted.pop(sid, None)

    # -- scheduling -----------------------------------------------------------
    def _try_admit(self):
        while self.waiting and len(self.active) + len(self.needs_prefill) \
                < self.max_batch:
            state = self.waiting[0]
            budget = len(state.tokens) + 1  # room for the first new token
            if self.kv.blocks_needed(budget) > self.max_blocks_per_seq:
                raise ValueError(
                    f"prompt of {len(state.tokens)} tokens exceeds the "
                    f"per-sequence block table "
                    f"({self.max_blocks_per_seq} x {self.block_size})")
            self.kv.match_prefix(state)
            if not self.kv.allocate(state, budget):
                self.kv.release_sequence(state)  # roll back and wait
                if not self.active and not self.needs_prefill:
                    raise RuntimeError(
                        f"KV pool too small: prompt of {len(state.tokens)} "
                        f"tokens needs {self.kv.blocks_needed(budget)} "
                        f"blocks, pool has {self.kv.num_blocks}")
                break
            self.counters["cached_prompt_tokens"] += state.num_cached_tokens
            self.waiting.popleft()
            self.needs_prefill.append(state)

    def _preempt_youngest(self):
        """Pool exhausted with no decode progress possible: free the most
        recently admitted sequence and requeue it at the head of the
        waiting room (its generated tokens are re-prefilled)."""
        victim = max(self.active.values(), key=lambda s: s.seq_id)
        self.counters["preemptions"] += 1
        self.kv.free(victim, cache_prefix=False)
        self.active.pop(victim.seq_id, None)
        victim.prefill_len = len(victim.tokens)
        victim.num_cached_tokens = 0
        self.waiting.appendleft(victim)

    def _prefill_group_call(self, states):
        """Prefill up to ``prefill_group`` admissions in one call; a suffix
        longer than the largest bucket writes its first chunk and goes back
        to the head of the prefill queue."""
        n_pad = self.prefill_group
        cap = self.prefill_buckets[-1]
        bs = self.block_size
        suffixes = [s.tokens[s.num_cached_tokens:
                             min(s.prefill_len, s.num_cached_tokens + cap)]
                    for s in states]
        t_pad = _bucket(max(len(sf) for sf in suffixes),
                        self.prefill_buckets)
        ids = np.zeros((n_pad, t_pad), dtype=np.int64)
        positions = np.zeros((n_pad, t_pad), dtype=np.int64)
        slot_blocks = np.full((n_pad, t_pad), -1, dtype=np.int32)
        slot_offsets = np.zeros((n_pad, t_pad), dtype=np.int64)
        tables = np.full((n_pad, self.max_blocks_per_seq), -1, dtype=np.int32)
        ctx_len = np.zeros(n_pad, dtype=np.int64)
        true_len = np.zeros(n_pad, dtype=np.int64)
        for i, (state, suffix) in enumerate(zip(states, suffixes)):
            cached, t = state.num_cached_tokens, len(suffix)
            ids[i, :t] = suffix
            positions[i] = np.minimum(cached + np.arange(t_pad),
                                      cached + max(t - 1, 0))
            pos = cached + np.arange(t)
            slot_blocks[i, :t] = np.asarray(state.block_table)[pos // bs]
            slot_offsets[i, :t] = pos % bs
            tables[i, :len(state.block_table)] = state.block_table
            ctx_len[i] = state.prefill_len
            true_len[i] = t
        logits = paged_model.prefill(
            self.model, self.pool, self._put(ids), self._put(positions),
            self._put(slot_blocks), self._put(slot_offsets),
            self._put(tables), self._put(ctx_len), self._put(true_len))
        self.counters["prefill_calls"] += 1
        next_tokens = self._pick_tokens(logits)
        for i, state in enumerate(states):
            if state.num_cached_tokens + len(suffixes[i]) >= state.prefill_len:
                self.active[state.seq_id] = state
                self._append_token(state, int(next_tokens[i]))
            else:  # more chunks to go: KV written, logits discarded
                state.num_cached_tokens += len(suffixes[i])
                self.needs_prefill.appendleft(state)

    def _pick_tokens(self, logits) -> np.ndarray:
        if self.do_sample:
            toks = paged_model.sample_tokens(logits, self.generator,
                                             *self._sampling)
        else:
            toks = torch.argmax(logits, dim=-1)
        return toks.cpu().numpy()

    def _append_token(self, state: SequenceState, tok: int):
        state.tokens.append(tok)
        if len(state.tokens) == state.prompt_len + 1:
            self._ttft.append(time.monotonic() - state.t_submit)
        self.counters["tokens_generated"] += 1
        self._maybe_finish(state)

    def _maybe_finish(self, state: SequenceState):
        new = len(state.tokens) - state.prompt_len
        hit_eos = (self.eos_token_id is not None
                   and state.tokens[-1] in self.eos_ids)
        out_of_blocks = len(state.tokens) >= \
            self.max_blocks_per_seq * self.block_size
        if hit_eos or new >= state.max_new or out_of_blocks:
            state.finished = True
            self.kv.free(state, cache_prefix=not state.no_radix)
            self.active.pop(state.seq_id, None)
            self.counters["requests_completed"] += 1
            self.finished[state.seq_id] = state

    # -- decode ticks ---------------------------------------------------------
    def _decode_batch(self):
        """Plain decode tick, pipelined when safe: the in-flight tick's
        device carry (final tokens and eos flags) feeds the next tick's
        dispatch before the in-flight tick is read back, so the host's
        harvest and bookkeeping overlap the next tick on the card."""
        prev, self._inflight = self._inflight, None
        if prev is not None:
            nxt = self._try_chain(prev)   # dispatched while prev is in flight
            self._harvest_decode(prev)
            if nxt is not None:
                self._inflight = nxt
                return
        rec = self._dispatch_decode()
        if rec is None:
            return
        if rec["chainable"]:
            self._inflight = rec          # harvested next step, overlapped
        else:
            self._harvest_decode(rec)

    def _dispatch_decode(self):
        states = [s for s in self.active.values() if not s.finished]
        if not states:
            return None
        b = self.max_batch
        tokens = np.zeros(b, dtype=np.int32)
        positions = np.zeros(b, dtype=np.int64)
        live_mask = np.zeros(b, dtype=bool)
        budget = np.zeros(b, dtype=np.int32)
        tables = np.full((b, self.max_blocks_per_seq), -1, dtype=np.int32)
        live = []
        for i, state in enumerate(states[:b]):
            pos = len(state.tokens) - 1  # position of the latest token
            # budget the whole horizon up front so slot arithmetic never
            # walks off the block table; cap by table capacity
            remaining = state.max_new - (len(state.tokens) - state.prompt_len)
            cap = self.max_blocks_per_seq * self.block_size - pos
            h = max(min(self.decode_horizon, remaining, cap), 1)
            while h >= 1 and not self.kv.allocate(state, pos + h):
                h //= 2  # pool pressure: shrink the grant
            if h < 1:
                continue  # pool exhausted: retry next tick
            tokens[i] = state.tokens[-1]
            positions[i] = pos
            live_mask[i] = True
            budget[i] = h
            tables[i, :len(state.block_table)] = state.block_table
            live.append((i, state, h))
        if not live:
            self._preempt_youngest()
            return None
        self.counters["decode_ticks"] += 1
        rec = self._launch_tick(positions, tables, live_mask, budget, tokens)
        # chain safety: a chained tick must never write KV into blocks the
        # host frees at the harvest before it. Every finish the device
        # cannot see (a second eos id) rules chaining out; the features of
        # the JAX engine that also do (speculation, FSMs, penalties,
        # min_tokens, logit bias, a window, stop sequences, best_of) are
        # not ported and raise
        rec["chainable"] = self.pipeline_decode and len(self.eos_ids) <= 1
        rec["live"] = live
        return rec

    def _try_chain(self, prev):
        """Dispatch the next tick from the in-flight tick's device carry
        (no host round trip): only when the batch is unchanged and every
        lane can take at least one more step. Returns the new in-flight
        record, or None (the caller harvests and ticks synchronously)."""
        if not prev["chainable"]:
            return None
        states = [s for s in self.active.values() if not s.finished]
        prev_states = [s for _, s, _ in prev["live"]]
        if len(states) != len(prev_states) or \
                any(a is not b for a, b in zip(states, prev_states)):
            return None             # admission/finish changed composition
        b = self.max_batch
        bs = self.block_size
        positions = np.zeros(b, dtype=np.int64)
        live_mask = np.zeros(b, dtype=bool)
        budget = np.zeros(b, dtype=np.int32)
        tables = np.full((b, self.max_blocks_per_seq), -1, dtype=np.int32)
        live = []
        for i, state, h_prev in prev["live"]:
            # the in-flight tick is not harvested yet: a lane still alive
            # emitted its whole grant (an eos'd lane is masked on the card
            # by the carry's eos flags)
            assumed_len = len(state.tokens) + h_prev
            pos1 = assumed_len - 1
            if assumed_len >= self.max_blocks_per_seq * bs:
                # finishes out of blocks at the coming harvest, which frees
                # blocks this tick would still write: drain + sync tick
                return None
            remaining = state.max_new - (assumed_len - state.prompt_len)
            cap1 = self.max_blocks_per_seq * bs - pos1
            h1 = min(self.decode_horizon, remaining, cap1)
            if h1 < 1:
                return None         # someone at a cap: drain + sync tick
            if not self.kv.allocate(state, pos1 + h1):
                return None         # pool pressure: the sync path handles it
            positions[i] = pos1
            live_mask[i] = True
            budget[i] = h1
            tables[i, :len(state.block_table)] = state.block_table
            live.append((i, state, h1))
        self.counters["decode_ticks"] += 1
        self.counters["chained_ticks"] += 1
        rec = self._launch_tick(positions, tables, live_mask, budget)
        rec.update(chainable=True, live=live)
        return rec

    def horizon_graph(self):
        """The decode tick and its two sets of staging buffers (pinned on
        the card), built at the first tick."""
        if self._graph is None:
            b, cuda = self.max_batch, self.device.type == "cuda"
            self._graph = paged_model.HorizonGraph(
                self.model, self.pool, b, self.max_blocks_per_seq,
                self.decode_horizon, do_sample=self.do_sample,
                eos=-1 if self.eos_token_id is None else self.eos_token_id,
                generator=self.generator, samp=self._sampling)

            def host(*shape, dtype):
                return torch.zeros(shape, dtype=dtype, pin_memory=cuda)
            self._stages = [{
                "tokens": host(b, dtype=torch.int32),
                "positions": host(b, dtype=torch.int64),
                "tables": host(b, self.max_blocks_per_seq, dtype=torch.int32),
                "live": host(b, dtype=torch.bool),
                "budget": host(b, dtype=torch.int32),
                "out": host(b, self.decode_horizon, dtype=torch.int32),
                "event": torch.cuda.Event() if cuda else None}
                for _ in range(2)]
        return self._graph

    def _launch_tick(self, positions, tables, live_mask, budget, tokens=None):
        """Queue one tick: its inputs copied up from a staging set, the
        graph's steps (``min(horizon, max budget)``, a count the host
        knows), and its tokens copied back into the set behind its event.
        ``tokens=None`` chains from the last tick's carry. A set is
        refilled only once its previous tick's event has completed."""
        graph = self.horizon_graph()
        stage = self._stages.pop(0)
        self._stages.append(stage)
        if stage["event"] is not None:
            stage["event"].synchronize()
        for name, x in (("positions", positions), ("tables", tables),
                        ("live", live_mask), ("budget", budget),
                        ("tokens", tokens)):
            if x is not None:
                stage[name].numpy()[...] = x
        cuda = stage["event"] is not None
        graph.start(stage["positions"], stage["tables"], stage["live"],
                    stage["budget"],
                    tokens=None if tokens is None else stage["tokens"],
                    non_blocking=cuda)
        gen, _, _ = graph.run(int(min(self.decode_horizon, budget.max())))
        stage["out"].copy_(gen, non_blocking=cuda)
        if cuda:
            stage["event"].record()
        return {"stage": stage}

    def _harvest_decode(self, rec):
        stage = rec["stage"]
        if stage["event"] is not None:
            stage["event"].synchronize()   # this tick's tokens, and no later
        gen = stage["out"].numpy().copy()
        for i, state, h in rec["live"]:
            if state.finished:
                # finished at an earlier harvest (or aborted) while this
                # stale tick was in flight; the carry kept the lane dead
                continue
            for j in range(h):   # only granted steps have blocks
                self._append_token(state, int(gen[i, j]))
                if state.finished:
                    break

    def step(self):
        """One scheduler tick: admit -> prefill groups -> decode batch."""
        self._try_admit()
        groups_done = 0
        while self.needs_prefill:
            if (self.max_prefill_per_tick is not None and self.active
                    and groups_done >= self.max_prefill_per_tick):
                break  # decode now; remaining prefills ride later ticks
            group = []
            while self.needs_prefill and len(group) < self.prefill_group:
                group.append(self.needs_prefill.popleft())
            self._prefill_group_call(group)
            groups_done += 1
            self._try_admit()
        self._decode_batch()
