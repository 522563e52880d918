"""Continuous-batching serving engine (counterpart of
``vyomai_tpu.serving.engine.ContinuousBatchEngine``, plain path).

Host-side scheduler (waiting room, block-budget admission, radix prefix
match, preemption, finished harvest) around the paged model steps:

- prefill: up to ``prefill_group`` admissions per call, each suffix padded
  to the group's bucket; suffixes longer than the largest bucket are
  chunked across calls. Each call is its bucket's
  ``paged_model.PrefillGraph``, fed from its pinned staging set: on the
  card, a replay of one captured CUDA graph of the forward; on the CPU, the
  same forward run eagerly;
- decode: all active sequences in one ``max_batch``-wide batch (dead lanes
  masked), up to ``decode_horizon`` tokens per tick, each tick one
  ``paged_model.HorizonGraph``: on the card, replays of one captured CUDA
  graph of the decode step; on the CPU, the same step run eagerly.

Ticks are pipelined (``pipeline_decode=True``, the JAX default): while a
tick is in flight the next one is dispatched from its device carry (final
tokens and eos flags) before the first is read back, whenever the batch is
unchanged and every lane can take another step (``_try_chain``); otherwise
the tick is read back at once and the next one is scheduled from the host
(``pipeline_decode=False`` always does that). The engine schedules: the
graphs own their host staging, the copies up and back and the events
(``paged_model``). Greedy by default;
``do_sample`` draws with engine-wide temperature/top-p/min-p from a seeded
``torch.Generator``.

While a ``torch.profiler`` session records, the scheduler's phases are
spans in its trace (``spans.span``): ``engine.step`` around a step;
inside it ``engine.admit``, ``engine.prefill`` (``engine.prefill.inputs``,
``paged_model.prefill`` with one ``paged_model.prefill.layer`` a layer,
``engine.prefill.read``; on the card the layers' spans are recorded once,
when the graphs are captured) and ``engine.tick`` (``engine.tick.dispatch``
around ``engine.tick.launch``, ``engine.tick.harvest``, and
``engine.tick.wait`` around each wait on a tick's event). The times and
counts behind the per-layer metrics are in ``counters`` always, on
``time.perf_counter_ns``'s clock.

A model with multi-head latent attention (``models.deepseek_v3``) keeps
one latent row a token a layer (``paged_model.init_pool``); the engine
counts the rows its attention reads (``counters``), and the block manager
keeps how many rows decode lanes share through the radix cache.

Each admitted sequence holds one decode lane, from admission until it
finishes, is aborted or is preempted: its row in every tick and, for a
model with conv layers (``models.lfm2``), its row of the conv state
(``paged_model.LaneState``), which its own prefill writes, in stream
order, before the first tick that reads it. A preempted sequence is
prefilled again from its first token. Such a model cannot take
``radix_cache=True``: a cached prefix would need the conv state at its
end, which the radix cache does not keep.
"""

import heapq
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import paged_model
from .kv_manager import PagedKVManager, SequenceState
from .spans import span
from ..generation.sampling import normalize_eos

clock = time.perf_counter_ns

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
    other than 64 and 128 (K1 and K4). A model with multi-head latent
    attention (``kv_lora_rank``) attends through K13 instead, where its
    heads all share one latent row a token, a "group" of every head: K13
    takes 16 heads over a latent of 512 and 64 rotary dims
    (Moonlight-16B-A3B's), the widths it was built and measured at. The
    plain path on the CPU serves all of these, so the engine checks only
    where it runs on a CUDA device."""
    if paged_model.is_mla(cfg):
        got = (cfg.num_attention_heads, cfg.kv_lora_rank,
               cfg.qk_rope_head_dim)
        if got != (16, 512, 64):
            raise NotImplementedError(
                f"MLA with {got[0]} heads, latent {got[1]}, rotary "
                f"{got[2]}: K13 (MLA over the latent pool) takes 16 heads "
                "sharing a 512 + 64 latent row (a group of 16) on the "
                "card; other widths are not ported yet")
        return
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
        """``model``: a ``models.qwen.ModelForCausalLM``,
        ``models.lfm2.Lfm2MoeForCausalLM`` or
        ``models.deepseek_v3.DeepseekV3ForCausalLM`` on ``device``
        (default: the model's device), float or quantized
        (``quant.quantize_model``).
        ``dtype`` is the pool's storage dtype: a float dtype,
        ``torch.int8`` or ``"int4"`` (quantized pools,
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
        self._mla = paged_model.is_mla(self.cfg)
        self._sampling = paged_model.sampling_tensors(
            self.device, self.temperature, self.top_p, self.min_p)
        # a chained tick must never write KV into blocks the host frees at
        # the harvest before it. Every finish the device cannot see (a
        # second eos id) rules chaining out; the features of the JAX engine
        # that also do (speculation, FSMs, penalties, min_tokens, logit
        # bias, a window, stop sequences, best_of) are not ported and raise
        self._chain = self.pipeline_decode and len(self.eos_ids) <= 1
        self._graph = None        # the decode tick, built at the first one
        # bucket -> its PrefillGraph, built at the first prefill call
        self._prefill_graphs = {}
        self._inflight = None
        self.pool = paged_model.init_pool(self.cfg, num_blocks, block_size,
                                          dtype=dtype, device=self.device)
        self.lane_state = paged_model.init_lane_state(model, max_batch)
        if self.radix_cache and paged_model.conv_layers(model):
            raise NotImplementedError(
                "radix_cache=True with a model whose conv layers keep "
                "per-lane state: reusing a cached prefix needs the conv "
                "state at the prefix's end, which the radix cache does not "
                "keep; pass radix_cache=False")
        self._free_lanes = list(range(max_batch))     # a heap
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
            "requests_admitted": 0, "queue_wait_ns": 0,
            "requests_prefilled": 0, "prefill_wait_ns": 0,
            "prefill_graph_calls": 0,
            "prefill_ns": 0, "prefill_dispatch_ns": 0,
            "prefill_tokens": 0, "prefill_slots": 0,
            "prefill_attn_pairs": 0, "prefill_ctx_tokens": 0,
            "tick_host_ns": 0,
            "moe_rows_decode": 0, "moe_rows_prefill": 0,
            "moe_expert_visits_decode": 0, "moe_expert_visits_prefill": 0,
            "norm_sites": 0, "norm_sites_fused": 0,
            "mla_rows_decode": 0, "mla_distinct_rows_decode": 0,
            "mla_pairs_prefill": 0, "mla_rows_prefill": 0,
        }
        """Running integer counts, read as differences between two copies
        (``dict(engine.counters)``); times are ``time.perf_counter_ns``
        nanoseconds. Each key moves once per request, prefill call or tick,
        never per token. In parentheses, the benchmark's per-layer metric
        (``gpubench/metrics/``) that reads the key.

        - ``requests_submitted``, ``prompt_tokens``: ``submit`` calls and
          their prompts' tokens; ``cached_prompt_tokens``: of those, the
          ones the radix cache held at admission (``prefix_hit_share``).
        - ``requests_completed``; ``tokens_generated``: tokens appended to
          any request; ``preemptions``: sequences freed and requeued for
          want of blocks.
        - ``requests_admitted``, ``queue_wait_ns``: moves from the waiting
          room to the prefill queue, and the time each waited there since
          its submit, or since its requeue after a preemption
          (``queue_wait_ms``).
        - ``requests_prefilled``, ``prefill_wait_ns``: admissions whose
          first prefill call started, and the time from the admission to
          that start (``prefill_wait_ms``).
        - ``prefill_calls``, ``prefill_ns``: prefill calls and the wall
          time of each, from its inputs to its token appends
          (``prefill_call_ms``, ``prefill_time_share.tok_s``);
          ``prefill_graph_calls``: of those calls, the ones a captured
          graph's replay served, every one on the card and none on the CPU
          (``prefill_graph_share``, ``prefill_graph_share.tok_s``);
          ``prefill_dispatch_ns``: of that, from the call's start until the
          replay is launched (on the CPU: the forward has returned), before
          the read-back waits for the device (``prefill_dispatch_share``).
        - ``prefill_tokens``, ``prefill_slots``: real suffix tokens, and
          the ``prefill_group`` x bucket slots each call padded them to
          (``padded_token_share``).
        - ``prefill_attn_pairs``: over real suffix tokens, the keys each
          attends (its position + 1); ``prefill_ctx_tokens``: over real
          rows, the K/V rows a row attends, its cached prefix and suffix
          (``k1_roofline.ttft``).
        - ``decode_ticks``, ``chained_ticks``: decode ticks, and those
          dispatched from the tick in flight (``chained_tick_share``);
          ``tick_host_ns``: the host's time in ticks outside the waits on a
          tick's event (``tick_host_ms.tok_s``).
        - ``moe_rows_decode``, ``moe_rows_prefill``: rows (token, chosen
          expert) that K11 ran in decode steps and in prefill calls, every
          MoE layer; ``moe_expert_visits_decode``,
          ``moe_expert_visits_prefill``: (layer, step or call, expert)
          triples with at least one row (``k11_roofline.decode.tok_s``,
          ``k11_roofline.prefill.tok_s``, ``expert_rows_per_visit.tok_s``).
          Summed on the device inside the captured graphs
          (``paged_model.LaneState.moe``) and copied back beside a tick's
          tokens and a prefill call's, so they stand as of the last tick
          harvested and the last prefill read; 0 for a model without
          experts.
        - ``norm_sites``, ``norm_sites_fused``: RMSNorm sites that decode
          steps and prefill calls ran, and of those the ones K12 ran (every
          one on the card, none on the CPU), added as each tick or prefill
          call is launched: a replay adds what its graph's capture counted
          (``fused_norm_share.tok_s``).
        - ``mla_rows_decode``, ``mla_distinct_rows_decode``: for a model
          with latent attention, the latent rows (one a token of context)
          that the live lanes of each decode step read, summed over steps,
          and the distinct rows among them: lanes that hold the same
          cached blocks read those rows once (the block manager's
          ``shared_rows``); ``mla_pairs_prefill``: the live (query, key)
          pairs of prefill calls, each real suffix token with the keys it
          attends (its position + 1); ``mla_rows_prefill``: the distinct
          latent rows each prefill call reads, a row shared by two of its
          rows once (``k13_roofline.decode.tok_s``,
          ``k13_roofline.prefill.tok_s``, ``latent_lanes_per_row.tok_s``).
          Per step or call, not per layer; added as each tick's and prefill
          call's inputs are staged, from the grants (a lane lives its whole
          grant); 0 for other models, whose ticks count nothing here.
        """
        # submit -> first token, without keeping one number per request
        self._first_token_ns = 0
        self._first_token_max_ns = 0
        self._first_tokens = 0
        self._waited_ns = 0          # in the tick running, on its events

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
        state.lane = None
        state.max_new = (self.max_new_tokens if max_new_tokens is None
                         else max_new_tokens)
        state.t_submit = state.t_queued = clock()
        state.t_admitted = None
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
                    self._release_lane(state)
                    return True
        state = self.active.pop(seq_id, None)
        if state is None:
            return False
        state.finished = True
        self._unhold(state)
        self.kv.free(state, cache_prefix=not state.no_radix)
        self._release_lane(state)
        return True

    def metrics(self) -> Dict[str, float]:
        """Running counters plus ``ttft_mean_s``/``ttft_max_s`` (submit to
        first token), ``cache_hit_rate``, and the device bytes the pool
        (``pool_bytes``, scales included) and the model's weights
        (``weight_bytes``, quantized buffers included) hold."""
        out = dict(self.counters)
        out.update(self.kv.cache_stats())
        out["ttft_mean_s"] = (self._first_token_ns / self._first_tokens
                              * 1e-9 if self._first_tokens else 0.0)
        out["ttft_max_s"] = self._first_token_max_ns * 1e-9
        out["cache_hit_rate"] = (
            self.counters["cached_prompt_tokens"]
            / max(self.counters["prompt_tokens"], 1))
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
            self.waiting.popleft()
            state.lane = heapq.heappop(self._free_lanes)
            state.t_admitted = clock()
            c = self.counters
            c["cached_prompt_tokens"] += state.num_cached_tokens
            c["requests_admitted"] += 1
            c["queue_wait_ns"] += state.t_admitted - state.t_queued
            self.needs_prefill.append(state)

    def _preempt_youngest(self):
        """Pool exhausted with no decode progress possible: free the most
        recently admitted sequence and requeue it at the head of the
        waiting room (its generated tokens are re-prefilled)."""
        victim = max(self.active.values(), key=lambda s: s.seq_id)
        self.counters["preemptions"] += 1
        self._unhold(victim)
        self.kv.free(victim, cache_prefix=False)
        self.active.pop(victim.seq_id, None)
        self._release_lane(victim)
        victim.prefill_len = len(victim.tokens)
        victim.num_cached_tokens = 0
        victim.t_queued = clock()
        self.waiting.appendleft(victim)

    def _prefill_group_call(self, states):
        """Prefill up to ``prefill_group`` admissions in one call; a suffix
        longer than the largest bucket writes its first chunk and goes back
        to the head of the prefill queue."""
        t0 = clock()
        c = self.counters
        with span("engine.prefill"):
            for state in states:
                if state.t_admitted is not None:   # its first prefill call
                    c["requests_prefilled"] += 1
                    c["prefill_wait_ns"] += t0 - state.t_admitted
                    state.t_admitted = None
            with span("engine.prefill.inputs"):
                graph, suffixes = self._prefill_inputs(states)
                graph.start()
            norms = paged_model.norm_counts()
            logits = graph.run()
            self._count_norms(norms)
            t_dispatched = clock()
            with span("engine.prefill.read"):
                # the next replay overwrites the logits: read them first
                next_tokens = paged_model.pick_tokens(
                    logits, self.do_sample, self.generator,
                    self._sampling).cpu().numpy()
                c.update(graph.counts())
                for i, state in enumerate(states):
                    done = state.num_cached_tokens + len(suffixes[i])
                    if done >= state.prefill_len:
                        self.active[state.seq_id] = state
                        self._append_token(state, int(next_tokens[i]))
                    else:  # more chunks to go: KV written, logits discarded
                        state.num_cached_tokens = done
                        self.needs_prefill.appendleft(state)
        c["prefill_calls"] += 1
        c["prefill_graph_calls"] += graph.graph is not None
        c["prefill_dispatch_ns"] += t_dispatched - t0
        c["prefill_ns"] += clock() - t0

    def prefill_graphs(self):
        """One ``paged_model.PrefillGraph`` a prefill bucket, built at the
        first prefill call; on the card their captures share one memory
        pool (each call's logits are read before the next replay)."""
        if not self._prefill_graphs:
            mempool = (torch.cuda.graph_pool_handle()
                       if self.device.type == "cuda" else None)
            self._prefill_graphs = {
                b: paged_model.PrefillGraph(
                    self.model, self.pool, self.prefill_group, b,
                    self.max_blocks_per_seq, mempool=mempool,
                    state=self.lane_state)
                for b in self.prefill_buckets}
        return self._prefill_graphs

    def _prefill_inputs(self, states):
        """Write the call's padded inputs, ``[prefill_group, bucket]``, into
        its bucket's staging set (rows past ``states`` dead); returns that
        bucket's graph and each state's suffix, and counts the call's
        tokens, slots and attention work."""
        cap = self.prefill_buckets[-1]
        bs = self.block_size
        suffixes = [s.tokens[s.num_cached_tokens:
                             min(s.prefill_len, s.num_cached_tokens + cap)]
                    for s in states]
        t_pad = _bucket(max(len(sf) for sf in suffixes),
                        self.prefill_buckets)
        graph = self.prefill_graphs()[t_pad]
        x = graph.stage()
        pairs = ctx = 0
        for i, (state, suffix) in enumerate(zip(states, suffixes)):
            cached, t = state.num_cached_tokens, len(suffix)
            x["ids"][i, :t] = suffix
            x["positions"][i] = np.minimum(cached + np.arange(t_pad),
                                           cached + max(t - 1, 0))
            pos = cached + np.arange(t)
            x["slot_blocks"][i, :t] = np.asarray(state.block_table)[pos // bs]
            x["slot_offsets"][i, :t] = pos % bs
            x["tables"][i, :len(state.block_table)] = state.block_table
            x["ctx_len"][i] = state.prefill_len
            x["true_len"][i] = t
            if "lanes" in x:
                x["lanes"][i] = state.lane
            pairs += t * cached + t * (t + 1) // 2   # keys: position + 1
            ctx += cached + t
        c = self.counters
        c["prefill_tokens"] += int(x["true_len"].sum())
        c["prefill_slots"] += self.prefill_group * t_pad
        c["prefill_attn_pairs"] += pairs
        c["prefill_ctx_tokens"] += ctx
        if self._mla:
            c["mla_pairs_prefill"] += pairs
            c["mla_rows_prefill"] += self._call_rows(states, suffixes)
        return graph, suffixes

    def _call_rows(self, states, suffixes) -> int:
        """The distinct pool rows a prefill call reads: each row's context
        up to its last real token, through its block table."""
        bs, used = self.block_size, {}
        for state, suffix in zip(states, suffixes):
            full, part = divmod(state.num_cached_tokens + len(suffix), bs)
            for b in state.block_table[:full]:
                used[b] = bs
            if part:
                b = state.block_table[full]
                used[b] = max(used.get(b, 0), part)
        return sum(used.values())

    def _append_token(self, state: SequenceState, tok: int):
        state.tokens.append(tok)
        if len(state.tokens) == state.prompt_len + 1:
            ttft = clock() - state.t_submit
            self._first_token_ns += ttft
            self._first_token_max_ns = max(self._first_token_max_ns, ttft)
            self._first_tokens += 1
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
            self._unhold(state)
            self.kv.free(state, cache_prefix=not state.no_radix)
            self._release_lane(state)
            self.active.pop(state.seq_id, None)
            self.counters["requests_completed"] += 1
            self.finished[state.seq_id] = state

    def _hold(self, state: SequenceState):
        """A decode lane starts reading its cached blocks (an MLA model's
        count, ``counters``)."""
        state.held = np.fromiter((node.block for node in state.cached_nodes),
                                 dtype=np.int64, count=len(state.cached_nodes))
        self.kv.hold(state.held)

    def _unhold(self, state: SequenceState):
        """A decode lane stops reading its cached blocks; before
        ``kv.free`` drops them."""
        if state.held is not None:
            self.kv.unhold(state.held)
            state.held = None

    def _release_lane(self, state: SequenceState):
        if state.lane is not None:
            heapq.heappush(self._free_lanes, state.lane)
            state.lane = None

    # -- decode ticks ---------------------------------------------------------
    def _decode_batch(self):
        """Plain decode tick, pipelined when safe: the in-flight tick's
        device carry (final tokens and eos flags) feeds the next tick's
        dispatch before the in-flight tick is read back, so the host's
        harvest and bookkeeping overlap the next tick on the card."""
        t0, self._waited_ns = clock(), 0
        with span("engine.tick"):
            self._tick()
        self.counters["tick_host_ns"] += clock() - t0 - self._waited_ns

    def _tick(self):
        prev, self._inflight = self._inflight, None
        if prev is not None:
            with span("engine.tick.dispatch"):
                nxt = self._try_chain(prev)   # while prev is in flight
            self._harvest_decode(prev)
            if nxt is not None:
                self._inflight = nxt
                return
        with span("engine.tick.dispatch"):
            rec = self._dispatch_decode()
        if rec is None:
            return
        if self._chain:
            self._inflight = rec          # harvested next step, overlapped
        else:
            self._harvest_decode(rec)

    def _dispatch_decode(self):
        states = [s for s in self.active.values() if not s.finished]
        if not states:
            return None
        grants = []
        for state in states:
            pos = len(state.tokens) - 1  # position of the latest token
            # budget the whole horizon up front so slot arithmetic never
            # walks off the block table; cap by table capacity
            remaining = state.max_new - (len(state.tokens) - state.prompt_len)
            cap = self.max_blocks_per_seq * self.block_size - pos
            h = max(min(self.decode_horizon, remaining, cap), 1)
            while h >= 1 and not self.kv.allocate(state, pos + h):
                h //= 2  # pool pressure: shrink the grant
            if h >= 1:   # else the pool is exhausted: retry next tick
                grants.append((state.lane, state, pos, h))
        if not grants:
            self._preempt_youngest()
            return None
        return self._launch(grants, chain=False)

    def _try_chain(self, prev):
        """Dispatch the next tick from the in-flight tick's device carry
        (no host round trip): only when the batch is unchanged and every
        lane can take at least one more step. Returns the new in-flight
        record, or None (the caller harvests and ticks synchronously)."""
        states = [s for s in self.active.values() if not s.finished]
        prev_states = [s for _, s, _ in prev["live"]]
        if len(states) != len(prev_states) or \
                any(a is not b for a, b in zip(states, prev_states)):
            return None             # admission/finish changed composition
        bs = self.block_size
        grants = []
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
            grants.append((i, state, pos1, h1))
        return self._launch(grants, chain=True)

    def _launch(self, grants, chain: bool):
        """Queue a tick for ``grants``, ``(lane, state, position, grant)``
        each (the other lanes dead; ``chain``: from the in-flight tick's
        carry), of ``min(horizon, largest grant)`` steps; returns its
        in-flight record."""
        self.counters["decode_ticks"] += 1
        self.counters["chained_ticks"] += chain
        graph = self.horizon_graph()
        with span("engine.tick.launch"):
            x = graph.stage(self._wait)
            for i, state, pos, h in grants:
                x["tokens"][i] = state.tokens[-1]   # not sent up by a chain
                x["positions"][i] = pos
                x["live"][i] = True
                x["budget"][i] = h
                x["tables"][i, :len(state.block_table)] = state.block_table
            n = min(self.decode_horizon, max(g[3] for g in grants))
            if self._mla:
                self._count_latent_rows(grants, n)
            norms = paged_model.norm_counts()
            tick = graph.launch(n, chain)
            self._count_norms(norms)
        return {"tick": tick, "live": [(i, s, h) for i, s, _, h in grants]}

    def _count_latent_rows(self, grants, n: int):
        """Add a tick's latent rows to ``mla_rows_decode`` and the distinct
        ones to ``mla_distinct_rows_decode``: step ``j`` reads positions
        ``0..pos + j`` of each lane whose grant exceeds ``j``, and the
        cached blocks that lanes live in that step share are read once.
        A lane holds its blocks from its first grant; one that sits a tick
        out, or whose grant ends before the tick's last step (it finishes
        in that tick, or the pool shrank its grant), gives them up here and
        takes them again at its next grant, so a lane is held and given up
        about once in its life and no table is scanned."""
        kv = self.kv
        rows = sum(h * (pos + 1) + h * (h - 1) // 2
                   for _, _, pos, h in grants)
        granted = {s.seq_id for _, s, _, _ in grants}
        for s in self.active.values():
            if s.seq_id not in granted:
                self._unhold(s)
        for _, s, _, _ in grants:
            if s.held is None:
                self._hold(s)
        shared, j0 = 0, 0
        for _, s, _, h in sorted(grants, key=lambda g: g[3]):
            if h >= n:
                break
            shared += kv.shared_rows * (h - j0)
            self._unhold(s)
            j0 = h
        shared += kv.shared_rows * (n - j0)
        self.counters["mla_rows_decode"] += rows
        self.counters["mla_distinct_rows_decode"] += rows - shared

    def _count_norms(self, before):
        """Add the norm sites run since ``before`` (``paged_model.
        norm_counts()``) to the counters."""
        sites, fused = paged_model.norm_counts()
        self.counters["norm_sites"] += sites - before[0]
        self.counters["norm_sites_fused"] += fused - before[1]

    def horizon_graph(self):
        """The decode tick (``paged_model.HorizonGraph``, with its staging),
        built at the first tick."""
        if self._graph is None:
            self._graph = paged_model.HorizonGraph(
                self.model, self.pool, self.max_batch,
                self.max_blocks_per_seq, self.decode_horizon,
                do_sample=self.do_sample,
                eos=-1 if self.eos_token_id is None else self.eos_token_id,
                generator=self.generator, samp=self._sampling,
                state=self.lane_state)
        return self._graph

    def _wait(self, event):
        """Block until ``event`` has completed; the time is kept out of
        ``tick_host_ns``."""
        t0 = clock()
        with span("engine.tick.wait"):
            event.synchronize()
        self._waited_ns += clock() - t0

    def _harvest_decode(self, rec):
        # this tick's tokens, and no later
        gen, counts = self._graph.read(rec["tick"], self._wait)
        with span("engine.tick.harvest"):
            self.counters.update(counts)
            for i, state, h in rec["live"]:
                if state.finished:
                    # finished at an earlier harvest (or aborted) while
                    # this stale tick was in flight; the carry kept the
                    # lane dead
                    continue
                for j in range(h):   # only granted steps have blocks
                    self._append_token(state, int(gen[i, j]))
                    if state.finished:
                        break

    def step(self):
        """One scheduler tick: admit -> prefill groups -> decode batch."""
        with span("engine.step"):
            with span("engine.admit"):
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
                with span("engine.admit"):
                    self._try_admit()
            self._decode_batch()
