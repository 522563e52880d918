"""The serving engine's span-edge counters and profiler spans, on the CPU
with a tiny ``ModelForCausalLM``.

- The prefill counters equal sums worked out by hand for fixed prompts
  (padding to ``prefill_group`` x bucket, a chunked long suffix, a radix
  hit's cached offset); each request is admitted and waits for its first
  prefill once; a tick records host time.
- Under ``torch.profiler`` the exported Chrome trace holds the spans nested
  as the engine nests them, one ``paged_model.prefill.layer`` a layer
  inside each ``paged_model.prefill``.
- With no profiler running, ``record_function`` is never entered.
- ``metrics()`` keeps the first-token summary and has no ``tokens_per_s``.
"""

import json
from collections import Counter

import pytest
import torch

import vyomai_tpu_torch as tt
from vyomai_tpu_torch.serving import spans

torch.set_num_threads(1)

CFG = tt.QwenConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=3, num_attention_heads=4,
                    num_key_value_heads=2, head_dim=16,
                    max_position_embeddings=256, eos_token_id=9999)
PROMPTS = [[3, 17, 42, 9, 5], [5, 11, 7], list(range(1, 12)),
           list(range(20, 40))]


@pytest.fixture(scope="module")
def model():
    return tt.ModelForCausalLM(CFG, device="cpu").init(
        torch.Generator().manual_seed(0))


def _engine(model, **kw):
    args = dict(num_blocks=64, block_size=4, max_batch=4,
                max_blocks_per_seq=16, max_new_tokens=5,
                dtype=torch.float32, prefill_buckets=(8, 16),
                prefill_group=2, radix_cache=False, device="cpu")
    args.update(kw)
    return tt.ContinuousBatchEngine(model, **args)


def _pairs(cached, t):
    """Keys the ``t`` suffix tokens after ``cached`` ones attend."""
    return sum(cached + j + 1 for j in range(t))


def test_prefill_counters_match_hand_sums(model):
    eng = _engine(model)
    for p in PROMPTS:
        eng.submit(p)
    eng.run()
    c = eng.counters
    # one step admits all four; groups of two: [5, 3] in bucket 8, [11,
    # the 20-token prompt's first 16] in bucket 16, then its last 4 in 8
    assert c["prefill_calls"] == 3
    assert c["prefill_slots"] == 2 * 8 + 2 * 16 + 2 * 8
    assert c["prefill_tokens"] == 5 + 3 + 11 + 16 + 4 == sum(map(len,
                                                                 PROMPTS))
    assert c["prefill_attn_pairs"] == (_pairs(0, 5) + _pairs(0, 3)
                                       + _pairs(0, 11) + _pairs(0, 16)
                                       + _pairs(16, 4))
    assert c["prefill_ctx_tokens"] == 5 + 3 + 11 + 16 + 20
    assert c["requests_admitted"] == c["requests_prefilled"] == len(PROMPTS)
    assert c["queue_wait_ns"] > 0 and c["prefill_wait_ns"] > 0
    assert c["prefill_ns"] >= c["prefill_dispatch_ns"] > 0
    assert c["decode_ticks"] >= 1 and c["tick_host_ns"] > 0
    for key, v in c.items():
        assert isinstance(v, int), key


def test_radix_hit_counts_from_the_cached_offset(model):
    eng = _engine(model, radix_cache=True)
    first = list(range(100, 108))            # two whole blocks of 4
    eng.submit(first)
    eng.run()
    before = dict(eng.counters)
    eng.submit(first + [7, 8, 9])
    eng.run()
    d = {k: eng.counters[k] - before[k] for k in before}
    assert d["cached_prompt_tokens"] == 8
    assert d["prefill_tokens"] == 3 and d["prefill_slots"] == 2 * 8
    assert d["prefill_attn_pairs"] == _pairs(8, 3) == 3 * 8 + 6
    assert d["prefill_ctx_tokens"] == 11
    assert d["requests_admitted"] == d["requests_prefilled"] == 1


def test_a_tick_records_host_time(model):
    eng = _engine(model)
    eng.submit([4, 5, 6])
    eng.step()          # admit, prefill, dispatch the first tick
    assert eng.counters["decode_ticks"] == 1
    assert eng.counters["tick_host_ns"] > 0
    eng.run()


def _spans(trace_path):
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"
           and e["name"].split(".")[0] in ("engine", "paged_model")]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _parent(spans, child):
    """The innermost span that encloses ``child``, or None."""
    name, a, b = child
    best = None
    for s in spans:
        if s is child or not (s[1] <= a and b <= s[2]):
            continue
        if best is None or (s[2] - s[1]) < (best[2] - best[1]):
            best = s
    return best


PARENT = {
    "engine.admit": "engine.step",
    "engine.prefill": "engine.step",
    "engine.prefill.inputs": "engine.prefill",
    "paged_model.prefill": "engine.prefill",
    "paged_model.prefill.layer": "paged_model.prefill",
    "engine.prefill.read": "engine.prefill",
    "engine.tick": "engine.step",
    "engine.tick.dispatch": "engine.tick",
    "engine.tick.launch": "engine.tick.dispatch",
    "engine.tick.harvest": "engine.tick",
}


def test_profiler_trace_holds_the_spans_nested(model, tmp_path):
    eng = _engine(model)
    for p in PROMPTS:
        eng.submit(p)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        eng.run()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans_ = _spans(path)
    names = Counter(s[0] for s in spans_)
    assert set(names) == set(PARENT) | {"engine.step"}
    assert names["engine.prefill"] == eng.counters["prefill_calls"]
    assert names["paged_model.prefill"] == names["engine.prefill"]
    assert names["engine.tick.launch"] == eng.counters["decode_ticks"]
    for s in spans_:
        parent = _parent(spans_, s)
        if s[0] == "engine.step":
            assert parent is None
        else:
            assert parent is not None and parent[0] == PARENT[s[0]], s
    for s in spans_:
        if s[0] == "paged_model.prefill":
            inside = [c for c in spans_ if c[0] == "paged_model.prefill.layer"
                      and _parent(spans_, c) is s]
            assert len(inside) == CFG.num_hidden_layers


def test_no_record_function_without_the_profiler(model, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(spans, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    eng = _engine(model)
    for p in PROMPTS:
        eng.submit(p)
    assert len(eng.run()) == len(PROMPTS)
    with pytest.raises(AssertionError):      # the guard is what held
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            spans.span("engine.step")


def test_metrics_keep_first_token_summary_without_tokens_per_s(model):
    eng = _engine(model)
    for p in PROMPTS:
        eng.submit(p)
    eng.run()
    m = eng.metrics()
    assert "tokens_per_s" not in m
    assert 0 < m["ttft_mean_s"] <= m["ttft_max_s"]
    assert not hasattr(eng, "_ttft") and not hasattr(eng, "_t_start")
