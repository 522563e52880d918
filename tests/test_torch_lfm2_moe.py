"""The port's LFM2-MoE (``models.lfm2``) against a plain float reference
(``gpubench/reference/lfm2_moe.py``, which imports neither JAX nor the
port, the benchmark's reference run at the parameters' dtype), at a
tiny size on the CPU, with every kind of layer present: conv and attention
operators, a dense FFN and sigmoid-routed experts.

Tolerances: fp64 logits within 1e-9, the reference's sums taken in another
order (the differences are ~1e-14);
bf16 misses that bound by orders of magnitude (checked below), so a step
computed in a lower precision than the configuration's fails it. The
serving path is held to the same reference: a padded prefill and decode
steps through the paged pool and the conv lanes (logits), and the engine
end to end (each served token the reference's best within 1e-9), with
lanes refilled after finished requests and a suffix chunked across
prefill calls. An abort while a chained tick is in flight leaves the other
lanes' tokens as the synchronous engine serves them, on the CPU and (the
``cuda`` case, skipped without a card) through the captured graphs.
"""

from dataclasses import asdict

import pytest
import torch

import vyomai_tpu_torch as tt
from gpubench.reference import lfm2_moe as plain
from vyomai_tpu_torch.layers.moe import MoE
from vyomai_tpu_torch.quant import Int8Embedding, Int8Linear
from vyomai_tpu_torch.serving import paged_model as pm

torch.set_num_threads(1)

CFG = tt.Lfm2MoeConfig(
    vocab_size=96, hidden_size=32, intermediate_size=48,
    moe_intermediate_size=16, num_hidden_layers=5, num_attention_heads=4,
    num_key_value_heads=2, max_position_embeddings=128,
    layer_types=("conv", "conv", "full_attention", "conv",
                 "full_attention"),
    num_dense_layers=1, num_experts=6, num_experts_per_tok=2,
    eos_token_id=9999)
TOL = 1e-9     # fp64 against fp64 in another summation order


def _model(dtype=torch.float64, seed=0):
    """Random weights at std 0.3 (so every layer moves the logits), norms
    near 1 and a nonzero expert bias, made in fp64 and cast to ``dtype``
    (the parameters only: the RoPE angle table stays fp32, as a model built
    in ``dtype`` holds it)."""
    g = torch.Generator().manual_seed(seed)
    m = tt.Lfm2MoeForCausalLM(CFG, device="cpu", dtype=torch.float64)
    m.init(g, std=0.3)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("norm.weight"):
                p.copy_(1.0 + 0.2 * torch.randn(p.shape, generator=g,
                                                dtype=p.dtype))
            elif name.endswith("expert_bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g,
                                          dtype=p.dtype))
    for p in m.parameters():
        p.data = p.data.to(dtype)
    return m


def _ref(model, ids):
    p = {k: v.to(torch.float64) for k, v in model.state_dict().items()}
    return plain.logits(p, asdict(CFG), ids)


def _ids(n, seed):
    return torch.randint(0, CFG.vocab_size, (n,),
                         generator=torch.Generator().manual_seed(seed))


def test_forward_matches_the_plain_reference():
    model = _model()
    ids = torch.stack([_ids(11, 1), _ids(11, 2)])
    with torch.no_grad():
        got = model(ids).logits
    for b in range(2):
        want = _ref(model, ids[b].tolist())
        assert (got[b] - want).abs().max() <= TOL


def test_bf16_misses_the_tolerance():
    model = _model()
    ids = _ids(9, 3)
    want = _ref(model, ids.tolist())
    with torch.no_grad():
        low = _model(torch.bfloat16)(ids[None]).logits[0].double()
    assert (low - want).abs().max() > 1e3 * TOL


def _prefill_inputs(rows, bucket, bs, maxb, tables):
    """A padded prefill call over ``rows`` (token lists; None = dead row),
    as the engine's staging writes it."""
    n = len(rows)
    x = {k: torch.full(s, f, dtype=d) for k, (f, d), s in (
        ("ids", (0, torch.int64), (n, bucket)),
        ("positions", (0, torch.int64), (n, bucket)),
        ("slot_blocks", (-1, torch.int32), (n, bucket)),
        ("slot_offsets", (0, torch.int64), (n, bucket)),
        ("tables", (-1, torch.int32), (n, maxb)),
        ("ctx_len", (0, torch.int64), (n,)),
        ("true_len", (0, torch.int64), (n,)),
        ("lanes", (-1, torch.int64), (n,)))}
    for i, row in enumerate(rows):
        if row is None:
            continue
        t = len(row)
        x["ids"][i, :t] = torch.tensor(row)
        x["positions"][i] = torch.clamp(torch.arange(bucket), max=t - 1)
        pos = torch.arange(t)
        x["slot_blocks"][i, :t] = tables[i][pos // bs]
        x["slot_offsets"][i, :t] = pos % bs
        x["tables"][i] = tables[i]
        x["ctx_len"][i] = t
        x["true_len"][i] = t
        x["lanes"][i] = i
    return x


@torch.no_grad()
def test_prefill_then_decode_through_pool_and_conv_lanes():
    """Three lanes of 3, 7 and 12 tokens and a dead row in one padded
    prefill call, then decode steps (lane 1 dead from the second): every
    logit row matches the reference's full forward over the tokens so
    far."""
    model = _model()
    bs, maxb, lanes = 4, 6, 4
    pool = pm.init_pool(CFG, 32, bs, dtype=torch.float64, device="cpu")
    state = pm.init_lane_state(model, lanes)
    assert pool.shape[0] == 2 and state.conv.shape == (3, lanes + 1, 2, 32)
    tables = torch.arange(lanes * maxb, dtype=torch.int32).view(lanes, maxb)
    seqs = [_ids(n, 10 + n).tolist() for n in (3, 7, 12)] + [None]
    x = _prefill_inputs(seqs, 16, bs, maxb, tables)
    logits = pm.prefill(model, pool, *x.values(), state=state)
    for i, s in enumerate(seqs[:3]):
        assert (logits[i] - _ref(model, s)[-1]).abs().max() <= TOL
    alive = torch.tensor([True, True, True, False])
    for step in range(3):
        toks = logits.argmax(-1)
        for i in range(3):
            if alive[i]:
                seqs[i].append(int(toks[i]))
        pos = torch.tensor([len(s) - 1 if s else 0 for s in seqs])
        seq_lens = torch.where(alive, pos + 1, 0).to(torch.int32)
        blk = tables[torch.arange(lanes), pos // bs]
        logits = pm.decode(model, pool, toks, pos, tables, seq_lens,
                           torch.where(alive, blk, -1), pos % bs, state)
        for i in range(3):
            if alive[i]:
                want = _ref(model, seqs[i])[-1]
                assert (logits[i] - want).abs().max() <= TOL, (step, i)
        alive[1] = False


def _engine(model, **kw):
    args = dict(num_blocks=64, block_size=4, max_batch=2,
                max_blocks_per_seq=16, max_new_tokens=8,
                dtype=torch.float64, prefill_buckets=(8, 16),
                radix_cache=False, prefill_group=2, decode_horizon=3)
    return tt.ContinuousBatchEngine(model, **dict(args, **kw))


def test_engine_serves_the_reference_best_tokens():
    """Five requests on two lanes (three refills), one prompt of 21 tokens
    (chunked over the 16-token bucket), pipelined ticks: every served
    token is the reference's best within the tolerance."""
    model = _model()
    eng = _engine(model)
    prompts = [_ids(n, 20 + n).tolist() for n in (5, 21, 3, 9, 14)]
    news = (8, 3, 6, 8, 5)
    sids = [eng.submit(p, max_new_tokens=m) for p, m in zip(prompts, news)]
    out = eng.run()
    c = eng.counters
    assert c["chained_ticks"] > 0 and c["prefill_calls"] >= 4
    assert c["moe_rows_prefill"] == sum(map(len, prompts)) * 2 * 4
    assert c["moe_rows_decode"] == sum(m - 1 for m in news) * 2 * 4
    assert 0 < c["moe_expert_visits_decode"] <= c["moe_rows_decode"]
    for sid, p, m in zip(sids, prompts, news):
        assert len(out[sid]) == m
        lg = _ref(model, p + out[sid])[len(p) - 1:-1]
        served = lg.gather(1, torch.tensor(out[sid])[:, None])[:, 0]
        assert (lg.max(-1).values - served).max() <= TOL


def test_preempted_sequence_is_prefilled_again_from_its_start():
    """A pool too small for both lanes preempts one; its re-prefill
    (prompt and generated tokens, from zero conv state) serves the
    reference's best tokens."""
    model = _model()
    eng = _engine(model, num_blocks=9, max_new_tokens=12)
    prompts = [_ids(10, 40).tolist(), _ids(9, 41).tolist()]
    sids = [eng.submit(p) for p in prompts]
    out = eng.run()
    assert eng.counters["preemptions"] > 0
    for sid, p in zip(sids, prompts):
        lg = _ref(model, p + out[sid])[len(p) - 1:-1]
        served = lg.gather(1, torch.tensor(out[sid])[:, None])[:, 0]
        assert (lg.max(-1).values - served).max() <= TOL


def test_radix_cache_is_refused():
    with pytest.raises(NotImplementedError, match="conv state"):
        _engine(_model(), radix_cache=True)


def test_quantize_model_leaves_the_expert_banks():
    """Every linear (router included) becomes int8 and the token table an
    int8 table; the stacked banks and the expert bias keep their dtype;
    the quantized model serves on an int8 pool."""
    model = tt.quantize_model(_model(torch.float32), bits=8)
    kinds = {n: type(m) for n, m in model.named_modules()}
    assert not any(isinstance(m, torch.nn.Linear) for m in model.modules())
    assert kinds["layers.1.mlp.gate"] is Int8Linear
    assert kinds["layers.0.conv.in_proj"] is Int8Linear
    assert isinstance(model.embed_tokens, Int8Embedding)
    for layer in model.layers[CFG.num_dense_layers:]:
        assert isinstance(layer.mlp, MoE)
        for t in (layer.mlp.w1, layer.mlp.w3, layer.mlp.w2,
                  layer.mlp.expert_bias):
            assert isinstance(t, torch.nn.Parameter)
            assert t.dtype == torch.float32
    eng = _engine(model, dtype=torch.int8)
    sid = eng.submit(_ids(6, 50).tolist(), max_new_tokens=4)
    assert len(eng.run()[sid]) == 4


def _abort_mid_chain(model, pipeline, **kw):
    """Three lanes served with ``pipeline_decode=pipeline``; the middle
    request is aborted after three steps (in flight in a chained tick when
    pipelined), and a new request takes its lane. Returns the tokens of
    the first and last requests, the new request's prompt and tokens, and
    the engine."""
    eng = _engine(model, max_batch=3, max_new_tokens=12,
                  pipeline_decode=pipeline, **kw)
    prompts = [_ids(n, 60 + n).tolist() for n in (7, 5, 9)]
    sids = [eng.submit(p) for p in prompts]
    for _ in range(3):
        eng.step()
    if pipeline:
        assert eng._inflight is not None
        assert eng.counters["chained_ticks"] > 0
    lane = eng.active[sids[1]].lane
    assert eng.abort(sids[1])
    new = _ids(6, 70).tolist()
    sid = eng.submit(new)
    eng.step()
    assert eng.active[sid].lane == lane       # the only free lane
    done = eng.run()
    assert sorted(done) == [sids[0], sids[2], sid]
    assert eng.kv.num_free() == eng.kv.num_blocks
    return [done[sids[0]], done[sids[2]]], new, done[sid], eng


def test_abort_mid_chain_with_conv_lanes_matches_sync():
    """An abort while a chained tick is in flight: the other lanes' tokens
    are the synchronous engine's with the same abort, every block comes
    back, and a request admitted into the freed lane (its conv state
    written by the aborted tick) serves the reference's best tokens."""
    model = _model()
    piped, new, got, _ = _abort_mid_chain(model, True)
    synced, _, _, _ = _abort_mid_chain(model, False)
    assert piped == synced
    assert all(len(t) == 12 for t in piped)
    lg = _ref(model, new + got)[len(new) - 1:-1]
    served = lg.gather(1, torch.tensor(got)[:, None])[:, 0]
    assert (lg.max(-1).values - served).max() <= TOL


@pytest.mark.cuda
def test_abort_mid_chain_with_conv_lanes_matches_sync_on_card():
    """The same on the card, in bf16 through the captured graphs and K11:
    the pipelined engine's other lanes equal the synchronous engine's,
    and the request in the freed lane serves the tokens a fresh engine
    serves it alone (bf16 routing near-ties make the float reference's
    best an unsteady yardstick at this precision)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs and K11 have no CPU "
                    "mode)")
    cfg = tt.Lfm2MoeConfig(**dict(
        asdict(CFG), vocab_size=512, hidden_size=256, intermediate_size=128,
        moe_intermediate_size=64, max_position_embeddings=256))
    model = tt.Lfm2MoeForCausalLM(cfg, device="cuda", dtype=torch.bfloat16)
    model.init(torch.Generator(device="cuda").manual_seed(0))
    model.requires_grad_(False)
    kw = dict(dtype=torch.bfloat16, device="cuda", block_size=16,
              prefill_buckets=(32, 64))
    piped, new, got, eng = _abort_mid_chain(model, True, **kw)
    synced, _, _, _ = _abort_mid_chain(model, False, **kw)
    assert eng._graph.graph is not None
    assert piped == synced
    fresh = _engine(model, max_batch=3, max_new_tokens=12, **kw)
    sid = fresh.submit(new)
    assert fresh.run()[sid] == got
