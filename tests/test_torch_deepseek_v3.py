"""The port's DeepSeek-V3 block (``models.deepseek_v3``: multi-head latent
attention, a dense first layer, sigmoid-routed experts with a shared one)
against a plain float reference (``gpubench/reference/deepseek_v3.py``,
which imports neither JAX nor the port, the benchmark's reference run at
the parameters' dtype), at a tiny size on the CPU.

Tolerances: fp64 logits within 1e-9, the reference's sums taken in another
order and MLA decompressed where the serving steps run it absorbed (the
differences are ~1e-14); bf16 misses that bound by orders of magnitude
(checked below), so a step computed in a lower precision than the
configuration's fails it. The serving path is held to the same reference:
a padded prefill and decode steps through the latent pool (logits), and
the engine end to end with a radix-cache hit (each served token the
reference's best within 1e-9). The ``cuda`` cases (skipped without a card)
hold K13 to its plain version at the served widths.
"""

from dataclasses import asdict

import pytest
import torch

import vyomai_tpu_torch as tt
from vyomai_tpu_torch.core import nn as cnn
from gpubench.reference import deepseek_v3 as plain
from vyomai_tpu_torch.layers import mla
from vyomai_tpu_torch.layers.modern import rope_tables
from vyomai_tpu_torch.layers.moe import MoE
from vyomai_tpu_torch.ops import mla_attention as k13
from vyomai_tpu_torch.quant import Int8Linear
from vyomai_tpu_torch.serving import paged_model as pm
from vyomai_tpu_torch.serving.engine import check_card_config

torch.set_num_threads(1)

CFG = tt.DeepseekV3Config(
    vocab_size=96, hidden_size=32, intermediate_size=48,
    moe_intermediate_size=16, num_hidden_layers=3, num_attention_heads=4,
    num_key_value_heads=4, n_routed_experts=8, num_experts_per_tok=2,
    n_shared_experts=2, kv_lora_rank=16, qk_nope_head_dim=8,
    qk_rope_head_dim=4, v_head_dim=8, max_position_embeddings=128,
    eos_token_id=9999)
TOL = 1e-9     # fp64 against fp64 in another summation order


def _model(dtype=torch.float64, seed=0):
    """Random weights at std 0.3 (so every layer moves the logits), norms
    near 1 and a nonzero expert bias, made in fp64 and cast to ``dtype``
    (the parameters only: the RoPE angle table stays fp32)."""
    g = torch.Generator().manual_seed(seed)
    m = tt.DeepseekV3ForCausalLM(CFG, device="cpu", dtype=torch.float64)
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


def test_config_refuses_what_is_not_ported():
    for bad in (dict(q_lora_rank=64), dict(rope_scaling={"type": "yarn"}),
                dict(n_group=2), dict(topk_group=2),
                dict(scoring_func="softmax")):
        with pytest.raises(NotImplementedError):
            tt.DeepseekV3Config(**bad)
    pub = tt.DeepseekV3Config()
    assert (pub.qk_head_dim, pub.latent_dim) == (192, 576)


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


def test_rope_takes_the_published_interleaved_pairs():
    """Pair (x0, x1) rotates by the first angle, as upstream's ``view(...,
    d/2, 2).transpose`` then rotate-half does, and the result comes out
    with the pairs' first members first."""
    x = torch.arange(1.0, 5.0, dtype=torch.float64)          # r = 4
    ang = torch.tensor([0.3, 0.7], dtype=torch.float64)
    cos, sin = torch.cat([ang, ang]).cos(), torch.cat([ang, ang]).sin()
    got = mla.rope_interleaved(x, cos, sin)
    a, b = x[0::2], x[1::2]
    want = torch.cat([a * ang.cos() - b * ang.sin(),
                      b * ang.cos() + a * ang.sin()])
    assert torch.allclose(got, want, atol=1e-15)


@torch.no_grad()
def test_absorbed_form_matches_the_decompressed_one():
    """One MLA layer over a 13-token sequence: ``mla_apply`` (decompressed,
    as the reference) against the absorbed queries over the latent rows
    through K13's plain prefill, then ``W_UV`` and ``o_proj``."""
    model = _model()
    attn = model.layers[1].self_attn
    x = torch.randn(1, 13, CFG.hidden_size, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(5))
    pos = torch.arange(13)
    cos, sin = rope_tables(model, pos, x.dtype)               # [13, 1, r]
    want = mla.mla_apply(attn, x, CFG, cos, sin)[0]
    q_nope, q_pe = mla.queries(attn, CFG, x[0], (13,), cos, sin)
    rows = mla.latent_rows(attn, CFG, x[0], cos, sin)         # [13, c + r]
    pool = torch.zeros(4, 4, CFG.latent_dim, dtype=torch.float64)
    pool.view(16, -1)[:13] = rows
    q = torch.cat([mla.absorb_q(attn, CFG, q_nope), q_pe], -1)
    o = k13.mla_prefill_ref(
        q[None], pool, torch.arange(4, dtype=torch.int32)[None], pos[None],
        torch.tensor([13]), torch.tensor([13]), CFG.kv_lora_rank,
        CFG.qk_head_dim ** -0.5)[0]
    got = cnn.apply_linear(attn.o_proj, mla.absorb_out(attn, CFG, o))
    assert (got - want).abs().max() <= TOL


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
def test_prefill_then_decode_through_the_latent_pool():
    """Three lanes of 3, 7 and 12 tokens and a dead row in one padded
    prefill call, then decode steps (lane 1 dead from the second): every
    logit row matches the reference's full forward over the tokens so
    far; the pool holds one latent row a token and layer."""
    model = _model()
    bs, maxb, lanes = 4, 6, 4
    pool = pm.init_pool(CFG, 32, bs, dtype=torch.float64, device="cpu")
    assert pool.shape == (3, 32, bs, CFG.kv_lora_rank + CFG.qk_rope_head_dim)
    assert pm.pool_block_size(pool) == bs
    state = pm.init_lane_state(model, lanes)
    assert state.conv is None and state.moe is not None
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
    args = dict(num_blocks=96, block_size=4, max_batch=3,
                max_blocks_per_seq=16, max_new_tokens=8,
                dtype=torch.float64, prefill_buckets=(8, 16),
                radix_cache=True, prefill_group=2, decode_horizon=3)
    return tt.ContinuousBatchEngine(model, **dict(args, **kw))


def _served_best(model, prompts, sids, out):
    for sid, p in zip(sids, prompts):
        lg = _ref(model, p + out[sid])[len(p) - 1:-1]
        served = lg.gather(1, torch.tensor(out[sid])[:, None])[:, 0]
        assert (lg.max(-1).values - served).max() <= TOL


def test_engine_serves_the_reference_best_tokens_from_a_cached_document():
    """A 22-token document prefilled once (the radix cache keeps its five
    whole blocks), then four questions on it and one without, on three
    lanes, a question chunked over the 16-token bucket: the cache serves
    the document's rows, and every served token is the reference's best
    within the tolerance."""
    model = _model()
    eng = _engine(model)
    doc = _ids(22, 30).tolist()
    eng.submit(doc, max_new_tokens=1)
    eng.run()
    prompts = [doc + _ids(n, 40 + n).tolist() for n in (3, 9, 1, 18)]
    prompts.append(_ids(6, 50).tolist())
    news = (8, 5, 7, 6, 8)
    sids = [eng.submit(p, max_new_tokens=m) for p, m in zip(prompts, news)]
    out = eng.run()
    c = eng.counters
    assert c["cached_prompt_tokens"] == 4 * 20
    assert c["chained_ticks"] > 0
    assert c["mla_pairs_prefill"] == c["prefill_attn_pairs"]
    assert 0 < c["mla_distinct_rows_decode"] < c["mla_rows_decode"]
    assert all(len(out[s]) == m for s, m in zip(sids, news))
    _served_best(model, prompts, sids, out)
    assert eng.kv.shared_rows == 0 and not eng.kv._holders.any()


def _scan(grants, n, bs):
    """Distinct ``(block, offset)`` rows the live lanes read over a tick's
    ``n`` steps, from their block tables."""
    total = 0
    for j in range(n):
        rows = set()
        for _, state, pos, h in grants:
            if h > j:
                for p in range(pos + j + 1):
                    rows.add((state.block_table[p // bs], p % bs))
        total += len(rows)
    return total


def test_distinct_decode_rows_match_a_scan_of_the_tables():
    """Lanes that share a cached document, of unequal grants (one finishes
    inside a tick) and a lane without it: at every tick,
    ``mla_distinct_rows_decode`` grows by the distinct rows a scan of the
    tables finds, and ``mla_rows_decode`` by every lane's rows."""
    model = _model()
    eng = _engine(model, max_new_tokens=8)
    doc = _ids(17, 60).tolist()
    eng.submit(doc, max_new_tokens=1)
    eng.run()
    seen = []
    launch = eng._launch

    def watched(grants, chain):
        before = (eng.counters["mla_rows_decode"],
                  eng.counters["mla_distinct_rows_decode"])
        n = min(eng.decode_horizon, max(g[3] for g in grants))
        want = _scan(grants, n, eng.block_size)
        rows = sum(sum(pos + 1 + j for j in range(h))
                   for _, _, pos, h in grants)
        rec = launch(grants, chain)
        seen.append((eng.counters["mla_rows_decode"] - before[0], rows,
                     eng.counters["mla_distinct_rows_decode"] - before[1],
                     want))
        return rec
    eng._launch = watched
    prompts = [doc + _ids(n, 70 + n).tolist() for n in (2, 5)]
    prompts.append(_ids(7, 80).tolist())
    sids = [eng.submit(p, max_new_tokens=m)
            for p, m in zip(prompts, (8, 4, 6))]
    eng.run()
    assert len(seen) >= 3 and any(d < r for _, r, d, _ in seen)
    for got_rows, rows, got, want in seen:
        assert (got_rows, got) == (rows, want)
    del sids


def test_decode_lanes_take_their_cached_blocks_once():
    """The count costs the tick little: with no pool pressure each lane
    takes its cached blocks at its first grant and gives them up once,
    in the tick its grant ends or at its finish, whatever its ticks."""
    model = _model()
    eng = _engine(model, max_new_tokens=8)
    doc = _ids(17, 60).tolist()
    eng.submit(doc, max_new_tokens=1)
    eng.run()
    calls = {"hold": 0, "unhold": 0}
    for name in calls:
        fn = getattr(eng.kv, name)

        def counted(blocks, fn=fn, name=name):
            calls[name] += 1
            fn(blocks)
        setattr(eng.kv, name, counted)
    before = eng.counters["decode_ticks"]
    for n, m in ((2, 8), (5, 4), (3, 6)):
        eng.submit(doc + _ids(n, 70 + n).tolist(), max_new_tokens=m)
    eng.run()
    assert eng.counters["decode_ticks"] - before >= 3
    assert calls == {"hold": 3, "unhold": 3}
    assert eng.kv.shared_rows == 0


def test_prefill_call_rows_count_a_shared_document_once():
    model = _model()
    eng = _engine(model, max_batch=2)
    doc = _ids(16, 90).tolist()
    eng.submit(doc, max_new_tokens=1)
    eng.run()
    before = dict(eng.counters)
    for n in (3, 5):
        eng.submit(doc + _ids(n, 91 + n).tolist(), max_new_tokens=1)
    eng.run()
    c = eng.counters
    # one call: the document's 16 cached rows once, each row's own 3 and 5
    assert c["prefill_calls"] - before["prefill_calls"] == 1
    assert c["cached_prompt_tokens"] - before["cached_prompt_tokens"] == 32
    assert c["mla_rows_prefill"] - before["mla_rows_prefill"] == 16 + 3 + 5


def test_latent_pool_refuses_a_quantized_dtype():
    with pytest.raises(NotImplementedError, match="latent pool"):
        pm.init_pool(CFG, 8, 4, dtype=torch.int8, device="cpu")


def test_write_latent_drops_dead_slots():
    pool = torch.zeros(3, 2, 5)
    rows = torch.arange(15.0).view(3, 5) + 1
    k13.write_latent(pool, rows, torch.tensor([2, -1, 0]),
                     torch.tensor([1, 0, 0]))
    assert pool[2, 1].tolist() == rows[0].tolist()
    assert pool[0, 0].tolist() == rows[2].tolist()
    assert pool.abs().sum() == rows[0].sum() + rows[2].sum()
    before = pool.clone()
    k13.write_latent(pool, rows, torch.tensor([-1, -1, -1]),
                     torch.tensor([0, 1, 0]))
    assert torch.equal(pool, before)


def test_card_check_takes_mla_at_the_published_widths_only():
    check_card_config(tt.DeepseekV3Config())
    with pytest.raises(NotImplementedError, match="K13"):
        check_card_config(CFG)


def test_quantized_model_serves_through_the_dequantized_kv_b():
    """``quantize_model`` makes every linear int8: ``kv_b_proj`` too, which
    the absorbed products read dequantized, and the shared expert's; the
    stacked banks keep their dtype, and the model serves on the CPU."""
    model = tt.quantize_model(_model(torch.float32), bits=8)
    kinds = {n: type(m) for n, m in model.named_modules()}
    assert kinds["layers.1.self_attn.kv_b_proj"] is Int8Linear
    assert kinds["layers.1.mlp.shared_experts.down_proj"] is Int8Linear
    assert isinstance(model.layers[1].mlp, MoE)
    assert model.layers[1].mlp.w1.dtype == torch.float32
    eng = _engine(model, dtype=torch.float32)
    sid = eng.submit(_ids(6, 95).tolist(), max_new_tokens=4)
    assert len(eng.run()[sid]) == 4


# -- K13 on the card ----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (K13 is a CUDA kernel with no "
                    "CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pool(cuda, nb, seed=0):
    """A bf16 latent pool at the served width (512 + 64): the latent part
    RMS-normed scale, the rotary part ~1."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(nb, 16, 576, generator=g, device=cuda).to(
        torch.bfloat16)


def _close(got, want):
    """bf16 rounding of the probabilities and of the output: within 2^-7
    of the output's scale, plus the sums' order."""
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2 ** -7 * want.float().abs().max().item() + 2e-3, err


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,maxb", [(128, 513), (5, 40)])
def test_k13_decode_matches_plain_on_card(cuda, lanes, maxb):
    """Ragged lanes (0 to the table's whole length), tables that share
    blocks (a cached document) and hold -1 past their length, 16 heads
    of 512 + 64: K13's decode pair against its plain version."""
    g = torch.Generator(device=cuda).manual_seed(1)
    pool = _pool(cuda, 4 * maxb)
    q = torch.randn(lanes, 16, 576, generator=g, device=cuda).to(
        torch.bfloat16)
    tables = torch.randint(0, 4 * maxb, (lanes, maxb), generator=g,
                           device=cuda, dtype=torch.int32)
    tables[: lanes // 2, : maxb // 2] = tables[0, : maxb // 2]
    lens = torch.randint(0, maxb * 16 + 1, (lanes,), generator=g,
                         device=cuda, dtype=torch.int32)
    lens[0], lens[-1] = 0, maxb * 16
    tables[1, (lens[1] + 15) // 16:] = -1
    scale = 192 ** -0.5
    got = k13.mla_decode(q, pool, tables, lens, 512, scale)
    torch.cuda.synchronize()
    want = k13.mla_decode_ref(q, pool, tables, lens, 512, scale)
    assert got[0].abs().max() == 0
    _close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("bucket,cached", [(128, 5920), (512, 0), (32, 7100)])
def test_k13_prefill_matches_plain_on_card(cuda, bucket, cached):
    """Four rows of a prefill call (one dead, one short) over a cached
    context and their own suffix, causal with the offset: K13's prefill
    kernel against its plain version; padded tokens give 0."""
    g = torch.Generator(device=cuda).manual_seed(2)
    maxb = 513
    pool = _pool(cuda, 4 * maxb, seed=3)
    q = torch.randn(4, bucket, 16, 576, generator=g, device=cuda).to(
        torch.bfloat16)
    tables = torch.randint(0, 4 * maxb, (4, maxb), generator=g, device=cuda,
                           dtype=torch.int32)
    true_len = torch.tensor([bucket, bucket // 3, 0, 1], device=cuda)
    ctx = cached + true_len
    ctx[2] = 0
    pos = cached + torch.minimum(torch.arange(bucket, device=cuda)[None],
                                 (true_len - 1).clamp_min(0)[:, None])
    scale = 192 ** -0.5
    got = k13.mla_prefill(q, pool, tables, pos, ctx, true_len, 512, scale)
    torch.cuda.synchronize()
    want = k13.mla_prefill_ref(q, pool, tables, pos, ctx, true_len, 512,
                               scale)
    assert got[2].abs().max() == 0 and got[1, bucket // 3:].abs().max() == 0
    _close(got, want)


@pytest.mark.cuda
def test_k13_decode_in_a_graph_reads_lengths_from_the_device(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    pool = _pool(cuda, 64)
    q = torch.randn(8, 16, 576, generator=g, device=cuda).to(torch.bfloat16)
    tables = torch.randint(0, 64, (8, 16), generator=g, device=cuda,
                           dtype=torch.int32)
    lens = torch.full((8,), 100, device=cuda, dtype=torch.int32)
    k13.mla_decode(q, pool, tables, lens, 512, 0.1)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = k13.mla_decode(q, pool, tables, lens, 512, 0.1)
    lens.copy_(torch.arange(8, device=cuda, dtype=torch.int32) * 30)
    graph.replay()
    torch.cuda.synchronize()
    _close(out, k13.mla_decode_ref(q, pool, tables, lens, 512, 0.1))
