"""Parity of the PyTorch port's paged serving path with the JAX package:
paged-pool ops, ``serving.paged_model`` prefill/decode logits (fp64),
``decode_horizon`` greedy tokens (fp32), ``sampling_mask``, and the
continuous-batching engine's greedy outputs in the scenarios of
``tests/test_serving.py``.

Fully-masked rows are masked out of every comparison: the JAX CPU path
gives them the mean of V where the kernels (and the port) give 0."""

from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vyomai_tpu as vt
from vyomai_tpu.ops import paged_attention as jpa
from vyomai_tpu.serving import ContinuousBatchEngine as JaxEngine
from vyomai_tpu.serving import paged_model as jpm

import vyomai_tpu_torch as tt
from vyomai_tpu_torch.interop import params_from_jax
from vyomai_tpu_torch.ops import paged_attention as tpa
from vyomai_tpu_torch.serving import paged_model as tpm

torch.set_num_threads(1)

QCFG = vt.QwenConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, head_dim=32,
                     max_position_embeddings=256, qk_norm=True,
                     eos_token_id=9999, tie_word_embeddings=True)
TCFG = tt.QwenConfig(**{f.name: getattr(QCFG, f.name) for f in fields(QCFG)})
LOGIT_ATOL = 1e-4   # fp64 slice logits (tests/test_parity_torch.py)


@pytest.fixture(scope="module")
def jax_model():
    model = vt.ModelForCausalLM(QCFG)
    params = model.init(jax.random.PRNGKey(2), dtype=jnp.float32)
    return model, params


def _np_tree(params, dtype=None):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if dtype is None else np.asarray(x, dtype),
        params)


@pytest.fixture(scope="module")
def torch_model(jax_model):
    return params_from_jax(_np_tree(jax_model[1]), TCFG, device="cpu")


# -- pool ops -----------------------------------------------------------------

@pytest.mark.parametrize("dead_first", [False, True])
def test_write_kv_dead_rows_never_collide(dead_first):
    """The oracle of tests/test_serving.py::test_write_kv_dead_rows_never_
    collide: a dead row aimed at a live row's slot is dropped."""
    pool = torch.zeros((4, 2, 2, 8))
    rows = [torch.full((2, 4), 7.0), torch.full((2, 4), -5.0)]
    blocks = [3, -1]
    if dead_first:
        rows, blocks = rows[::-1], blocks[::-1]
    k = torch.stack(rows)
    tpa.write_kv(pool, k, k, torch.tensor(blocks), torch.tensor([1, 1]))
    assert torch.all(pool[3, 0, 1] == 7.0) and torch.all(pool[3, 1, 1] == 7.0)
    assert float(pool.abs().sum()) == pytest.approx(7.0 * 16)


def test_write_kv_all_rows_dead_leaves_pool_unchanged():
    pool = torch.arange(4 * 2 * 2 * 8, dtype=torch.float32).reshape(4, 2, 2, 8)
    before = pool.clone()
    k = torch.full((3, 2, 4), -5.0)
    tpa.write_kv(pool, k, k, torch.tensor([-1, -1, -1]),
                 torch.tensor([1, 0, 1]))
    assert torch.equal(pool, before)


def test_write_gather_kv_match_jax():
    rng = np.random.default_rng(0)
    nb, bs, h_kv, d, t = 6, 4, 2, 8, 9
    pool = rng.standard_normal((nb, 2, bs, h_kv * d)).astype(np.float32)
    k = rng.standard_normal((t, h_kv, d)).astype(np.float32)
    v = rng.standard_normal((t, h_kv, d)).astype(np.float32)
    blocks = np.array([0, 5, -1, 2, 2, -1, 3, 1, 4], np.int32)
    offs = np.array([0, 3, 1, 0, 1, 2, 3, 2, 1], np.int32)
    ref = np.asarray(jpa.write_kv(jnp.asarray(pool), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(blocks),
                                  jnp.asarray(offs)))
    got = torch.from_numpy(pool.copy())
    tpa.write_kv(got, torch.from_numpy(k), torch.from_numpy(v),
                 torch.from_numpy(blocks), torch.from_numpy(offs))
    np.testing.assert_array_equal(got.numpy(), ref)
    tables = np.array([[5, 0, 3], [2, 2, 1]], np.int32)
    gk, gv = tpa.gather_kv(got, torch.from_numpy(tables).long(), h_kv)
    for lane in range(2):
        jk, jv = jpa.gather_kv(jnp.asarray(ref), jnp.asarray(tables[lane]),
                               h_kv)
        np.testing.assert_array_equal(gk[lane].numpy(), np.asarray(jk))
        np.testing.assert_array_equal(gv[lane].numpy(), np.asarray(jv))


# -- paged model: prefill + decode logits at fp64 ------------------------------

NB, BS, MAXB = 16, 4, 4


def _prefill_inputs(lanes, t_pad, n_pad=3):
    """lanes: list of (tokens, cached, table) -> the engine's prefill
    arrays (int32 numpy), padded to n_pad lanes (extra lanes dead)."""
    ids = np.zeros((n_pad, t_pad), np.int32)
    pos = np.zeros((n_pad, t_pad), np.int32)
    sb = np.full((n_pad, t_pad), -1, np.int32)
    so = np.zeros((n_pad, t_pad), np.int32)
    tables = np.full((n_pad, MAXB), -1, np.int32)
    ctx = np.zeros(n_pad, np.int32)
    true = np.zeros(n_pad, np.int32)
    for i, (toks, cached, table) in enumerate(lanes):
        t = len(toks)
        ids[i, :t] = toks
        pos[i] = np.minimum(cached + np.arange(t_pad), cached + t - 1)
        p = cached + np.arange(t)
        sb[i, :t] = np.asarray(table)[p // BS]
        so[i, :t] = p % BS
        tables[i, :len(table)] = table
        ctx[i] = cached + t
        true[i] = t
    return ids, pos, sb, so, tables, ctx, true


def _as_torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_prefill_decode_logits_fp64(jax_model):
    model, params = jax_model
    tmodel = params_from_jax(_np_tree(params, np.float64), TCFG,
                             device="cpu")
    rng = np.random.default_rng(1)
    p0 = rng.integers(0, 512, 7).tolist()
    p1 = rng.integers(0, 512, 10).tolist()
    t0, t1 = [3, 5, 10], [8, 1, 12, 14]
    steps = [
        # (prefill lanes, t_pad): lane 1 is chunked over two calls
        ([(p0, 0, t0), (p1[:6], 0, t1)], 8),
        ([(p1[6:], 6, t1)], 4),
    ]
    with jax.enable_x64(True):
        jparams = jax.tree_util.tree_map(
            lambda x: jnp.asarray(np.asarray(x, np.float64)), params)
        jpool = jpm.init_pool(QCFG, NB, BS, dtype=jnp.float64)
        tpool = tpm.init_pool(TCFG, NB, BS, dtype=torch.float64,
                              device="cpu")
        for lanes, t_pad in steps:
            arrays = _prefill_inputs(lanes, t_pad)
            jl, jpool = jpm.prefill(model, False, jparams, jpool,
                                    *map(jnp.asarray, arrays))
            tl = tpm.prefill(tmodel, tpool, *_as_torch(arrays))
            live = arrays[-1] > 0
            np.testing.assert_allclose(tl.numpy()[live],
                                       np.asarray(jl)[live],
                                       atol=LOGIT_ATOL, rtol=0)
        # three decode steps for both lanes + one dead lane
        toks = np.array([17, 99, 0], np.int32)
        pos = np.array([len(p0), len(p1), 0], np.int32)
        tables = np.full((3, MAXB), -1, np.int32)
        tables[0, :3], tables[1, :4] = t0, t1
        for _ in range(3):
            sb = np.array([tables[0, pos[0] // BS], tables[1, pos[1] // BS],
                           -1], np.int32)
            so = (pos % BS).astype(np.int32)
            sl = np.array([pos[0] + 1, pos[1] + 1, 0], np.int32)
            args = (toks, pos, tables, sl, sb, so)
            jl, jpool = jpm.decode(model, False, jparams, jpool,
                                   *map(jnp.asarray, args))
            tl = tpm.decode(tmodel, tpool, *map(torch.from_numpy, args))
            np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                                       atol=LOGIT_ATOL, rtol=0)
            toks = np.argmax(np.asarray(jl), -1).astype(np.int32)
            toks[2] = 0
            pos = pos + np.array([1, 1, 0], np.int32)
        # every slot of the pool agrees (deeper layers' K/V inherit the
        # JAX path's fp32 attention rounding)
        np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool["kv"]),
                                   atol=1e-6, rtol=0)


def test_decode_horizon_greedy_fp32(jax_model, torch_model):
    model, params = jax_model
    prompts = [[3, 17, 42, 9, 21], [5, 11, 8]]
    tables = np.full((3, MAXB), -1, np.int32)
    tables[0, :3], tables[1, :3] = [2, 7, 4], [9, 1, 6]
    lanes = [(p, 0, tables[i, :3]) for i, p in enumerate(prompts)]
    arrays = _prefill_inputs(lanes, 8)
    with jax.default_matmul_precision("highest"):
        jl, jpool = jpm.prefill(model, False, params,
                                jpm.init_pool(QCFG, NB, BS, jnp.float32),
                                *map(jnp.asarray, arrays))
    tpool = tpm.init_pool(TCFG, NB, BS, dtype=torch.float32, device="cpu")
    tl = tpm.prefill(torch_model, tpool, *_as_torch(arrays))
    first = np.argmax(np.asarray(jl), -1).astype(np.int32)
    assert first[:2].tolist() == tl.argmax(-1)[:2].tolist()
    pos = np.array([5, 3, 0], np.int32)
    live = np.array([True, True, False])
    budget = np.array([6, 4, 0], np.int32)
    with jax.default_matmul_precision("highest"):
        jgen, _, (jfin, _), _ = jpm.decode_horizon(
            model, False, params, jpool, jnp.asarray(first),
            jnp.asarray(pos), jnp.asarray(tables), jnp.asarray(live), 6,
            budget=jnp.asarray(budget))
    tgen, tfin, _ = tpm.decode_horizon(
        torch_model, tpool, torch.from_numpy(first), torch.from_numpy(pos),
        torch.from_numpy(tables), torch.from_numpy(live), 6,
        budget=torch.from_numpy(budget))
    np.testing.assert_array_equal(tgen.numpy(), np.asarray(jgen))
    np.testing.assert_array_equal(tfin.numpy()[:2], np.asarray(jfin)[:2])


@pytest.mark.parametrize("temperature,top_p,min_p", [
    (1.0, 1.0, 0.0), (0.7, 0.9, 0.0), (1.3, 0.5, 0.05),
    (np.array([0.5, 1.0, 2.0]), np.array([0.3, 0.95, 1.0]),
     np.array([0.0, 0.1, 0.02]))])
def test_sampling_mask_matches_jax(temperature, top_p, min_p):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((3, 64)) * 2).astype(np.float32)
    logits[0, 5] = logits[0, 9]          # an exact tie keeps index order
    ref = np.asarray(jpm.sampling_mask(jnp.asarray(logits), temperature,
                                       top_p, min_p))
    got = tpm.sampling_mask(torch.from_numpy(logits),
                            torch.as_tensor(temperature),
                            torch.as_tensor(top_p), torch.as_tensor(min_p))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_sample_tokens_respects_nucleus(torch_model):
    logits = torch.tensor([[0.0, 5.0, 1.0], [3.0, 0.0, 0.0]])
    g = torch.Generator().manual_seed(0)
    toks = tpm.sample_tokens(logits, g, 1.0, 1e-9)
    assert toks.tolist() == [1, 0]


# -- engine: greedy outputs equal the JAX engine's -----------------------------

ENG = dict(num_blocks=64, block_size=8, max_batch=4, max_blocks_per_seq=8,
           max_new_tokens=6, prefill_buckets=(8, 16))


def _engines(jax_model, torch_model, **kw):
    opts = {**ENG, **kw}
    model, params = jax_model
    jeng = JaxEngine(model, params, dtype=jnp.float32, kv_backend="python",
                     **opts)
    teng = tt.ContinuousBatchEngine(torch_model, dtype=torch.float32, **opts)
    return jeng, teng


def _run_both(jax_model, torch_model, prompts, **kw):
    jeng, teng = _engines(jax_model, torch_model, **kw)
    with jax.default_matmul_precision("highest"):
        jids = [jeng.submit(list(p)) for p in prompts]
        jout = jeng.run()
    tids = [teng.submit(list(p)) for p in prompts]
    tout = teng.run()
    return [jout[s] for s in jids], [tout[s] for s in tids], teng


SCENARIOS = {
    # tests/test_serving.py:76 dense-greedy prompts
    "dense_greedy": ([[3, 17, 42, 9], [5, 11], [3, 17, 42, 9, 21, 33]], {}),
    # l.135 more requests than batch slots
    "more_than_batch": ([[i + 1, i + 2, i + 3] for i in range(5)],
                        dict(max_batch=2, max_new_tokens=3,
                             prefill_buckets=(8,))),
    # l.240 prompt longer than the largest bucket: chunked prefill
    "chunked_prefill": ([[(7 * i + 3) % 512 for i in range(21)]],
                        dict(max_batch=2, max_new_tokens=4,
                             prefill_buckets=(8,))),
    # l.164 pool too small for both: preemption + recompute
    "preemption": ([[3, 17, 42, 9, 21, 33, 40, 2], [5, 11, 8, 30, 12, 44, 7]],
                   dict(num_blocks=5, block_size=4, max_batch=2,
                        max_new_tokens=8, prefill_buckets=(8,))),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_greedy_matches_jax(jax_model, torch_model, name):
    prompts, kw = SCENARIOS[name]
    jout, tout, teng = _run_both(jax_model, torch_model, prompts, **kw)
    assert tout == jout
    # every call through its bucket's PrefillGraph, eager on the CPU
    assert teng.counters["prefill_graph_calls"] == 0 < \
        teng.counters["prefill_calls"]
    if name == "preemption":
        assert teng.counters["preemptions"] > 0
    assert teng.kv.num_free() == teng.kv.num_blocks


def test_engine_prefix_cache_reuse_matches_jax(jax_model, torch_model):
    """l.91: the same prompt twice; the second run is served from the
    radix cache and still matches."""
    p1 = [3, 17, 42, 9, 21, 33, 40, 2, 7, 1]
    jeng, teng = _engines(jax_model, torch_model, max_new_tokens=4)
    outs = []
    for eng in (jeng, teng):
        with jax.default_matmul_precision("highest"):
            s1 = eng.submit(list(p1))
            o1 = eng.run()[s1]
            s2 = eng.submit(list(p1))
            o2 = eng.run()[s2]
        assert o1 == o2 and eng.kv.num_free() == 64
        outs.append(o1)
    assert outs[0] == outs[1]
    assert teng.counters["cached_prompt_tokens"] > 0


def test_engine_eos_stops_horizon_matches_jax(jax_model, torch_model):
    """l.199: eos mid-horizon truncates exactly at the first eos."""
    prompt = [3, 17, 42, 9]
    kw = dict(max_batch=2, max_new_tokens=10, prefill_buckets=(8,),
              decode_horizon=4)
    jfree, tfree, _ = _run_both(jax_model, torch_model, [prompt],
                                eos_token_id=9999, **kw)
    assert tfree == jfree and len(tfree[0]) == 10
    eos_tok = tfree[0][5]
    jcut, tcut, _ = _run_both(jax_model, torch_model, [prompt],
                              eos_token_id=eos_tok, **kw)
    assert tcut == jcut
    assert tcut[0] == tfree[0][:tfree[0].index(eos_tok) + 1]


def test_engine_stream_matches_run(jax_model, torch_model):
    """l.545: stream() yields exactly run()'s tokens with finished on each
    sequence's last token, and consumes the results."""
    prompts = SCENARIOS["dense_greedy"][0]
    jout, _, _ = _run_both(jax_model, torch_model, prompts)
    eng = tt.ContinuousBatchEngine(torch_model, dtype=torch.float32, **ENG)
    sids = [eng.submit(p) for p in prompts]
    got = {sid: [] for sid in sids}
    finished = set()
    for sid, tok, done in eng.stream():
        assert sid not in finished
        got[sid].append(tok)
        if done:
            finished.add(sid)
    assert finished == set(sids)
    assert [got[s] for s in sids] == jout
    assert eng.run() == {}


def test_engine_topp_sampling_degenerates_to_greedy(torch_model):
    """l.222: sampling with a vanishing nucleus keeps only the top token,
    so it reproduces greedy decoding through the whole sampling path."""
    kw = dict(ENG, max_batch=2, prefill_buckets=(8,))
    prompt = [3, 17, 42, 9, 21]
    outs = []
    for extra in ({}, dict(do_sample=True, temperature=0.7, top_p=1e-9)):
        eng = tt.ContinuousBatchEngine(torch_model, dtype=torch.float32,
                                       **kw, **extra)
        sid = eng.submit(prompt)
        outs.append(eng.run()[sid])
    assert outs[0] == outs[1] and len(outs[0]) == 6


def test_engine_abort_and_unported_args(torch_model):
    eng = tt.ContinuousBatchEngine(torch_model, dtype=torch.float32,
                                   **{**ENG, "decode_horizon": 2})
    a = eng.submit([3, 17, 42, 9])
    b = eng.submit([5, 11])
    c = eng.submit([7, 8, 9])
    assert eng.abort(c)                  # still waiting
    eng.step()
    assert a in eng.active
    assert eng.abort(a) and not eng.abort(a)   # mid-decode
    out = eng.run()
    assert list(out) == [b] and eng.kv.num_free() == 64
    with pytest.raises(NotImplementedError, match="draft_model"):
        tt.ContinuousBatchEngine(torch_model, draft_model=object())
    with pytest.raises(NotImplementedError, match="stop"):
        eng.submit([1, 2], stop=[[3]])
    with pytest.raises(TypeError):
        tt.ContinuousBatchEngine(torch_model, no_such_option=1)


def test_engine_cache_aware_admission_is_unported(torch_model):
    """The JAX engine takes ``cache_aware_admission``; until the port runs
    it, it raises ``NotImplementedError`` like every other unported
    feature (not ``TypeError``, as for a name the JAX engine lacks)."""
    with pytest.raises(NotImplementedError, match="cache_aware_admission"):
        tt.ContinuousBatchEngine(torch_model, cache_aware_admission=True)


@pytest.mark.parametrize("kw,missing", [
    (dict(num_attention_heads=16, num_key_value_heads=1), "K4 group > 8"),
    (dict(head_dim=256), "K1/K4 D=256"),
    (dict(head_dim=32), "K1/K4 D=32")])
def test_card_config_check_names_the_missing_kernel(kw, missing):
    """Configs whose attention the card's kernels do not take raise at the
    engine's construction on the card, naming the missing variant (the
    plain path on the CPU serves them, so ``QwenConfig`` accepts them)."""
    from vyomai_tpu_torch.serving.engine import check_card_config
    with pytest.raises(NotImplementedError, match=missing):
        check_card_config(tt.QwenConfig(**kw))
    check_card_config(tt.QwenConfig())
    check_card_config(tt.QwenConfig(head_dim=64))
