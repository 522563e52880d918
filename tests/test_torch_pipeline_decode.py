"""Pipelined decode ticks and the captured decode step in the PyTorch port
(``serving.engine`` ``pipeline_decode``, ``serving.paged_model``
``decode_horizon(dead_mask=...)`` and ``HorizonGraph``).

On the CPU, at the small config of ``tests/test_pipeline_decode.py`` with
the JAX model's weights carried across by ``interop.params_from_jax``, the
port's engine with ``pipeline_decode=True`` must be token-exact against
itself with ``False`` and against the JAX engine (pipelined, its default)
in that file's scenarios that need no unported argument, with the same
decode and chained tick counts; ``decode_horizon`` must match the JAX one
in its tokens, final tokens and eos flags, chained from its own carry. An
abort in the middle of a chain must leave the other lanes' tokens as the
synchronous engine gives them and free every block.

The cases marked ``cuda`` hold the graph tick (``HorizonGraph``, a CUDA
graph of one step replayed) to the eager tick on the card, for the float,
int8 and int4 pools: identical tokens and pools; a sampled graph tick from
one seed twice; and the engine pipelined against synchronous. They skip
without a card. JAX is loaded by the ``jx`` fixture, so the card's cases
also run where JAX is not installed."""

from dataclasses import fields
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import vyomai_tpu_torch as tt
from vyomai_tpu_torch.ops import paged_decode as pdm
from vyomai_tpu_torch.ops import quant_matmul as qm
from vyomai_tpu_torch.serving import paged_model as tpm

torch.set_num_threads(1)

EOS = 7
NEVER = 9999          # an eos id outside the vocab: lanes run to max_new
ENG = dict(num_blocks=128, block_size=8, max_batch=4, max_blocks_per_seq=8,
           max_new_tokens=24, prefill_buckets=(16, 32), decode_horizon=6)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's model, params and engine at the config of
    ``tests/test_pipeline_decode.py``, and the same weights in the port."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import vyomai_tpu as vt
    from vyomai_tpu.serving import ContinuousBatchEngine
    from vyomai_tpu.serving import paged_model as jpm
    from vyomai_tpu_torch.interop import params_from_jax
    cfg = vt.QwenConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                        num_hidden_layers=2, num_attention_heads=4,
                        num_key_value_heads=2, head_dim=32,
                        max_position_embeddings=256, qk_norm=True,
                        eos_token_id=EOS, tie_word_embeddings=True)
    model = vt.ModelForCausalLM(cfg)
    params = model.init(jax.random.PRNGKey(2), dtype=jnp.float32)
    tcfg = tt.QwenConfig(**{f.name: getattr(cfg, f.name)
                            for f in fields(cfg)})
    torch_model = params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
    return SimpleNamespace(jax=jax, jnp=jnp, cfg=cfg, tcfg=tcfg, model=model,
                           params=params, engine=ContinuousBatchEngine,
                           jpm=jpm, torch_model=torch_model)


def _prompts(n, rng, lo=4, hi=30):
    return [list(rng.integers(10, 500, size=int(rng.integers(lo, hi))))
            for _ in range(n)]


def _port(jx, pipeline, **kw):
    return tt.ContinuousBatchEngine(jx.torch_model, dtype=torch.float32,
                                    pipeline_decode=pipeline,
                                    **{"eos_token_id": EOS, **ENG, **kw})


def _jax(jx, **kw):
    return jx.engine(jx.model, jx.params, dtype=jx.jnp.float32,
                     kv_backend="python", **{"eos_token_id": EOS, **ENG, **kw})


def _serve(eng, waves, jax_ctx=None):
    """Each wave's prompts (or ``(prompt, max_new)`` pairs) submitted and
    drained; returns every request's tokens, in submission order."""
    outs = []
    for wave in waves:
        sids = [eng.submit([int(t) for t in p], **kw) for p, kw in wave]
        if jax_ctx is None:
            done = eng.run()
        else:
            with jax_ctx("highest"):
                done = eng.run()
        outs += [done[s] for s in sids]
    return outs


def _all_three(jx, waves, **kw):
    """(port pipelined, port sync, JAX) outputs and engines."""
    waves = [[(p, {}) if isinstance(p, list) else p for p in w]
             for w in waves]
    piped, sync, jeng = _port(jx, True, **kw), _port(jx, False, **kw), \
        _jax(jx, **kw)
    outs = [_serve(piped, waves), _serve(sync, waves),
            _serve(jeng, waves, jx.jax.default_matmul_precision)]
    return outs, (piped, sync, jeng)


def _check_exact(outs, engines, chained: bool):
    (p_out, s_out, j_out), (piped, sync, jeng) = outs, engines
    assert p_out == s_out
    assert p_out == j_out
    for key in ("decode_ticks", "chained_ticks", "preemptions"):
        assert piped.counters[key] == jeng.counters.get(key, 0), key
    assert sync.counters["chained_ticks"] == 0
    if chained:
        assert piped.counters["chained_ticks"] > 0, \
            "pipeline never engaged"
    for eng in (piped, sync):
        assert eng.kv.num_free() == eng.kv.num_blocks
        assert not eng.active and not eng.waiting


def _eos_emitted_mid_run(jx, prompts):
    """A token that some lane emits part-way through a free run, as the
    eos of the run under test."""
    free = _serve(_port(jx, False, eos_token_id=NEVER),
                  [[(p, {}) for p in prompts]])
    return int(free[1][9])


def test_pipeline_greedy_eos_matches_sync_and_jax(jx):
    """tests/test_pipeline_decode.py::test_pipeline_matches_sync_greedy,
    with an eos that a lane emits (a chained tick carries it)."""
    prompts = _prompts(6, np.random.default_rng(0))
    eos = _eos_emitted_mid_run(jx, prompts)
    outs, engines = _all_three(jx, [prompts], eos_token_id=eos)
    _check_exact(outs, engines, chained=True)
    assert any(len(t) < ENG["max_new_tokens"] and t[-1] == eos
               for t in outs[0])


def test_pipeline_max_new_edge_matches_sync_and_jax(jx):
    """...::test_pipeline_matches_sync_ignore_eos_max_new: every lane runs
    to its max_new, some not a multiple of the horizon, one at 1."""
    prompts = _prompts(5, np.random.default_rng(1))
    wave = [(p, dict(max_new_tokens=n))
            for p, n in zip(prompts, (24, 23, 13, 1, 7))]
    outs, engines = _all_three(jx, [wave], eos_token_id=NEVER)
    _check_exact(outs, engines, chained=True)
    assert [len(t) for t in outs[0]] == [24, 23, 13, 1, 7]


def test_pipeline_block_cap_matches_sync_and_jax(jx):
    """...::test_pipeline_matches_sync_block_cap: lanes exhaust the block
    table and finish out of blocks; the chain drains before that harvest."""
    prompts = _prompts(4, np.random.default_rng(2), lo=20, hi=30)
    outs, engines = _all_three(jx, [prompts], eos_token_id=NEVER,
                               max_blocks_per_seq=5, max_new_tokens=40)
    _check_exact(outs, engines, chained=True)
    assert all(len(p) + len(t) == 40 for p, t in zip(prompts, outs[0]))


def test_pipeline_pool_pressure_matches_sync_and_jax(jx):
    """...::test_pipeline_under_pool_pressure_preemption: grants shrink and
    a lane is preempted; the chain refuses and the sync path handles it."""
    prompts = _prompts(4, np.random.default_rng(7), lo=8, hi=16)
    outs, engines = _all_three(jx, [prompts], eos_token_id=NEVER,
                               num_blocks=12)
    _check_exact(outs, engines, chained=False)
    assert engines[0].counters["preemptions"] > 0


def test_pipeline_radix_promotion_after_finish(jx):
    """...::test_pipeline_radix_promotion_after_finish: finished lanes
    promote their blocks while a stale tick may be in flight; a second
    wave on the same prefix reuses them."""
    rng = np.random.default_rng(8)
    shared = list(rng.integers(10, 500, size=12))
    rng9 = np.random.default_rng(9)
    wave1 = [shared + list(rng9.integers(10, 500, size=4)) for _ in range(2)]
    wave2 = [shared + [7 + i, 11, 13] for i in range(2)]
    outs, engines = _all_three(jx, [wave1, wave2])
    _check_exact(outs, engines, chained=False)
    assert engines[0].counters["cached_prompt_tokens"] > 0


def test_pipeline_staggered_submit_and_reuse_after_drain(jx):
    """...::test_pipeline_matches_sync_staggered_submit and
    ::test_pipeline_reuse_after_drain: admissions mid-stream break the
    chain, and a tick left in flight when everything finished does not
    touch the next waves."""
    rng = np.random.default_rng(3)
    prompts = _prompts(6, rng)
    outs = []
    for pipeline in (False, True):
        eng = _port(jx, pipeline, max_batch=3)
        sids = [eng.submit(p) for p in prompts[:3]]
        for _ in range(3):
            eng.step()
        sids += [eng.submit(p) for p in prompts[3:]]
        done = eng.run()
        outs.append([done[s] for s in sids])
    assert outs[0] == outs[1]
    waves = [_prompts(3, np.random.default_rng(6 + w)) for w in range(3)]
    got, engines = _all_three(jx, waves)
    _check_exact(got, engines, chained=True)


def test_abort_mid_chain_matches_sync(jx):
    """ADVICE r5: an abort while a chained tick is in flight frees the
    lane's blocks at once; the tick drops it at harvest, the other lanes'
    tokens are those of the synchronous engine with the same abort, and
    every block comes back."""
    prompts = _prompts(3, np.random.default_rng(11), lo=6, hi=12)
    outs = []
    for pipeline in (True, False):
        eng = _port(jx, pipeline, eos_token_id=NEVER)
        sids = [eng.submit(p) for p in prompts]
        for _ in range(3):
            eng.step()
        if pipeline:
            assert eng._inflight is not None
            assert eng.counters["chained_ticks"] > 0
        assert eng.abort(sids[1])
        done = eng.run()
        assert sorted(done) == [sids[0], sids[2]]
        assert eng.kv.num_free() == eng.kv.num_blocks
        outs.append([done[sids[0]], done[sids[2]]])
    assert outs[0] == outs[1]
    assert all(len(t) == ENG["max_new_tokens"] for t in outs[0])


# -- decode_horizon(dead_mask=...) against the JAX one ------------------------

NB, BS, MAXB = 16, 4, 6


def test_decode_horizon_dead_mask_chain_matches_jax(jx):
    """Two chained ticks: the second starts from the first's carry (final
    tokens, eos flags as ``dead_mask``). A lane killed by eos in the first
    stays dead and flagged; a budget-frozen lane revives; a lane dead from
    the start (``dead_mask``) never runs."""
    jnp, jpm = jx.jnp, jx.jpm
    rng = np.random.default_rng(4)
    lens = [5, 3, 4, 6]
    tables = np.full((4, MAXB), -1, np.int32)
    tables[:, :4] = rng.permutation(NB)[:16].reshape(4, 4)
    t_pad = 8
    ids = np.zeros((4, t_pad), np.int32)
    pos = np.zeros((4, t_pad), np.int32)
    sb = np.full((4, t_pad), -1, np.int32)
    so = np.zeros((4, t_pad), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(10, 500, n)
        pos[i] = np.minimum(np.arange(t_pad), n - 1)
        sb[i, :n] = tables[i][np.arange(n) // BS]
        so[i, :n] = np.arange(n) % BS
    ctx = np.asarray(lens, np.int32)
    pre = (ids, pos, sb, so, tables, ctx, ctx)
    with jx.jax.default_matmul_precision("highest"):
        jl, jpool = jpm.prefill(jx.model, False, jx.params,
                                jpm.init_pool(jx.cfg, NB, BS, jnp.float32),
                                *map(jnp.asarray, pre))
    tpool = tpm.init_pool(jx.tcfg, NB, BS, dtype=torch.float32, device="cpu")
    tl = tpm.prefill(jx.torch_model, tpool,
                     *[torch.from_numpy(a) for a in pre])
    first = np.argmax(np.asarray(jl), -1).astype(np.int32)
    assert first.tolist() == tl.argmax(-1).tolist()
    # eos: the token lane 0 emits at its second step in a free tick
    free, _, _ = tpm.decode_horizon(
        jx.torch_model, tpool.clone(), torch.from_numpy(first),
        torch.from_numpy(ctx.astype(np.int64)),
        torch.from_numpy(tables), torch.ones(4, dtype=torch.bool), 3)
    eos = int(free[0, 1])
    live = np.ones(4, bool)
    dead = np.array([False, False, False, True])
    budget = np.array([3, 2, 3, 3], np.int32)
    toks, p = first, ctx.astype(np.int64)
    for tick in range(2):
        with jx.jax.default_matmul_precision("highest"):
            jgen, _, (jfin, jdead), jpool = jpm.decode_horizon(
                jx.model, False, jx.params, jpool, jnp.asarray(toks),
                jnp.asarray(p.astype(np.int32)), jnp.asarray(tables),
                jnp.asarray(live), 3, eos=eos, budget=jnp.asarray(budget),
                dead_mask=jnp.asarray(dead))
        tgen, tfin, tdead = tpm.decode_horizon(
            jx.torch_model, tpool, torch.from_numpy(toks),
            torch.from_numpy(p), torch.from_numpy(tables),
            torch.from_numpy(live), 3, eos=eos,
            budget=torch.from_numpy(budget), dead_mask=torch.from_numpy(dead))
        np.testing.assert_array_equal(tgen.numpy(), np.asarray(jgen))
        np.testing.assert_array_equal(tfin.numpy(), np.asarray(jfin))
        np.testing.assert_array_equal(tdead.numpy(), np.asarray(jdead))
        toks, dead = tfin.numpy(), tdead.numpy()
        p = p + budget
    assert dead.tolist() == [True, False, False, True]
    assert (tgen.numpy()[0] == 0).all() and (tgen.numpy()[3] == 0).all()
    assert (tgen.numpy()[1, :2] != 0).all()      # budget-frozen, revived
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool["kv"]),
                               atol=1e-5, rtol=0)


def test_horizon_graph_on_cpu_chains_like_decode_horizon(jx):
    """On the CPU ``HorizonGraph`` runs the same step eagerly over its
    static buffers; a fresh tick then a chained one (``tokens=None``)
    give ``decode_horizon``'s tokens, carry and pool."""
    cfg = jx.tcfg
    rng = np.random.default_rng(12)
    pools = [tpm.init_pool(cfg, 4 * MAXB, BS, dtype=torch.float32,
                           device="cpu") for _ in range(2)]
    fill = torch.from_numpy(rng.standard_normal(
        tuple(pools[0].shape)).astype(np.float32)) * 0.5
    for pool in pools:
        pool.copy_(fill)
    tables = torch.from_numpy(
        rng.permutation(4 * MAXB).reshape(4, MAXB).astype(np.int32))
    toks = torch.from_numpy(rng.integers(10, 500, 4).astype(np.int32))
    pos = torch.tensor([3, 7, 1, 11])
    live = torch.tensor([True, True, False, True])
    budget = torch.tensor([4, 2, 4, 4], dtype=torch.int32)
    graph = tpm.HorizonGraph(jx.torch_model, pools[1], 4, MAXB, 4, eos=EOS)
    assert graph.graph is None
    carry = None
    for tick in range(2):
        want = tpm.decode_horizon(
            jx.torch_model, pools[0], toks if carry is None else carry[0],
            pos, tables, live, 4, eos=EOS, budget=budget,
            dead_mask=None if carry is None else carry[1])
        graph.start(pos, tables, live, budget,
                    tokens=toks if carry is None else None)
        got = graph.run(4)
        for a, b in zip(want, got):
            assert torch.equal(a, b)
        carry = [t.clone() for t in want[1:]]
        pos = pos + budget
    assert torch.equal(pools[0], pools[1])


# -- on the card --------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs and the kernels have "
                    "no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CARD_CFG = dict(vocab_size=1024, hidden_size=256, intermediate_size=512,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, head_dim=64,
                max_position_embeddings=512, eos_token_id=NEVER)
CARD_B, CARD_NB, CARD_BS, CARD_MAXB, CARD_H = 4, 64, 16, 8, 8


def _card_model(dev, quant=None):
    model = tt.ModelForCausalLM(tt.QwenConfig(**CARD_CFG), device=dev,
                                dtype=torch.bfloat16)
    model.init(torch.Generator(device=dev).manual_seed(0))
    model.requires_grad_(False)
    if quant is not None:
        tt.quantize_model(model, **quant)
    return model


def _card_pool(model, dev, dtype):
    """A pool of random contents (a float pool's values, a quantized
    pool's bytes and scales), as a tick would find it."""
    pool = tpm.init_pool(model.config, CARD_NB, CARD_BS, dtype=dtype,
                         device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    for t in tpm.pool_parts(pool):
        if t is None:
            continue
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g,
                                  device=dev, dtype=torch.int8))
        elif t.dtype == torch.float32 and isinstance(pool, dict):
            t.copy_(torch.rand(t.shape, generator=g, device=dev) * 0.02)
        else:
            t.copy_(torch.randn(t.shape, generator=g, device=dev))
    return pool


def _clone(pool):
    return ({k: v.clone() for k, v in pool.items()}
            if isinstance(pool, dict) else pool.clone())


def _card_tick(dev):
    tables = torch.arange(CARD_B * CARD_MAXB, dtype=torch.int32,
                          device=dev).reshape(CARD_B, CARD_MAXB)
    return dict(
        tokens=torch.tensor([11, 22, 33, 44], dtype=torch.int32, device=dev),
        positions=torch.tensor([40, 70, 3, 100], device=dev), tables=tables,
        live=torch.tensor([True, True, False, True], device=dev),
        budget=torch.tensor([8, 3, 8, 5], dtype=torch.int32, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("pool_dtype,quant,wrappers", [
    (torch.bfloat16, None, (pdm.paged_decode,)),
    (torch.int8, dict(bits=8), (pdm.paged_decode_int8, qm.int8_matmul)),
    ("int4", dict(bits=4, group_size=64),
     (pdm.paged_decode_int4, qm.int4_matmul))],
    ids=["bf16", "int8", "int4"])
def test_graph_tick_equals_eager_tick_on_card(cuda, pool_dtype, quant,
                                               wrappers):
    """The same kernels in the same order: identical tokens, carry and
    pool; K4 (and K8/K9 on the quantized models) counted once a layer per
    replayed step."""
    model = _card_model(cuda, quant)
    pool = _card_pool(model, cuda, pool_dtype)
    pool_e, pool_g = _clone(pool), _clone(pool)
    x = _card_tick(cuda)
    want = tpm.decode_horizon(model, pool_e, x["tokens"], x["positions"],
                              x["tables"], x["live"], CARD_H,
                              budget=x["budget"])
    graph = tpm.HorizonGraph(model, pool_g, CARD_B, CARD_MAXB, CARD_H)
    assert graph.graph is not None
    before = [fn.launches for fn in wrappers]
    graph.start(x["positions"], x["tables"], x["live"], x["budget"],
                tokens=x["tokens"])
    got = graph.run(8)
    torch.cuda.synchronize()
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    for a, b in zip(tpm.pool_parts(pool_e), tpm.pool_parts(pool_g)):
        assert a is None or torch.equal(a, b)
    layers = CARD_CFG["num_hidden_layers"]
    assert wrappers[0].launches - before[0] == 8 * layers
    for fn, b in zip(wrappers[1:], before[1:]):
        assert fn.launches - b >= 8 * layers


@pytest.mark.cuda
def test_sampled_graph_tick_is_reproducible_on_card(cuda):
    """A sampled graph tick from one generator seed gives the same tokens
    twice, and the eager tick's from the same seed."""
    model = _card_model(cuda)
    pool = _card_pool(model, cuda, torch.bfloat16)
    x = _card_tick(cuda)
    samp = tpm.sampling_tensors(cuda, 0.9, 0.95, 0.0)
    runs = []
    for _ in range(2):
        gen = torch.Generator(device=cuda).manual_seed(42)
        graph = tpm.HorizonGraph(model, _clone(pool), CARD_B, CARD_MAXB,
                                 CARD_H, do_sample=True, generator=gen,
                                 samp=samp)
        graph.start(x["positions"], x["tables"], x["live"], x["budget"],
                    tokens=x["tokens"])
        runs.append(graph.run(8)[0].clone())
    gen = torch.Generator(device=cuda).manual_seed(42)
    eager = tpm.decode_horizon(model, _clone(pool), x["tokens"],
                               x["positions"], x["tables"], x["live"],
                               CARD_H, do_sample=True, generator=gen,
                               temperature=0.9, top_p=0.95,
                               budget=x["budget"])[0]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0], eager)


@pytest.mark.cuda
def test_engine_pipelined_equals_synchronous_on_card(cuda):
    model = _card_model(cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(10, 1000, int(n)).tolist()
               for n in rng.integers(20, 120, 6)]
    outs, chained = [], []
    for pipeline in (True, False):
        eng = tt.ContinuousBatchEngine(
            model, num_blocks=128, block_size=16, max_batch=4,
            max_blocks_per_seq=16, max_new_tokens=40, decode_horizon=8,
            prefill_buckets=(32, 64, 128), pipeline_decode=pipeline,
            device=cuda)
        sids = [eng.submit(p) for p in prompts]
        done = eng.run()
        outs.append([done[s] for s in sids])
        chained.append(eng.counters["chained_ticks"])
        assert eng._graph.graph is not None
    assert outs[0] == outs[1]
    assert chained[0] > 0 and chained[1] == 0
