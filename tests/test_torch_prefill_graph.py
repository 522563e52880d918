"""The serving prefill as one ``paged_model.PrefillGraph`` a bucket, fed
from its staging set (``serving.engine`` ``_prefill_inputs``,
``prefill_graphs``).

On the CPU, with a tiny ``ModelForCausalLM`` and float, int8 and int4
pools, each call the engine makes through a bucket's graph gives the
logits and the pool that ``paged_model.prefill`` gives on inputs built
afresh from the same sequences, over every bucket, a chunked suffix and a
radix-cached prefix; no call is a replay. A one-request call after a
four-request call in the same bucket finds the other rows dead and gives
the logits and the K/V rows of a fresh engine.

The cases marked ``cuda`` hold the captured graph to the eager prefill on
the card, for the float, int8 and int4 pools and models: identical logits
and pool bytes, also for a replay after a larger call in the same bucket;
K1's, K8's and K9's launches counted per replay as the eager call counts
them; an engine's tokens through the graphs equal the same engine's with
``PrefillGraph.run`` replaced by the eager prefill, and every one of its
prefill calls a replay. They skip without a card."""

import numpy as np
import pytest
import torch

import vyomai_tpu_torch as tt
from vyomai_tpu_torch.ops import flash_attention as fa
from vyomai_tpu_torch.ops import quant_matmul as qm
from vyomai_tpu_torch.serving import paged_model as tpm
from vyomai_tpu_torch.serving.engine import ContinuousBatchEngine

torch.set_num_threads(1)

CFG = tt.QwenConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, head_dim=16,
                    max_position_embeddings=256, eos_token_id=9999)
ENG = dict(num_blocks=64, block_size=4, max_batch=4, max_blocks_per_seq=16,
           max_new_tokens=4, prefill_buckets=(8, 16), prefill_group=2,
           device="cpu")
POOLS = {"float32": torch.float32, "int8": torch.int8, "int4": "int4"}


@pytest.fixture(scope="module")
def model():
    return tt.ModelForCausalLM(CFG, device="cpu").init(
        torch.Generator().manual_seed(0))


def _clone(pool):
    return ({k: v.clone() for k, v in pool.items()}
            if isinstance(pool, dict) else pool.clone())


def _pool_equal(a, b):
    return all(x is None or torch.equal(x, y)
               for x, y in zip(tpm.pool_parts(a), tpm.pool_parts(b)))


def _dead_rows(n, t_pad, maxb):
    """A call's inputs as new arrays, in ``prefill``'s order, every row
    dead."""
    return {name: np.full(((n, maxb) if name == "tables" else (n,)
                           if name.endswith("_len") else (n, t_pad)), fill,
                          dtype=torch.empty(0, dtype=dtype).numpy().dtype)
            for name, (fill, dtype) in tpm.PrefillGraph.DEAD.items()}


def _fresh_inputs(eng, states, t_pad):
    """The call's inputs as new arrays, every row dead until a state's row
    is written: the reference for the engine's staging set."""
    bs, cap = eng.block_size, eng.prefill_buckets[-1]
    x = _dead_rows(eng.prefill_group, t_pad, eng.max_blocks_per_seq)
    for i, s in enumerate(states):
        cached = s.num_cached_tokens
        suffix = s.tokens[cached:min(s.prefill_len, cached + cap)]
        t = len(suffix)
        pos = cached + np.arange(t)
        x["ids"][i, :t] = suffix
        x["positions"][i] = np.minimum(cached + np.arange(t_pad),
                                       cached + max(t - 1, 0))
        x["slot_blocks"][i, :t] = np.asarray(s.block_table)[pos // bs]
        x["slot_offsets"][i, :t] = pos % bs
        x["tables"][i, :len(s.block_table)] = s.block_table
        x["ctx_len"][i] = s.prefill_len
        x["true_len"][i] = t
    return x


class _Recorder:
    """Wraps ``eng``'s ``_prefill_inputs`` and ``PrefillGraph.run`` (for
    the graphs of ``eng``'s pool) to record each call's bucket, its inputs
    built afresh, the static inputs, the pool before and after, and the
    logits."""

    def __init__(self, monkeypatch, eng):
        self.calls = []
        inputs_of, run = eng._prefill_inputs, tpm.PrefillGraph.run

        def prefill_inputs(states):
            graph, suffixes = inputs_of(states)
            t_pad = graph.inputs["ids"].shape[1]
            self.calls.append({"bucket": t_pad, "fresh": _fresh_inputs(
                eng, states, t_pad)})
            return graph, suffixes

        def recorded_run(graph):
            if graph.pool is not eng.pool:       # another engine's graph
                return run(graph)
            call = self.calls[-1]
            call["inputs"] = {k: v.clone() for k, v in graph.inputs.items()}
            call["before"] = _clone(graph.pool)
            call["logits"] = run(graph).clone()
            call["after"] = _clone(graph.pool)
            return graph.logits

        monkeypatch.setattr(eng, "_prefill_inputs", prefill_inputs)
        monkeypatch.setattr(tpm.PrefillGraph, "run", recorded_run)


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_graph_prefill_equals_fresh_eager_prefill_on_cpu(model, monkeypatch,
                                                         pool):
    eng = ContinuousBatchEngine(model, dtype=POOLS[pool], **ENG)
    rec = _Recorder(monkeypatch, eng)
    shared = list(range(100, 108))                  # two blocks of 4
    waves = [[[3, 17, 42, 9, 5], [5, 11, 7], list(range(1, 12)),
              list(range(20, 40))],                 # 20 > 16: chunked
             [shared + [7, 8, 9]]]
    eng.submit(shared)
    eng.run()
    for wave in waves:
        for p in wave:
            eng.submit(p)
        assert len(eng.run()) == len(wave)
    assert {c["bucket"] for c in rec.calls} == set(ENG["prefill_buckets"])
    assert any(c["fresh"]["ctx_len"][0] > c["fresh"]["true_len"][0]
               + 8 for c in rec.calls)              # a later chunk
    assert eng.counters["cached_prompt_tokens"] >= 8
    for c in rec.calls:
        fresh = {k: torch.from_numpy(v) for k, v in c["fresh"].items()}
        for k, v in fresh.items():
            assert torch.equal(c["inputs"][k], v), k
        pool_e = _clone(c["before"])
        want = tpm.prefill(model, pool_e, *fresh.values())
        assert torch.equal(c["logits"], want)
        assert _pool_equal(c["after"], pool_e)
    assert eng.counters["prefill_calls"] == len(rec.calls)
    assert eng.counters["prefill_graph_calls"] == 0
    assert all(g.graph is None for g in eng.prefill_graphs().values())


def test_one_request_after_four_finds_the_other_rows_dead(model,
                                                          monkeypatch):
    """A 4-row call, then a 1-row call in the same bucket: rows 1-3 of
    the second call are dead, and its logits and K/V rows are those of a
    fresh engine's first call."""
    kw = dict(ENG, prefill_group=4, radix_cache=False)
    rng = np.random.default_rng(3)
    four = [rng.integers(10, 500, n).tolist() for n in (16, 13, 10, 15)]
    one = rng.integers(10, 500, 12).tolist()
    recs = []
    for waves in ([four, [one]], [[one]]):
        eng = ContinuousBatchEngine(model, dtype=torch.float32, **kw)
        recs.append(_Recorder(monkeypatch, eng))
        for wave in waves:
            for p in wave:
                eng.submit(p)
            eng.run()
    used, fresh = recs[0].calls, recs[1].calls
    assert [c["bucket"] for c in used] == [16, 16] == [16] + [
        c["bucket"] for c in fresh]
    assert (used[0]["inputs"]["true_len"] > 0).all()
    a, b = used[1], fresh[0]
    for name, (fill, _) in tpm.PrefillGraph.DEAD.items():
        assert (a["inputs"][name][1:] == fill).all(), name
        if name not in ("slot_blocks", "tables"):   # block ids may differ
            assert torch.equal(a["inputs"][name], b["inputs"][name]), name
    assert torch.equal(a["logits"][0], b["logits"][0])
    t = int(a["inputs"]["true_len"][0])
    slots = [(c["inputs"]["slot_blocks"][0, :t].long(),
              c["inputs"]["slot_offsets"][0, :t]) for c in (a, b)]
    rows = [c["after"][:, blk, :, off] for c, (blk, off) in zip((a, b),
                                                                slots)]
    assert torch.equal(rows[0], rows[1])
    expect = a["before"].clone()
    expect[:, slots[0][0], :, slots[0][1]] = rows[0]
    assert torch.equal(a["after"], expect)     # nothing else was written


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
                max_position_embeddings=512, eos_token_id=9999)
CARD_NB, CARD_BS, CARD_MAXB, CARD_N, CARD_T = 64, 16, 8, 4, 64
CARD_CASES = [(torch.bfloat16, None, ()),
              (torch.int8, dict(bits=8), (qm.int8_matmul,)),
              ("int4", dict(bits=4, group_size=64), (qm.int4_matmul,))]
CARD_IDS = ["bf16", "int8", "int4"]


def _card_model(dev, quant=None):
    model = tt.ModelForCausalLM(tt.QwenConfig(**CARD_CFG), device=dev,
                                dtype=torch.bfloat16)
    model.init(torch.Generator(device=dev).manual_seed(0))
    model.requires_grad_(False)
    if quant is not None:
        tt.quantize_model(model, **quant)
    return model


def _card_pool(model, dev, dtype):
    """A pool of random contents, as a prefill finds a cached prefix."""
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


def _card_rows(rows):
    """``[(cached, suffix length)]`` -> the prefill inputs of
    ``CARD_N`` x ``CARD_T`` (rows past ``rows`` dead), each row on its own
    ``CARD_MAXB`` blocks, as numpy arrays in ``prefill``'s order."""
    x = _dead_rows(CARD_N, CARD_T, CARD_MAXB)
    rng = np.random.default_rng(len(rows))
    for i, (cached, t) in enumerate(rows):
        table = np.arange(CARD_MAXB) + i * CARD_MAXB
        pos = cached + np.arange(t)
        x["ids"][i, :t] = rng.integers(10, 1000, t)
        x["positions"][i] = np.minimum(cached + np.arange(CARD_T),
                                       cached + t - 1)
        x["slot_blocks"][i, :t] = table[pos // CARD_BS]
        x["slot_offsets"][i, :t] = pos % CARD_BS
        x["tables"][i] = table
        x["ctx_len"][i] = cached + t
        x["true_len"][i] = t
    return x


FULL = [(0, 50), (32, 20), (100, 28)]       # row 3 dead
ONE = [(40, 9)]


def _counts(wrappers):
    return [getattr(fn, name) for fn in (fa.flash_attention_fwd,) + wrappers
            for name in ("launches", "tc_launches") if hasattr(fn, name)]


def _graph_call(graph, rows):
    x = graph.stage()
    for name, v in _card_rows(rows).items():
        x[name][...] = v
    graph.start()
    return graph.run()


@pytest.mark.cuda
@pytest.mark.parametrize("pool_dtype,quant,wrappers", CARD_CASES,
                         ids=CARD_IDS)
def test_graph_prefill_equals_eager_prefill_on_card(cuda, pool_dtype, quant,
                                                    wrappers):
    """Identical logits and pool bytes, then again for a one-row replay
    after the three-row one; each kernel launched as often per replay as
    in the eager call."""
    model = _card_model(cuda, quant)
    pool = _card_pool(model, cuda, pool_dtype)
    pool_e, pool_g = pool, _clone(pool)
    graph = tpm.PrefillGraph(model, pool_g, CARD_N, CARD_T, CARD_MAXB)
    assert graph.graph is not None
    assert _pool_equal(pool_e, pool_g)      # the warm-up wrote nothing
    for rows in (FULL, ONE):
        inputs = [torch.from_numpy(v).to(cuda)
                  for v in _card_rows(rows).values()]
        c0 = _counts(wrappers)
        want = tpm.prefill(model, pool_e, *inputs).clone()
        c1 = _counts(wrappers)
        got = _graph_call(graph, rows)
        c2 = _counts(wrappers)
        torch.cuda.synchronize()
        assert torch.equal(want, got)
        assert _pool_equal(pool_e, pool_g)
        assert [b - a for a, b in zip(c0, c1)] == \
            [b - a for a, b in zip(c1, c2)]
        assert c1[0] - c0[0] == CARD_CFG["num_hidden_layers"]   # K1


@pytest.mark.cuda
def test_engine_through_graphs_equals_eager_prefill_on_card(cuda,
                                                            monkeypatch):
    """The same engine twice, once with ``PrefillGraph.run`` replaced by
    the eager prefill: the same tokens; a chunked suffix and a radix hit
    among the calls; every call of the graph engine a replay."""
    model = _card_model(cuda)
    rng = np.random.default_rng(0)
    shared = rng.integers(10, 1000, 48).tolist()
    waves = [[rng.integers(10, 1000, int(n)).tolist()
              for n in (20, 70, 150, 33, 100)],
             [shared + rng.integers(10, 1000, 9).tolist() for _ in range(3)]]

    def serve():
        eng = ContinuousBatchEngine(
            model, num_blocks=128, block_size=16, max_batch=4,
            max_blocks_per_seq=16, max_new_tokens=24, decode_horizon=8,
            prefill_buckets=(32, 64, 128), device=cuda)
        eng.submit(shared)
        eng.run()
        outs = []
        for wave in waves:
            sids = [eng.submit(p) for p in wave]
            done = eng.run()
            outs += [done[s] for s in sids]
        return outs, eng

    graph_out, eng = serve()
    c = eng.counters
    assert c["prefill_graph_calls"] == c["prefill_calls"] >= 4
    assert c["cached_prompt_tokens"] >= 3 * 48
    assert all(g.graph is not None for g in eng.prefill_graphs().values())
    monkeypatch.setattr(tpm.PrefillGraph, "run", lambda g: tpm.prefill(
        g.model, g.pool, *g.inputs.values()))
    eager_out, _ = serve()
    assert graph_out == eager_out
