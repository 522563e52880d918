"""The ``deepseek_v3`` family (Moonlight-16B-A3B): its layout and counts at
the published widths, its float32 reference against the port at a tiny
size on the CPU (a shared prefix computed once changes nothing), a whole
tiny run through the harness over a mix of shared documents, and the
three readers of the engine's latent-row counters on a synthetic slice."""

import numpy as np
import pytest
import torch

from gpubench import program, run as R, spec, work
from gpubench.families import deepseek_v3 as F
from gpubench.metrics import _k13
from gpubench.reference import deepseek_v3 as ref
from gpubench.tests import tiny

SEED = 2 ** 31 + 241
PUBLISHED = spec.load_json(spec.HERE / "configs/moonlight-16b-a3b.json")
TINY = dict(
    tiny.CONFIG, family="deepseek_v3", hidden_size=64, intermediate_size=96,
    moe_intermediate_size=32, num_hidden_layers=3, num_attention_heads=4,
    num_key_value_heads=4, n_routed_experts=8, num_experts_per_tok=2,
    n_shared_experts=2, kv_lora_rank=32, qk_nope_head_dim=16,
    qk_rope_head_dim=8, v_head_dim=16, first_k_dense_replace=1, n_group=1,
    topk_group=1, norm_topk_prob=True, routed_scaling_factor=2.446,
    rms_norm_eps=1e-5, tie_word_embeddings=False,
    control={"weights": {"quant": {"bits": 8}}, "pool": {"dtype": "float32"}})
del TINY["head_dim"], TINY["qk_norm"]


def test_published_layout_and_counts():
    total = sum(int(np.prod(s)) for g in F.groups(PUBLISHED)
                for _, s, _ in F.shapes(PUBLISHED, g))
    assert total == 15_960_110_208                      # 15.96 B
    d = work.dims(PUBLISHED)
    assert (d["attn_layers"], d["layers"]) == (27, 27)
    # active matmul weights a token: 2.58 B (the router, 6 of 64 experts
    # and the shared one, kv_b once a token), the head last
    mats = sum(n * k for n, k in F.linears(PUBLISHED))
    assert mats == 2_579_103_744
    assert F.linears(PUBLISHED)[-1] == (163840, 2048)
    assert work.token_flops(PUBLISHED, 0) == 2.0 * mats
    # the latent pool: one row of 512 + 64 bf16 a token and layer
    latent = PUBLISHED["kv_lora_rank"] + PUBLISHED["qk_rope_head_dim"]
    assert 27 * latent * 2 == 31_104


def test_groups_hold_what_the_port_model_holds():
    model = F.port_model(TINY, "cpu", torch.float32)
    named = {n: tuple(p.shape) for n, p in model.named_parameters()}
    laid = {n: s for g in F.groups(TINY) for n, s, _ in F.shapes(TINY, g)}
    assert laid == named


def _served(model, prompts, new):
    seqs = []
    for p in prompts:
        ids = list(p)
        with torch.no_grad():
            for _ in range(new):
                logits = model(torch.tensor([ids])).logits[0, -1]
                ids.append(int(logits.argmax()))
        seqs.append((np.array(ids), len(p)))
    return seqs


def test_reference_matches_the_port_and_shares_prefixes_exactly():
    """The port's float32 model built from the seed serves tokens that are
    the reference's best, to float32 rounding, over three requests that
    share a 40-token document and one that does not; the shared rows,
    computed once, give the gaps and margins each request gives alone."""
    model = program.build_model(TINY, SEED, "cpu")
    rng = np.random.default_rng(3)
    doc = rng.integers(0, 256, 40)
    prompts = [np.concatenate([doc, rng.integers(0, 256, n)])
               for n in (3, 7, 1)] + [rng.integers(0, 256, 9)]
    seqs = _served(model, prompts, 5)
    assert ref.shared_prefixes(seqs) == [40, 40, 40, 0]
    kw = dict(weight_dtype=torch.float32, std=0.02, quant=None)
    gaps, margins = ref.margins_and_gaps(TINY, SEED, seqs, "cpu", **kw)
    assert [g.shape for g in gaps] == [(5,)] * 4
    assert [m.shape for m in margins] == [(6,)] * 4
    assert max(g.max() for g in gaps) <= 1e-5
    alone = [ref.margins_and_gaps(TINY, SEED, [s], "cpu", **kw)
             for s in seqs[:3]]
    for (g1, m1), g, m in zip(alone, gaps, margins):
        assert np.allclose(g1[0], g, atol=1e-5)
        assert np.allclose(m1[0], m, atol=1e-6)
    toks, n = seqs[1]
    toks = toks.copy()
    toks[-2] = (toks[-2] + 1) % 256
    altered, _ = ref.margins_and_gaps(TINY, SEED, [(toks, n)], "cpu", **kw)
    assert altered[0][-2] > 1e-4
    assert ref.margins_and_gaps(TINY, SEED, [], "cpu", **kw) == ([], [])


def test_margins_are_the_least_over_the_moe_layers(monkeypatch):
    """Each position's margin is the least, over the MoE layers, of its
    k-th less (k+1)-th best choice score, as the port's router scores
    them."""
    from vyomai_tpu_torch.models import deepseek_v3 as port
    model = program.build_model(TINY, SEED, "cpu")
    toks = np.random.default_rng(4).integers(0, 256, 9)
    _, (margin,) = ref.margins_and_gaps(
        TINY, SEED, [(toks, 4)], "cpu", weight_dtype=torch.float32,
        std=0.02, quant=None)
    want = torch.full((9,), float("inf"))
    apply = port.moe_apply

    def scored(mod, x, *a, **k):
        s = torch.sigmoid(x.reshape(-1, x.shape[-1]) @ mod.gate.weight.T)
        top = (s + mod.expert_bias).topk(3, -1).values
        want.copy_(torch.minimum(want, top[:, 1] - top[:, 2]))
        return apply(mod, x, *a, **k)
    monkeypatch.setattr(port, "moe_apply", scored)
    with torch.no_grad():
        model(torch.as_tensor(toks)[None])
    assert np.allclose(margin, want.numpy()[3:], atol=1e-6)


def test_a_tiny_docqa_run_is_correct_and_reads_its_counters():
    """A backlog over shared documents on the CPU through the harness (a
    tiny cell sets no limits): every served token is the reference's best
    to float32 rounding, the radix cache serves the documents, and the
    latent counters move."""
    cell = tiny.cell("backlog", **{k: v for k, v in TINY.items()})
    cell["traffic"]["shared_prefix"] = {
        "count": 2, "length": {"dist": "uniform", "min": 20, "max": 28},
        "pick": {"dist": "zipf", "s": 1.1}}
    cell["traffic"]["requests"] = 200
    result, checks, run = R.run_cell(cell, SEED, 3.0, False, device="cpu")
    assert checks["max_logit_gap"]["value"] <= 1e-4, checks
    assert checks["sampled_tokens"]["value"] >= 1
    assert all(checks[k]["value"] == 0 for k in ("unfinished",
                                                  "wrong_length",
                                                  "outside_vocab"))
    c0, c1 = run["counters"]["open"], run["counters"]["close"]
    assert c1["cached_prompt_tokens"] > c0["cached_prompt_tokens"]
    assert c1["mla_distinct_rows_decode"] > c0["mla_distinct_rows_decode"]
    assert c1["mla_rows_decode"] > c1["mla_distinct_rows_decode"]


# -- the readers on a synthetic slice ----------------------------------------

G = "cudaGraphLaunch"
ROWS_D, DIST_D, PAIRS_P, ROWS_P, TOK_P = 7_500_000, 1_200_000, 3_000_000, \
    30_000, 500


def _run(counters=True):
    keys = {"mla_rows_decode": ROWS_D, "mla_distinct_rows_decode": DIST_D,
            "mla_pairs_prefill": PAIRS_P, "mla_rows_prefill": ROWS_P,
            "prefill_tokens": TOK_P}
    snaps = {e: {} for e in ("open", "begin", "end", "close")}
    if counters:
        snaps = {"open": {k: 3 for k in keys}, "begin": {k: 5 for k in keys},
                 "end": {k: 5 + v for k, v in keys.items()},
                 "close": {k: 50 + v for k, v in keys.items()}}
    # 10 requests, 40 decode tokens each inside the slice (20-24 s)
    reqs = [{"prompt": np.zeros(6000), "first": 19.0,
             "times": [19.0] + [20.0 + 0.1 * j for j in range(40)]}
            for _ in range(10)]
    return {"counters": snaps, "t0": 0.0, "t1": 51.0, "slice": (20.0, 24.0),
            "pool": "bfloat16", "block_size": 16, "lanes": 128,
            "requests": reqs}


def _trace():
    """Two decode replays of K13's pair, 0.010 + 0.001 s each, and one
    prefill replay with K13's prefill kernel, 0.004 s."""
    ks = []
    for c in (1, 2):
        ks += [("k13_decode_split_kernel", c, 0.010),
               ("k13_decode_combine_kernel", c, 0.001)]
    ks += [("k13_prefill_kernel", 3, 0.004)]
    return {"kernels": [(n, 1.0, 1.0 + s, G, c) for n, c, s in ks]}


def _share(pairs, rows, tokens, secs):
    fl = 2.0 * 16 * 1088 * pairs * 27
    nb = 27 * (rows * 1152 + tokens * 16 * 1088 * 2 + 4.0 * rows / 16)
    return 100.0 * work.bound_s(fl, nb) / secs


def test_k13_counts_at_the_published_widths():
    flops, nbytes = _k13.counts(PUBLISHED, 1, 1, 0)
    assert flops == 2 * 16 * (2 * 512 + 64) * 27          # 34,816 a layer
    assert nbytes == 27 * (1152 + 0.25)


def test_k13_readers_read_their_phase_exactly():
    mods = spec.layer_metrics()
    cell = {"config": PUBLISHED}
    run, trace = _run(), _trace()
    assert mods["k13_roofline.decode.tok_s"].read(run, trace, cell) == \
        pytest.approx(_share(ROWS_D, DIST_D, 400, 0.022))
    assert mods["k13_roofline.prefill.tok_s"].read(run, trace, cell) == \
        pytest.approx(_share(PAIRS_P, ROWS_P, TOK_P, 0.004))
    assert mods["latent_lanes_per_row.tok_s"].read(run, trace, cell) == \
        pytest.approx(ROWS_D / DIST_D)


@pytest.mark.parametrize("name", ["k13_roofline.decode.tok_s",
                                  "k13_roofline.prefill.tok_s",
                                  "latent_lanes_per_row.tok_s"])
def test_readers_are_none_without_their_counters(name):
    """The parent's engine has no latent counters: nothing to read, no
    raise."""
    mod = spec.layer_metrics()[name]
    cell = {"config": PUBLISHED}
    assert mod.read(_run(counters=False), _trace(), cell) is None
    if mod.SOURCE == "device_trace":
        assert mod.read(_run(), None, cell) is None
        assert mod.read(_run(), {"kernels": []}, cell) is None


def test_entries_name_the_new_cell():
    bench = spec.benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in ("k13_roofline.decode.tok_s", "k13_roofline.prefill.tok_s",
                 "latent_lanes_per_row.tok_s", "expert_rows_per_visit.tok_s",
                 "idle_share.tok_s", "mfu.tok_s", "chained_tick_share",
                 "prefill_time_share.tok_s", "tick_host_ms.tok_s"):
        assert "moonlight-16b-a3b.docqa" in entries[name]["workloads"], name
    for name in ("prefill_graph_share.tok_s", "fused_norm_share.tok_s",
                 "k4_roofline.tok_s", "k11_roofline.decode.tok_s"):
        assert "moonlight-16b-a3b.docqa" not in entries[name]["workloads"]
    cell = spec.cell("moonlight-16b-a3b.docqa")
    assert cell["config"]["family"] == "deepseek_v3"
    assert [m["name"] for m in cell["end_to_end"]] == ["output_tok_s",
                                                       "setup_s"]
    mix = cell["traffic"]
    assert mix["shared_prefix"]["count"] == 32
    from gpubench import traffic as T
    assert T.longest(mix) == PUBLISHED["max_position_embeddings"]
