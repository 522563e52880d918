"""The ``lfm2_moe`` family (LFM2-8B-A1B): its layout and counts at the
published widths, its float32 reference against the port at a tiny size
on the CPU, a whole tiny run through the harness, and the three readers of
the engine's MoE counters on a synthetic slice."""

import numpy as np
import pytest
import torch

from gpubench import program, run as R, spec, work, weights as W
from gpubench.families import lfm2_moe as F
from gpubench.reference import lfm2_moe as ref
from gpubench.tests import tiny

SEED = 2 ** 31 + 191
PUBLISHED = spec.load_json(spec.HERE / "configs/lfm2-8b-a1b.json")
TINY = dict(
    tiny.CONFIG, family="lfm2_moe", hidden_size=64, intermediate_size=96,
    moe_intermediate_size=64, num_hidden_layers=4, num_attention_heads=4,
    num_key_value_heads=2, norm_eps=1e-5, conv_L_cache=3,
    layer_types=["conv", "full_attention", "conv", "full_attention"],
    num_dense_layers=1, num_experts=8, num_experts_per_tok=2,
    use_expert_bias=True, norm_topk_prob=True, routed_scaling_factor=1.0,
    engine=dict(tiny.CONFIG["engine"], radix_cache=False))
del TINY["head_dim"], TINY["rms_norm_eps"], TINY["qk_norm"]


def test_published_layout_and_counts():
    total = sum(int(np.prod(s)) for g in F.groups(PUBLISHED)
                for _, s, _ in F.shapes(PUBLISHED, g))
    assert total == 8_339_930_560                       # 8.34 B
    d = work.dims(PUBLISHED)
    assert (d["attn_layers"], d["hd"], d["layers"]) == (6, 64, 24)
    # one token's KV: 6 layers x k and v x 8 heads x 64 x 2 bytes
    _, kv_bytes = work.paged_decode(PUBLISHED, 1, "bfloat16", 16)
    act = 6 * 2 * 32 * 64 * 2                  # q in, out, each layer
    assert kv_bytes - act - 6 * (4 + 4) == 12_288
    # active matmul weights a token: 1.56 B (router and 4 of 32 experts)
    mats = sum(n * k for n, k in F.linears(PUBLISHED))
    assert mats == 1_557_528_576
    assert F.linears(PUBLISHED)[-1] == (65536, 2048)
    assert work.token_flops(PUBLISHED, 0) == 2.0 * mats


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


def test_reference_matches_the_port():
    """The port's float32 model built from the seed serves tokens that are
    the reference's best, to float32 rounding; one changed token reads a
    gap."""
    model = program.build_model(TINY, SEED, "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, n) for n in (5, 11, 17)]
    seqs = _served(model, prompts, 6)
    kw = dict(weight_dtype=torch.float32, std=0.02, quant=None)
    gaps, margins = ref.margins_and_gaps(TINY, SEED, seqs, "cpu", **kw)
    assert [g.shape for g in gaps] == [(6,)] * 3
    assert [m.shape for m in margins] == [(len(t),) for t, _ in seqs]
    # float32 sums in another order: the best logit ties within 1e-5
    assert max(g.max() for g in gaps) <= 1e-5
    toks, n = seqs[1]
    toks = toks.copy()
    toks[-2] = (toks[-2] + 1) % 256
    altered, _ = ref.margins_and_gaps(TINY, SEED, [(toks, n)], "cpu", **kw)
    assert altered[0][-2] > 1e-4


def test_margins_are_the_least_over_the_moe_layers(monkeypatch):
    """Each position's margin is the least, over the MoE layers, of its
    4th less 5th best score (here its 2nd less 3rd), as the port's router
    scores them."""
    from vyomai_tpu_torch.models import lfm2
    model = program.build_model(TINY, SEED, "cpu")
    toks = np.random.default_rng(4).integers(0, 256, 9)
    _, (margin,) = ref.margins_and_gaps(
        TINY, SEED, [(toks, 8)], "cpu", weight_dtype=torch.float32,
        std=0.02, quant=None)
    want = torch.full((9,), float("inf"))
    apply = lfm2.moe_apply

    def scored(mod, x, *a, **k):
        s = torch.sigmoid(x.reshape(-1, x.shape[-1]) @ mod.gate.weight.T)
        top = (s + mod.expert_bias).topk(3, -1).values
        want.copy_(torch.minimum(want, top[:, 1] - top[:, 2]))
        return apply(mod, x, *a, **k)
    monkeypatch.setattr(lfm2, "moe_apply", scored)
    with torch.no_grad():
        model(torch.as_tensor(toks)[None])
    assert want.isfinite().all()
    assert np.allclose(margin, want.numpy(), atol=1e-6)


def test_clear_reads_tokens_whose_routing_is_clear():
    # positions 0..9, the prompt 4 tokens: served tokens chosen at 3..8
    margin = np.array([1, 1, 1, 1, 0, 1, 1, 1, 0, 1], dtype=np.float32)
    assert ref.clear(margin, 4, 6, 0.5).tolist() == [
        True, False, True, True, True, False]
    assert ref.clear(margin, 4, 6, 0.0).all()


def test_served_gaps_read_only_the_clear_tokens(monkeypatch):
    gaps = [np.arange(6, dtype=np.float64)]
    margin = np.array([1, 1, 1, 1, 0, 1, 1, 1, 0, 1], dtype=np.float32)
    monkeypatch.setattr(ref, "margins_and_gaps",
                        lambda *a, **k: (gaps, [margin]))
    monkeypatch.setattr(ref, "ROUTING_MARGIN", 0.5)
    (got,) = ref.served_gaps(TINY, SEED, [(np.zeros(10), 4)], "cpu")
    assert got.tolist() == [0.0, 2.0, 3.0, 4.0]


# -- the readers on a synthetic slice ----------------------------------------

G = "cudaGraphLaunch"
K1, K11 = "vyomai::flash_fwd_kernel_tc<64>", ("k11_gate_up_kernel",
                                             "k11_down_kernel")
ROWS_D, VISITS_D, ROWS_P, VISITS_P = 45_056, 5_632, 9_600, 700


def _run(counters=True):
    keys = {"moe_rows_decode": ROWS_D, "moe_expert_visits_decode": VISITS_D,
            "moe_rows_prefill": ROWS_P, "moe_expert_visits_prefill": VISITS_P}
    snaps = {e: {} for e in ("open", "begin", "end", "close")}
    if counters:
        snaps = {"open": {k: 3 for k in keys}, "begin": {k: 5 for k in keys},
                 "end": {k: 5 + v for k, v in keys.items()},
                 "close": {k: 50 + v for k, v in keys.items()}}
    return {"counters": snaps, "t0": 0.0, "t1": 51.0, "slice": (20.0, 24.0),
            "pool": "bfloat16", "lanes": 128}


def _trace():
    """Two decode replays (1, 2) of K11's pair, 0.002 + 0.003 s each, and
    one prefill replay (3) with K1 and the pair, 0.004 + 0.005 s."""
    ks = []
    for c in (1, 2):
        ks += [(K11[0], c, 0.002), (K11[1], c, 0.003)]
    ks += [(K1, 3, 0.001), (K11[0], 3, 0.004), (K11[1], 3, 0.005)]
    return {"kernels": [(n, 1.0, 1.0 + s, G, c) for n, c, s in ks]}


def _share(rows, visits, secs):
    h, mi = 2048, 1792
    flops = 2.0 * 3 * mi * h * rows
    nbytes = 3.0 * mi * h * 2 * visits + 2.0 * h * 2 * rows
    return 100.0 * work.bound_s(flops, nbytes) / secs


def test_k11_readers_read_their_phase_exactly():
    mods = spec.layer_metrics()
    cell = {"config": PUBLISHED}
    run, trace = _run(), _trace()
    assert mods["k11_roofline.decode.tok_s"].read(run, trace, cell) == \
        pytest.approx(_share(ROWS_D, VISITS_D, 0.010))
    assert mods["k11_roofline.prefill.tok_s"].read(run, trace, cell) == \
        pytest.approx(_share(ROWS_P, VISITS_P, 0.009))
    assert mods["expert_rows_per_visit.tok_s"].read(run, trace, cell) == \
        pytest.approx(ROWS_D / VISITS_D)


@pytest.mark.parametrize("name", ["k11_roofline.decode.tok_s",
                                  "k11_roofline.prefill.tok_s",
                                  "expert_rows_per_visit.tok_s"])
def test_readers_are_none_without_their_counters(name):
    """The parent's engine has no MoE counters: nothing to read, no
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
    for name in ("k11_roofline.decode.tok_s", "k11_roofline.prefill.tok_s",
                 "expert_rows_per_visit.tok_s", "idle_share.tok_s",
                 "mfu.tok_s", "k4_roofline.tok_s", "chained_tick_share",
                 "prefill_time_share.tok_s", "tick_host_ms.tok_s",
                 "prefill_graph_share.tok_s"):
        assert "lfm2-8b-a1b.batch" in entries[name]["workloads"], name
    cell = spec.cell("lfm2-8b-a1b.batch")
    assert cell["config"]["family"] == "lfm2_moe"
    assert [m["name"] for m in cell["end_to_end"]] == ["output_tok_s",
                                                       "setup_s"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
def test_control_fails_where_the_program_passes(card):
    """At the cell's widths and load over a 20 s window (requests of 256 to
    1,024 tokens finish from ~10 s on): the program passes, its control
    (int8 linears, int8 pool) fails."""
    cell = spec.cell("lfm2-8b-a1b.batch")
    seed = 2 ** 31 + 607
    program, _, _ = R.run_cell(cell, seed, 20.0, False)
    assert program["correct"], program["checks"]
    control, _, _ = R.run_cell(cell, seed, 20.0, False, which="control")
    assert not control["correct"], control["checks"]
