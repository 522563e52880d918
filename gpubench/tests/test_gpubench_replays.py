"""The kernel rooflines that tell the engine's two captured graphs apart:
``k1_roofline.prefill.ttft`` (K1 under any launcher),
``k8_roofline.decode.tok_s`` (K8 in decode replays) and
``k8_roofline.prefill.tok_s`` (K8 in prefill calls, replayed or eager). A
replay is a prefill's when one of its kernels is K1. Each reads its exact
value on a synthetic trace, the same whether the prefill was replayed or
launched one by one, and None without a trace, its kernels or its
counters."""

import pytest

from gpubench import spec, work
from gpubench.tests import tiny

G, L = "cudaGraphLaunch", "cudaLaunchKernel"
K1, K4 = "vyomai::flash_fwd_kernel_tc<128>", "paged_decode_split_kernel"
K8 = "void int8_matmul_kernel_tc<1, 1>(...)"
PAIRS, TOKS, CTX, CALLS = 200_000, 240, 4_000, 2


def _run(counters=True):
    keys = {"prefill_attn_pairs": PAIRS, "prefill_tokens": TOKS,
            "prefill_ctx_tokens": CTX, "prefill_calls": CALLS}
    snaps = {e: {} for e in ("open", "begin", "end", "close")}
    if counters:
        snaps = {"open": {k: 7 for k in keys}, "begin": {k: 9 for k in keys},
                 "end": {k: 9 + v for k, v in keys.items()},
                 "close": {k: 99 + v for k, v in keys.items()}}
    return {"counters": snaps, "t0": 0.0, "t1": 51.0, "slice": (20.0, 24.0),
            "pool": "bfloat16", "lanes": 4}


def _trace(prefill_via=G):
    """Two decode replays (correlations 1, 2: K4 and two K8 each), two
    prefill calls of K1 0.003 s and K8 0.010 s each, replayed (3, 4) or,
    with ``prefill_via=L``, launched one by one."""
    ks = []
    for c in (1, 2):
        ks += [(K4, c, 0.001, G), (K8, c, 0.002, G), (K8, c, 0.003, G)]
    for c in (3, 4):
        if prefill_via == G:
            ks += [(K1, c, 0.003, G), (K8, c, 0.004, G), (K8, c, 0.006, G)]
        else:
            ks += [(K1, 10 * c, 0.003, L), (K8, 10 * c + 1, 0.004, L),
                   (K8, 10 * c + 2, 0.006, L)]
    return {"kernels": [(n, 1.0, 1.0 + s, via, c) for n, c, s, via in ks]}


def _k1(cfg):
    d = work.dims(cfg)
    flops = 4.0 * d["nh"] * d["hd"] * d["layers"] * PAIRS
    nbytes = d["layers"] * (2 * d["nh"] * d["hd"] * 2 * TOKS
                            + 2 * d["nkv"] * d["hd"] * 2 * CTX)
    return 100.0 * work.bound_s(flops, nbytes) / 0.006


def _k8_decode(cfg):
    return 100.0 * 2 * work.bound_s(*work.weight_only_step(cfg, 4, 8)) / 0.010


def _k8_prefill(cfg):
    mats = work.linears(cfg)
    flops = nbytes = 0.0
    for i, (n, k) in enumerate(mats):
        rows = CALLS if i == len(mats) - 1 else TOKS
        flops += 2.0 * rows * n * k
        nbytes += CALLS * (n * k + 4 * n) + 2 * rows * (n + k)
    return 100.0 * work.bound_s(flops, nbytes) / 0.020


EXPECTED = {"k1_roofline.prefill.ttft": _k1,
            "k8_roofline.decode.tok_s": _k8_decode,
            "k8_roofline.prefill.tok_s": _k8_prefill}


@pytest.mark.parametrize("via", [G, L])
@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_metric_reads_its_kernels_exactly(name, via):
    cell = tiny.cell("chat")
    got = spec.layer_metrics()[name].read(_run(), _trace(via), cell)
    assert got == pytest.approx(EXPECTED[name](cell["config"]), rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_metric_is_none_without_a_trace_or_its_kernels(name):
    mod = spec.layer_metrics()[name]
    cell = tiny.cell("chat")
    assert mod.read(_run(), None, cell) is None
    assert mod.read(_run(), {"kernels": []}, cell) is None


@pytest.mark.parametrize("name", ["k1_roofline.prefill.ttft",
                                  "k8_roofline.prefill.tok_s"])
def test_prefill_metric_is_none_without_its_counters(name):
    mod = spec.layer_metrics()[name]
    assert mod.read(_run(counters=False), _trace(), tiny.cell("chat")) \
        is None


def test_k8_decode_roofline_reads_the_accepted_metric_without_a_prefill():
    """Where no replay ran K1, every K8 under ``cudaGraphLaunch`` is a
    decode replay's, and the reading is the decode steps' own count: each
    of the two replays' ``work.weight_only_step`` at the run's lanes over
    their K8 seconds (0.002 + 0.003 each)."""
    cell = tiny.cell("chat")
    decode_only = {"kernels": [k for k in _trace()["kernels"]
                               if k[4] in (1, 2)]}
    flops, nbytes = work.weight_only_step(cell["config"], 4, 8)
    assert spec.layer_metrics()["k8_roofline.decode.tok_s"].read(
        _run(), decode_only, cell) == pytest.approx(
        100.0 * 2 * work.bound_s(flops, nbytes) / 0.010, rel=1e-12)


def test_entries_name_the_cells_whose_kernels_they_read():
    entries = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    assert entries["k1_roofline.prefill.ttft"]["workloads"] == [
        "qwen3-0.6b.chat"]
    for name in ("k8_roofline.decode.tok_s", "k8_roofline.prefill.tok_s"):
        assert entries[name]["workloads"] == ["mistral-7b-v0.3-int8.batch"]
        assert entries[name]["layer"] == "kernel K8 (int8 weight-only matmul)"
    # the readers they replaced, silent or miscounting since the prefill
    # graph, are gone from the entries and the metrics alike
    for name in ("k1_roofline.ttft", "k8_roofline.tok_s"):
        assert name not in entries and name not in spec.layer_metrics()
