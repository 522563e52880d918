"""The per-layer metrics read from the engine's span-edge counters
(``program_span``, before the traced slice): each on a synthetic run gives
its exact value, and None where its counters are absent (a program without
them); a tiny traced CPU run reports every ``program_span`` metric."""

import pytest

from gpubench import run as R, spec
from gpubench.tests import tiny

B = spec.benchmark()
SPAN_METRICS = [m for m in B["per_layer"] if m["source"] == "program_span"]

# the counters' changes before the slice (open -> begin), which the
# metrics read, and inside and after it (begin -> end -> close)
BEFORE = {"queue_wait_ns": 81_000_000, "requests_admitted": 4,
          "prefill_wait_ns": 6_000_000, "requests_prefilled": 3,
          "prefill_ns": 120_000_000, "prefill_dispatch_ns": 108_000_000,
          "prefill_calls": 4, "prefill_tokens": 240, "prefill_slots": 2_000,
          "prefill_attn_pairs": 1, "prefill_ctx_tokens": 1,
          "tick_host_ns": 15_000_000, "decode_ticks": 5}
INSIDE = {"queue_wait_ns": 9_000_000, "requests_admitted": 1,
          "prefill_wait_ns": 1, "requests_prefilled": 1, "prefill_ns": 7,
          "prefill_dispatch_ns": 1, "prefill_calls": 1,
          "prefill_tokens": 240, "prefill_slots": 960,
          "prefill_attn_pairs": 200_000, "prefill_ctx_tokens": 4_000,
          "tick_host_ns": 9, "decode_ticks": 1}
AFTER = {k: 3 * v + 1 for k, v in BEFORE.items()}


def _run(counters=True):
    snaps = {e: {} for e in ("open", "begin", "end", "close")}
    if counters:
        c = {k: 1_000 for k in BEFORE}
        for e, part in (("open", {}), ("begin", BEFORE), ("end", INSIDE),
                        ("close", AFTER)):
            c = {k: c[k] + part.get(k, 0) for k in c}
            snaps[e] = c
    return {"counters": snaps, "t0": 0.0, "t1": 51.0, "slice": (20.0, 24.0),
            "pool": "bfloat16"}


def _trace():
    return {"kernels": [
        ("vyomai::flash_fwd_kernel_tc<128>", 1.0, 1.002,
         "cudaLaunchKernel", 1),
        ("vyomai::flash_fwd_kernel_tc<128>", 2.0, 2.5, "cudaGraphLaunch", 2),
        ("vyomai::paged_decode_split_kernel", 3.0, 3.1,
         "cudaGraphLaunch", 2)]}


# read before the slice, which starts 20 s into the window
EXPECTED = {
    "queue_wait_ms": 81_000_000 / 4 / 1e6,
    "prefill_wait_ms": 6_000_000 / 3 / 1e6,
    "prefill_call_ms": 120_000_000 / 4 / 1e6,
    "prefill_dispatch_share": 100.0 * 108_000_000 / 120_000_000,
    "padded_token_share": 100.0 * (1 - 240 / 2_000),
    "prefill_time_share.tok_s": 100.0 * 120_000_000 / 20e9,
    "tick_host_ms.tok_s": 15_000_000 / 5 / 1e6,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_metric_reads_its_counters_exactly(name):
    mod = spec.layer_metrics()[name]
    cell = tiny.cell("chat")
    assert mod.read(_run(), _trace(), cell) == pytest.approx(
        EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_metric_is_none_without_its_counters(name):
    mod = spec.layer_metrics()[name]
    assert mod.read(_run(counters=False), _trace(), tiny.cell("chat")) \
        is None


def test_span_entries_name_the_cells_their_metrics_read():
    assert {m["name"] for m in SPAN_METRICS} == set(EXPECTED)
    for m in SPAN_METRICS:
        assert m["workloads"], m["name"]


def test_tiny_traced_run_reports_every_span_metric(monkeypatch):
    monkeypatch.setattr(spec, "limits", lambda name: {
        "max_logit_gap": 1e-3, "mean_logit_gap": 1e-4})
    cell = tiny.cell("backlog")
    cell["per_layer"] = SPAN_METRICS
    result, _, run = R.run_cell(cell, 7, 2.0, True, device="cpu")
    assert set(result["metrics"]) == set(EXPECTED)
    for name, v in result["metrics"].items():
        assert v["value"] >= 0 and v["unit"] == spec.layer_metrics()[
            name].UNIT
    assert 0 < result["metrics"]["padded_token_share"]["value"] < 100
    assert result["correct"] is True
