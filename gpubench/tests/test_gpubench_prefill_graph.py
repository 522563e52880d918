"""``prefill_graph_share`` and ``prefill_graph_share.tok_s``: the share of
prefill calls a captured graph served, read from the engine's counters
before the traced slice. On the card (a trace with kernels) each reads
100 when every call was a replay, its exact share when some were not, and
0 when none was; None when no prefill ran, when the program has no
``prefill_graph_calls`` counter, or off the card: a trace without kernels,
as a tiny traced CPU run's, whose prefill is eager."""

import pytest

from gpubench import run as R, spec
from gpubench.tests import tiny

NAMES = ("prefill_graph_share", "prefill_graph_share.tok_s")
CARD = {"kernels": [("vyomai::paged_decode_split_kernel", 1.0, 1.1,
                     "cudaGraphLaunch", 7)]}


def _run(before, inside=None, keys=("prefill_calls", "prefill_graph_calls")):
    """Snapshots whose counters change by ``before`` from the window's
    opening to the slice and by ``inside`` (default: 3 calls, none a
    replay) in it; only ``keys`` are present."""
    inside = inside or {"prefill_calls": 3, "prefill_graph_calls": 0}
    c = {k: 500 for k in keys}
    snaps = {"open": dict(c)}
    for edge, part in (("begin", before), ("end", inside),
                       ("close", before)):
        c = {k: c[k] + part.get(k, 0) for k in c}
        snaps[edge] = c
    return {"counters": snaps, "t0": 0.0, "t1": 51.0, "slice": (20.0, 24.0)}


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("calls,replays,want", [(12, 12, 100.0),
                                                (8, 6, 75.0), (5, 0, 0.0)])
def test_share_reads_the_counters_before_the_slice(name, calls, replays,
                                                   want):
    mod = spec.layer_metrics()[name]
    run = _run({"prefill_calls": calls, "prefill_graph_calls": replays})
    assert mod.read(run, CARD, tiny.cell("chat")) == pytest.approx(
        want, rel=1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_share_is_none_without_a_prefill_a_counter_or_the_card(name):
    mod = spec.layer_metrics()[name]
    cell = tiny.cell("chat")
    assert mod.read(_run({}), CARD, cell) is None
    assert mod.read(_run({"prefill_calls": 4}, keys=("prefill_calls",)),
                    CARD, cell) is None
    run = _run({"prefill_calls": 4, "prefill_graph_calls": 4})
    assert mod.read(run, {"kernels": []}, cell) is None
    assert mod.read(run, None, cell) is None


def test_entries_list_the_cells_of_the_metric_they_move():
    entries = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    assert entries["prefill_graph_share"]["workloads"] == ["qwen3-0.6b.chat"]
    assert entries["prefill_graph_share.tok_s"]["workloads"] == [
        "mistral-7b-v0.3-int8.batch", "qwen3-0.6b.batch"]


def test_tiny_traced_cpu_run_reports_no_share(monkeypatch):
    monkeypatch.setattr(spec, "limits", lambda name: {
        "max_logit_gap": 1e-3, "mean_logit_gap": 1e-4})
    cell = tiny.cell("backlog")
    cell["per_layer"] = [m for m in spec.benchmark()["per_layer"]
                         if m["name"] in NAMES]
    result, _, run = R.run_cell(cell, 7, 2.0, True, device="cpu")
    before = {k: run["counters"]["begin"][k] - run["counters"]["open"][k]
              for k in ("prefill_calls", "prefill_graph_calls")}
    assert before["prefill_calls"] > 0 == before["prefill_graph_calls"]
    assert result["metrics"] == {}
    assert result["correct"] is True
