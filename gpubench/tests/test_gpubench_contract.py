"""``BENCHMARK.json`` against the benchmark's contract, and the shape of
a run's last line."""

import ast
import json
import re
from pathlib import Path

import pytest

from gpubench import run as R, spec
from gpubench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
B = spec.benchmark()


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["gpubench"]
    assert 1 <= B["run_seconds"] <= 51
    for word in B["command"]:
        assert not word.startswith("/") and ".." not in word
    assert len(json.dumps(B)) < 64 * 1024


def test_names_units_and_keys():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("gpubench/")
        assert Path(spec.ROOT / c["file"]).exists()
        assert spec.load_json(spec.ROOT / c["file"])["source"] == c["source"]
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (spec.HERE / "traffic" / f"{w['traffic']}.json").exists()
    metrics = B["end_to_end"] + B["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    for w in B["workloads"]:
        c = spec.cell(w["name"])
        names = [m["name"] for m in c["end_to_end"]]
        assert "setup_s" in names and len(names) >= 2
        assert c["per_layer"]
        for m in c["per_layer"]:
            assert m["moves"] in names


def test_metric_modules_match_their_entries():
    e2e, layer = spec.e2e_metrics(), spec.layer_metrics()
    for m in B["end_to_end"]:
        assert e2e[m["name"]].UNIT == m["unit"]
    for m in B["per_layer"]:
        mod = layer[m["name"]]
        assert (mod.UNIT, mod.LAYER, mod.MOVES, mod.SOURCE) == \
            (m["unit"], m["layer"], m["moves"], m["source"])
        if "roofline" in m["name"]:
            assert m["name"].split("_roofline")[0] and m["unit"] == "%"
            assert mod.KERNELS


def test_last_line_has_exactly_the_contract_keys(monkeypatch):
    monkeypatch.setattr(spec, "limits", lambda name: {"max_logit_gap": 1e-3, "mean_logit_gap": 1e-4})
    result, checks, _ = R.run_cell(tiny.cell("chat"), 5, 1.0, False,
                                   device="cpu")
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert set(result["metrics"]) == {"ttft_p95_ms", "tpot_p95_ms",
                                      "setup_s"}
    for v in result["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] > 0
    assert result["correct"] is True
    json.dumps(result)


def test_traced_line_adds_breakdown(monkeypatch):
    monkeypatch.setattr(spec, "limits", lambda name: {"max_logit_gap": 1e-3, "mean_logit_gap": 1e-4})
    result, _, _ = R.run_cell(tiny.cell("backlog"), 6, 1.5, True,
                              device="cpu")
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["metrics"]) == {"chained_tick_share"} | (
        {"prefix_hit_share"} & set(result["metrics"]))


def test_no_result_without_a_card(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = R.main(["--workload", "qwen3-0.6b.chat", "--seed", "1",
                 "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(spec.HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(spec.HERE)))
def test_imports_by_whole_top_level_name(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "vyomai_tpu"}, tops
    if "reference" in path.relative_to(spec.HERE).parts:
        assert "vyomai_tpu_torch" not in tops


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "vyomai_tpu_torch_x",
                        types.ModuleType("vyomai_tpu_torch_x"))
    assert R.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "vyomai_tpu.core",
                        types.ModuleType("vyomai_tpu.core"))
    assert R.forbidden_modules() == ["vyomai_tpu"]
