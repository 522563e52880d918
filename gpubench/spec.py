"""The cell registry: ``BENCHMARK.json`` at the checkout's root, and the
data files and modules it names, found by name."""

import importlib
import json
import pkgutil
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(path=None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell(name: str, bench: dict = None) -> dict:
    """The cell ``name`` with its configuration and traffic files loaded,
    and the names of the end-to-end and per-layer metrics it reports."""
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in reported
                              else [])]
    return {"name": name, "chips": w["chips"],
            "config": load_json(ROOT / conf["file"]),
            "traffic": traffic(w["traffic"]),
            "end_to_end": e2e, "per_layer": layer}


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits(cell_name: str) -> dict:
    """The limits of the cell's checks (``cells/<cell>.json``), with the
    readings they were set from."""
    path = HERE / "cells" / f"{cell_name}.json"
    return load_json(path) if path.exists() else {}


def entry(name: str):
    """The module ``entries/<name>.py``."""
    return importlib.import_module(f"gpubench.entries.{name}")


def family(cfg: dict):
    """The module ``families/<name>.py`` of the configuration's model
    family, named by its top-level ``"family"`` key (default ``dense``)."""
    name = cfg.get("family", "dense")
    module = f"gpubench.families.{name}"
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise LookupError(
            f"configuration {cfg.get('name')!r} names the model family "
            f"{name!r}, and there is no gpubench/families/{name}.py") from None


def _by_name(package: str) -> dict:
    pkg = importlib.import_module(package)
    mods = {}
    for info in pkgutil.iter_modules(pkg.__path__):
        mod = importlib.import_module(f"{package}.{info.name}")
        if hasattr(mod, "NAME"):
            mods[mod.NAME] = mod
    return mods


def e2e_metrics() -> dict:
    """``NAME`` -> module of ``e2e/*.py``."""
    return _by_name("gpubench.e2e")


def layer_metrics() -> dict:
    """``NAME`` -> module of ``metrics/*.py``."""
    return _by_name("gpubench.metrics")
