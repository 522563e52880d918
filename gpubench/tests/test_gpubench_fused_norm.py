"""``fused_norm_share.tok_s``: the share of the traced slice's RMSNorm sites
that K12 ran, from the engine's counters ``norm_sites_fused`` /
``norm_sites``. On the card (a trace with kernels) it reads 100 when every
site took the kernel and its exact share otherwise; None where the program
has no such counters (a parent without K12), where no site ran in the
slice, or off the card, where every site takes the plain version."""

import pytest

from gpubench import spec

NAME = "fused_norm_share.tok_s"
CARD = {"kernels": [("vyomai::rms_norm_kernel", 1.0, 1.1,
                     "cudaGraphLaunch", 7)]}
KEYS = ("norm_sites", "norm_sites_fused")


def _run(inside, keys=KEYS):
    """Snapshots whose counters change by ``inside`` in the slice and by
    as much again on each side of it; only ``keys`` are present."""
    c = {k: 1000 for k in keys}
    snaps = {}
    for edge in ("open", "begin", "end", "close"):
        if edge != "open":
            c = {k: c[k] + inside.get(k, 0) for k in c}
        snaps[edge] = dict(c)
    return {"counters": snaps, "t0": 0.0, "t1": 51.0, "slice": (20.0, 24.0)}


@pytest.mark.parametrize("sites,fused,want", [(113 * 40, 113 * 40, 100.0),
                                              (65 * 8, 65 * 6, 75.0),
                                              (61, 0, 0.0)])
def test_share_reads_the_slice_counters(sites, fused, want):
    mod = spec.layer_metrics()[NAME]
    run = _run({"norm_sites": sites, "norm_sites_fused": fused})
    assert mod.read(run, CARD, None) == pytest.approx(want, rel=1e-12)


def test_share_is_none_without_counters_sites_or_the_card():
    mod = spec.layer_metrics()[NAME]
    assert mod.read(_run({}), CARD, None) is None
    assert mod.read(_run({"decode_ticks": 3}, keys=("decode_ticks",)),
                    CARD, None) is None
    run = _run({"norm_sites": 10, "norm_sites_fused": 10})
    assert mod.read(run, {"kernels": []}, None) is None
    assert mod.read(run, None, None) is None


def test_entry_lists_the_batch_cells():
    entry = {m["name"]: m for m in spec.benchmark()["per_layer"]}[NAME]
    assert entry["moves"] == "output_tok_s"
    assert entry["layer"] == "kernel K12 (RMSNorm)"
    assert entry["workloads"] == ["mistral-7b-v0.3-int8.batch",
                                  "qwen3-0.6b.batch", "lfm2-8b-a1b.batch"]
