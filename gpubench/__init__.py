"""Benchmark of ``vyomai_tpu_torch`` on one NVIDIA card.

``python -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of the root ``BENCHMARK.json`` once and prints one
JSON line. Configurations, model families, traffic mixes, entries and
metrics are found by name (``configs/``, ``families/``, ``traffic/``,
``entries/``, ``e2e/``, ``metrics/``), so a later change adds a cell, or a
model family, by adding files. See ``README.md``.
"""
