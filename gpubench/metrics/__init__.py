"""Per-layer metrics: one module per metric, found by its ``NAME``. Each
declares its ``LAYER``, ``UNIT``, ``SOURCE``, the end-to-end metric it
``MOVES``, the kernel names it sums (``KERNELS``), and ``read(run, trace,
cell)``, which returns None where it finds nothing to read. The cells that
report it are those ``BENCHMARK.json`` lists under its ``workloads``."""
