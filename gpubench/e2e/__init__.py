"""End-to-end metrics: one module per metric, found by its ``NAME``. Each
reads the run's record (``read(run) -> float``), taken on the host clock
where the client sees the tokens, with tracing off."""
