"""Output tokens of whole back-to-back ``generate_hf`` calls, per second
of those calls: the same count as ``output_tok_s``, kept apart because an
eager host loop spreads far wider than a graph-replayed batch, and one
bound serves one metric."""

from .output_tok_s import read  # noqa: F401

NAME, UNIT = "generate_tok_s", "tokens/s"
