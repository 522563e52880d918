"""The whole step's share of the bf16 peak over the calls not traced (the
``generate`` cells' own ``mfu``; see ``mfu.py``)."""

from .mfu import read  # noqa: F401

NAME, UNIT, SOURCE = "mfu.gen", "%", "host_clock"
LAYER, MOVES = "whole step", "generate_tok_s"
KERNELS = ()
