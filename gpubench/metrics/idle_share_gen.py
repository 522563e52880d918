"""Share of the traced call in which no kernel, memcpy or memset ran on
the device (the ``generate`` cells' own ``idle_share``)."""

from .idle_share_tpot import read  # noqa: F401

NAME, UNIT, SOURCE = "idle_share.gen", "%", "device_trace"
LAYER, MOVES = "device", "generate_tok_s"
KERNELS = ()
