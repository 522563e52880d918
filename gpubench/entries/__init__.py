"""Entries: one module per way of driving the program, found by the name a
traffic mix gives under ``entry``. Each has ``Entry(cell, seed, seconds,
device, which)`` with ``setup()``, ``window(tracer)`` and ``close()``."""
