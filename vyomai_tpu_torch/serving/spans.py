"""Named host spans on the profiler's clock.

``span(name)`` is ``torch.profiler.record_function(name)`` while a
``torch.profiler`` session records, and one shared do-nothing context
otherwise: with no profiler running a span costs one flag check (a fraction
of a microsecond), where entering and leaving ``record_function`` costs
microseconds. A recorded span lands in the profiler's trace beside the
kernels and runtime calls it encloses, on the same clock, so a reader of
the trace can put the device's idle gaps down to what the host was doing.
Names are fixed strings, so a reader sums a span across calls; nothing
per request goes into a name. The engine's (``serving/engine.py``):
``engine.step``, ``engine.admit``, ``engine.prefill``,
``engine.prefill.inputs``, ``engine.prefill.read``, ``engine.tick``,
``engine.tick.dispatch``, ``engine.tick.launch``, ``engine.tick.harvest``,
``engine.tick.wait``; the paged model's (``serving/paged_model.py``, on
the card recorded only while a graph is captured): ``paged_model.prefill``,
``paged_model.prefill.layer`` (one a layer), ``paged_model.conv`` (a conv
layer's operator, prefill and decode), ``paged_model.moe`` (an expert
layer's FFN, prefill and decode) and ``paged_model.mla`` (a layer's
multi-head latent attention, prefill and decode).
"""

from contextlib import nullcontext

import torch
from torch.profiler import record_function

_OFF = nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context that records ``name`` while the profiler runs."""
    if _recording():
        return record_function(name)
    return _OFF
