"""K12, RMSNorm over the last dimension with the residual add that feeds it
folded in: the hand-written Hopper kernel (``csrc/rms_norm.cu``) and its
plain version, ``core.nn.rms_norm``.

It replaces no TPU kernel: the JAX package leaves its norms to XLA, which
fuses each norm, and the add in front of it, into one pass. In PyTorch the
same arithmetic is about nine small kernels a norm site (casts, square,
mean, ``+ eps``, rsqrt, two multiplies), and in the serving steps those
sites cost more launches than any other op. What bounds them on the H100
is the launch, not the bytes: a decode step's ``[64, 1024]`` bf16 operand
is 128 KB, well under a microsecond at 3.35 TB/s. The kernel is one launch
a site; it reads each row once in 16-byte vectors, keeps it in registers
for the scale, and writes each output once. Its block shape follows the
row width (see the source): per-head QK-norm rows of 64 or 128 share a
warp, hidden rows of 1,024 to 4,096 take one to four warps.

Contract: ``rms_norm(weight, x, eps)`` is ``core.nn.rms_norm(weight, x,
eps)``; with ``residual=`` it returns ``(s, rms_norm(weight, s, eps))``
for ``s = residual + x`` in x's dtype (the rounded sum is what the norm
reads, as when the add and the norm are two calls). The kernel keeps that
arithmetic: fp32 squares, mean and scale, the rsqrt ATen uses, the weight
widened to fp32, one rounding to x's dtype; only the order of the fp32
sum differs.

Dispatch: a CPU tensor takes the plain version, in any dtype and under
autograd. A CUDA tensor launches the kernel, which never falls back: what
it does not take raises (a dtype other than bf16 or fp32, an operand that
needs a gradient, rows not contiguous, a width that is not a whole number
of 16-byte vectors, an operand of another dtype or device).
``rms_norm.sites`` counts calls (the norm sites run),
``rms_norm.launches`` those the kernel ran.
"""

import torch

from . import _build
from ..core import nn as cnn

_DTYPES = (torch.bfloat16, torch.float32)


def _plain(weight, x, eps, residual):
    if residual is None:
        return cnn.rms_norm(weight, x, eps=eps)
    s = residual + x
    return s, cnn.rms_norm(weight, s, eps=eps)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"rms_norm: {msg}")


def _launch(weight, x, eps, residual):
    d = x.shape[-1]
    operands = (x, weight) if residual is None else (x, weight, residual)
    _check(all(t.device == x.device and t.dtype == x.dtype
               for t in operands),
           f"weight and residual share x's device and dtype ({x.dtype})")
    _check(tuple(weight.shape) == (d,), f"weight must be [{d}]")
    _check(residual is None or residual.shape == x.shape,
           "residual must have x's shape")
    _check(all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in operands), "operands contiguous, 16-byte aligned")
    _check(d * x.element_size() % 16 == 0,
           f"row of {d} elements is not a whole number of 16-byte vectors")
    out = torch.empty_like(x)
    s = None if residual is None else torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows:
        err = _build.library().rms_norm_launch(
            x.data_ptr(), None if s is None else residual.data_ptr(),
            weight.data_ptr(), None if s is None else s.data_ptr(),
            out.data_ptr(), rows, d, eps, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, "rms_norm")
        rms_norm.launches += 1
    return out if s is None else (s, out)


def rms_norm(weight: torch.Tensor, x: torch.Tensor, eps: float = 1e-6, *,
             residual=None):
    """RMSNorm of ``x`` over its last dimension by ``weight``; with
    ``residual``, ``(residual + x, its norm)``. One norm site, one launch
    on the card (see the module docstring)."""
    rms_norm.sites += 1
    if not x.is_cuda:
        return _plain(weight, x, eps, residual)
    _check(x.dtype in _DTYPES, f"takes bf16 or fp32 on the card, not "
           f"{x.dtype}")
    _check(not (torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (weight, x, residual))),
        "has no backward: call it under torch.no_grad()")
    return _launch(weight, x, eps, residual)


rms_norm.sites = 0
rms_norm.launches = 0
