"""Primitive building blocks on tensors (counterpart of
``vyomai_tpu.core.nn``).

Weights follow PyTorch's layout: a linear weight is ``[out, in]`` as in
``nn.Linear`` (the JAX package stores ``[in, out]``; the weight bridge in
``interop.from_jax`` transposes).
"""

import torch


def linear(weight: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x @ weight.T`` with ``weight [out, in]`` (no biases: Qwen has
    none, and ``attention_bias`` is not ported)."""
    return torch.matmul(x, weight.t())


def embedding(weight: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Row lookup ``weight[ids]``."""
    return weight[ids]


def tied_lm_head(weight: torch.Tensor, hidden: torch.Tensor) -> torch.Tensor:
    """Logits through a tied embedding table: ``hidden @ weight.T``."""
    return torch.matmul(hidden, weight.t().to(hidden.dtype))


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def rms_norm(weight: torch.Tensor, x: torch.Tensor, eps: float = 1e-6, *,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm reduced in fp32 (fp64 for fp64 inputs), cast back to the
    input dtype. ``plus_one=True`` selects Gemma's ``x * (1 + w)`` form."""
    dtype = x.dtype
    acc = _acc_dtype(dtype)
    x32 = x.to(acc)
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    w = weight.to(acc)
    y = y * (1.0 + w) if plus_one else y * w
    return y.to(dtype)
