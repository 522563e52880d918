"""Primitive building blocks on tensors (counterpart of
``vyomai_tpu.core.nn``).

Weights follow PyTorch's layout: a linear weight is ``[out, in]`` as in
``nn.Linear`` (the JAX package stores ``[in, out]``; the weight bridge in
``interop.from_jax`` transposes). Initializers fill modules in place from
an explicit ``torch.Generator``; the global RNG is never read.

GELU is the exact (erf) form at every dtype: the JAX package's bf16
tanh-polynomial stand-in works around XLA:TPU's unfused erf and differs
from it by at most one bf16 ulp.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


# -- initializers (normal(0, std) weights, zero biases, unit norms) ------------

@torch.no_grad()
def normal_init_(t: torch.Tensor, std: float, generator: torch.Generator):
    t.normal_(0.0, std, generator=generator)


@torch.no_grad()
def linear_init_(lin: nn.Linear, std: float, generator: torch.Generator):
    normal_init_(lin.weight, std, generator)
    if lin.bias is not None:
        lin.bias.zero_()


@torch.no_grad()
def embedding_init_(weight: torch.Tensor, std: float,
                    generator: torch.Generator,
                    pad_idx: Optional[int] = None):
    """Normal rows; the ``pad_idx`` row zeroed (``nn.Embedding``'s
    ``padding_idx`` init)."""
    normal_init_(weight, std, generator)
    if pad_idx is not None:
        weight[pad_idx] = 0.0


@torch.no_grad()
def layer_norm_init_(ln: nn.LayerNorm):
    ln.weight.fill_(1.0)
    ln.bias.zero_()


# -- apply functions ------------------------------------------------------------

def linear(weight: torch.Tensor, x: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ weight.T (+ bias)`` with ``weight [out, in]``."""
    y = torch.matmul(x, weight.t())
    return y if bias is None else y + bias


def embedding(weight: torch.Tensor, ids: torch.Tensor,
              pad_idx: Optional[int] = None) -> torch.Tensor:
    """Row lookup ``weight[ids]``. With ``pad_idx``, rows looked up by
    ``pad_idx`` are detached, so the pad row gets no gradient
    (``nn.Embedding(padding_idx=...)`` training semantics); forward values
    are unchanged."""
    rows = weight[ids]
    if pad_idx is not None:
        rows = torch.where((ids == pad_idx)[..., None], rows.detach(), rows)
    return rows


def tied_lm_head(weight: torch.Tensor, hidden: torch.Tensor) -> torch.Tensor:
    """Logits through a tied embedding table: ``hidden @ weight.T``."""
    return torch.matmul(hidden, weight.t().to(hidden.dtype))


# -- module dispatch (float modules or the quantized ones of ``quant``) ------
#
# The JAX package's ``linear`` / ``embedding`` / ``tied_lm_head`` dispatch on
# the keys of a param dict; here the module decides. A float ``nn.Linear`` or
# ``nn.Embedding`` goes through the functions above, bit for bit as before;
# any other module (``quant.Int8Linear``, ``Int4Linear``, ``Int8Embedding``)
# through its own methods.

def apply_linear(mod: nn.Module, x: torch.Tensor) -> torch.Tensor:
    if isinstance(mod, nn.Linear):
        return linear(mod.weight, x, mod.bias)
    return mod(x)


def apply_embedding(mod: nn.Module, ids: torch.Tensor) -> torch.Tensor:
    if isinstance(mod, nn.Embedding):
        return embedding(mod.weight, ids)
    return mod(ids)


def apply_tied_lm_head(mod: nn.Module, hidden: torch.Tensor) -> torch.Tensor:
    if isinstance(mod, nn.Embedding):
        return tied_lm_head(mod.weight, hidden)
    return mod.tied_lm_head(hidden)


def embedding_dtype(mod: nn.Module) -> torch.dtype:
    """Activation dtype of a token table: the float table's own, or the
    one a quantized table returns."""
    return mod.weight.dtype if isinstance(mod, nn.Embedding) else \
        mod.out_dtype


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def layer_norm(weight: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm reduced in fp32 (fp64 for fp64 inputs), cast back to the
    input dtype (``torch.nn.LayerNorm`` numerics)."""
    dtype = x.dtype
    x32 = x.to(_acc_dtype(dtype))
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * weight + bias).to(dtype)


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


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, ``torch.nn.GELU()``'s default."""
    return F.gelu(x)


# Activation table of the JAX package's ``core.nn.ACT``.
ACT = {
    "gelu": gelu,
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "sigmoid": torch.sigmoid,
    "silu": F.silu,
    "swish": F.silu,
    "tanh": torch.tanh,
}


def get_act(name: Optional[str]):
    return ACT.get(name, gelu)


def dropout(x: torch.Tensor, rate: float, *, deterministic: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout drawing its mask from ``generator``. No-op when
    deterministic or ``rate == 0``."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout requires a generator when not "
                         "deterministic")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)
