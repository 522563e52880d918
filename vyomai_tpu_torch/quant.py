"""Weight-only int8 / int4 quantization of a model's modules (counterpart
of ``vyomai_tpu.quant``).

:func:`quantize_model` swaps quantized modules in place of the float ones:

- every ``nn.Linear`` (except those named in ``exclude``) becomes an
  :class:`Int8Linear` (int8 weight ``[out, in]`` + one fp32 scale per
  output channel) or, with ``bits=4``, an :class:`Int4Linear` (packed int4
  ``[out, in/2]`` + fp32 scales per ``group_size`` input rows); a linear
  whose input width does not divide ``group_size`` stays int8;
- with ``embed``, a token table named ``embed_tokens`` / ``word_embeddings``
  becomes an :class:`Int8Embedding` (int8 rows + one scale per row). It
  serves the gather and, through K8's ``nk`` form, the tied logits head;
- ``act_bits=8`` marks every int8 linear for W8A8 (activations quantized
  per token at apply time) except the untied logits head (``lm_head``, or
  ``lm_head.decoder``), which keeps weight-only dequant;
- norms, biases and positional tables stay float.

The quantizers are the JAX package's, bit for bit: an ``Int8Linear``'s
``weight_q`` is the transpose of JAX's ``kernel_q``, and an ``Int4Linear``'s
``weight_q4`` the transpose of JAX's ``kernel_q4`` (k contiguous: byte i of
row n holds input rows 2i and 2i+1 of output n, the layout the tensor-core
K9 reads). ``core.nn.apply_linear`` /
``apply_embedding`` / ``apply_tied_lm_head`` dispatch on the module, so the
serving path and ``ModelForCausalLM``'s dense forward (the generation
loops) run a quantized model with no special case at their call sites.

MoE expert banks (the JAX ``_quantize_moe``) wait for ``layers/moe.py``:
:func:`quantize_model` raises on a module that holds them.
"""

from typing import Dict, Optional

import torch
from torch import nn

from .ops.quant_matmul import (dequantize_int4, int4_matmul, int8_matmul,
                               quantize_weight, quantize_weight_int4,
                               w8a8_matmul)

_EXCLUDE_DEFAULT = ("router",)
# token tables (quantized per row); positional tables stay float
_EMBED_NAMES = ("embed_tokens", "word_embeddings")


class Int8Linear(nn.Module):
    """``x @ dequant(weight_q).T (+ bias)`` through K8's ``nk`` form;
    W8A8 (``act_q``) through ``ops.quant_matmul.w8a8_matmul``."""

    def __init__(self, weight_q: torch.Tensor, scale: torch.Tensor, *,
                 act_q: bool = False, bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("weight_q", weight_q)        # [out, in] int8
        self.register_buffer("scale", scale)              # [out] fp32
        self.register_buffer("bias", bias)
        self.act_q = bool(act_q)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fn = w8a8_matmul if self.act_q else int8_matmul
        y = fn(x, self.weight_q, self.scale, w_layout="nk")
        return y if self.bias is None else y + self.bias

    def dequantized(self) -> torch.Tensor:
        """fp32 ``[out, in]`` reconstruction."""
        return self.weight_q.to(torch.float32) * self.scale[:, None]


class Int4Linear(nn.Module):
    """``x @ dequant4(weight_q4.T) (+ bias)`` through K9's ``nk`` form."""

    def __init__(self, weight_q4: torch.Tensor, scale: torch.Tensor, *,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("weight_q4", weight_q4)      # [out, in/2] int8
        self.register_buffer("scale", scale)              # [in/gs, out] fp32
        self.register_buffer("bias", bias)

    @property
    def group_size(self) -> int:
        return 2 * self.weight_q4.shape[1] // self.scale.shape[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = int4_matmul(x, self.weight_q4, self.scale, w_layout="nk")
        return y if self.bias is None else y + self.bias

    def dequantized(self) -> torch.Tensor:
        """fp32 ``[out, in]`` reconstruction."""
        return dequantize_int4(self.weight_q4.t(), self.scale).t()


class Int8Embedding(nn.Module):
    """Int8 token rows with one fp32 scale per row. A lookup dequantizes
    the rows exactly and returns ``out_dtype`` (the float table's dtype,
    the JAX ``out_dtype`` marker); :meth:`tied_lm_head` runs K8 over the
    table in its ``nk`` form."""

    def __init__(self, weight_q: torch.Tensor, scale: torch.Tensor,
                 out_dtype: torch.dtype):
        super().__init__()
        self.register_buffer("weight_q", weight_q)        # [V, D] int8
        self.register_buffer("scale", scale)              # [V] fp32
        self.out_dtype = out_dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        rows = self.weight_q[ids].to(torch.float32) * self.scale[ids][..., None]
        return rows.to(self.out_dtype)

    def tied_lm_head(self, hidden: torch.Tensor) -> torch.Tensor:
        return int8_matmul(hidden, self.weight_q, self.scale, w_layout="nk")

    def dequantized(self) -> torch.Tensor:
        return (self.weight_q.to(torch.float32)
                * self.scale[:, None]).to(self.out_dtype)


QUANTIZED = (Int8Linear, Int4Linear, Int8Embedding)


def _bias(lin: nn.Linear):
    return None if lin.bias is None else lin.bias.detach().clone()


@torch.no_grad()
def _quantize_linear(lin: nn.Linear, bits: int, group_size: int,
                     act_bits: int) -> nn.Module:
    w = lin.weight.detach()                               # [out, in]
    if bits == 4 and w.shape[1] % group_size == 0:
        q4, s = quantize_weight_int4(w.t(), group_size=group_size)
        return Int4Linear(q4.t().contiguous(), s, bias=_bias(lin))
    # int8, and the int4 fallback where K does not divide group_size
    q, s = quantize_weight(w, contract_axis=1)
    return Int8Linear(q, s, act_q=act_bits == 8, bias=_bias(lin))


@torch.no_grad()
def _quantize_embedding(emb: nn.Embedding) -> Int8Embedding:
    q, s = quantize_weight(emb.weight.detach(), contract_axis=1)
    return Int8Embedding(q, s, emb.weight.dtype)


def quantize_model(model: nn.Module, *, bits: int = 8,
                   group_size: int = 128, act_bits: int = 0,
                   embed: bool = True, exclude=_EXCLUDE_DEFAULT) -> nn.Module:
    """Quantize ``model``'s linears (and, with ``embed``, its token table)
    IN PLACE, by the JAX ``quantize_params`` rules (module docstring).
    Returns ``model``. ``ModelForCausalLM`` (dense and through
    ``serving.paged_model``) runs the result; the other models' layers read
    float weights directly."""
    if bits not in (8, 4):
        raise ValueError(f"bits={bits}: 8 or 4")
    if act_bits not in (0, 8):
        raise ValueError(f"act_bits={act_bits}: 0 or 8")
    if act_bits == 8 and bits == 4:
        raise ValueError("W8A8 needs unpacked int8 kernels (bits=8)")
    for name, mod in model.named_modules():
        if hasattr(mod, "w_in") and hasattr(mod, "w_out"):
            raise NotImplementedError(
                f"{name}: MoE expert banks are not ported yet (they wait "
                "for layers/moe.py)")
    for parent_name, parent in list(model.named_modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, nn.Linear) and name not in exclude:
                head = name == "lm_head" or (
                    parent_name.split(".")[-1] == "lm_head"
                    and name == "decoder")
                new = _quantize_linear(child, bits, group_size,
                                       0 if head else act_bits)
            elif embed and isinstance(child, nn.Embedding) and \
                    name in _EMBED_NAMES:
                new = _quantize_embedding(child)
            else:
                continue
            setattr(parent, name, new)
    return model


@torch.no_grad()
def dequantize_model(model: nn.Module) -> nn.Module:
    """Inverse swap, IN PLACE: each quantized module becomes a float one
    holding its reconstruction (fp32 linears; a table in its
    ``out_dtype``), as JAX's ``dequantize_params``. Returns ``model``."""
    for _, parent in list(model.named_modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, (Int8Linear, Int4Linear)):
                w = child.dequantized()
                lin = nn.Linear(w.shape[1], w.shape[0],
                                bias=child.bias is not None,
                                device=w.device, dtype=torch.float32)
                lin.weight.copy_(w)
                if child.bias is not None:
                    lin.bias.copy_(child.bias)
                setattr(parent, name, lin)
            elif isinstance(child, Int8Embedding):
                w = child.dequantized()
                emb = nn.Embedding(w.shape[0], w.shape[1], device=w.device,
                                   dtype=w.dtype)
                emb.weight.copy_(w)
                setattr(parent, name, emb)
    return model


@torch.no_grad()
def quantization_error(model: nn.Module,
                       qmodel: nn.Module) -> Dict[str, float]:
    """Max relative reconstruction error of every parameter of the float
    ``model`` against its counterpart in ``qmodel`` (the dequantized weight
    where a module was quantized; 0 for what stayed float):
    ``max|w - deq| / max(max|w|, 1e-9)``."""
    errs = {}
    for name, w in model.named_parameters():
        path, leaf = name.rpartition(".")[::2]
        mod = qmodel.get_submodule(path)
        if isinstance(mod, QUANTIZED) and leaf == "weight":
            other = mod.dequantized()
        else:
            other = getattr(mod, leaf)
        denom = max(float(w.abs().max()), 1e-9)
        errs[name] = float((w.to(torch.float32)
                            - other.to(torch.float32)).abs().max()) / denom
    return errs
