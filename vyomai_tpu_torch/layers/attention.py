"""Attention blocks of the encoder/decoder families (counterpart of
``vyomai_tpu.layers.attention``): q/k/v projections with biases (the
vision kind's fused ``qkv``), the ``sdpa`` dispatcher, the post-LN
self-output ``LN(dropout(W.attn) + input)`` and the encoder/vision and
decoder self-attention blocks, the latter with the static KV cache
(``layers.kv_cache``). The cross block is not ported yet.

``sdpa`` routes:

- ``"short"``: the short-attention Function (K5 forward, K7 backward on
  the card; their plain versions for CPU tensors) for bidirectional MHA at
  ``8 <= L <= 512`` with no mask or a key-pad bias; any other call raises
  ``ValueError``, as the JAX route does.
- ``"flash"``: the flash-attention Function (K1 forward, K2/K3 backward on
  the card; their plain versions for CPU tensors). It takes k/v with
  ``H_kv`` heads as they are: the kernels read the GQA group in place.
- ``"xla"``: full-matrix attention in fp32 (fp64 for fp64 inputs) after
  repeating k/v over the group, the JAX ``_sdpa_xla``.
- ``"auto"`` (default): for CUDA tensors, ``"short"`` where it takes the
  call (with or without a key-pad bias), else ``"flash"`` where the
  kernels take the shapes and dtypes; ``"xla"`` otherwise (every CPU
  tensor). The JAX package's thresholds between these routes (flash first
  from L = 512, masked short only from L = 384) were TPU measurements and
  are not carried over.

Fully-masked query rows are route-defined, as in the JAX package: the
flash route gives 0, the short and ``"xla"`` routes the mean of V (the
latter's scores are clamped at ``NEG_INF``, so stacked masks stay finite).
Mask such rows out downstream.
"""

from typing import Optional

import torch
from torch import nn
from torch.nn.utils import skip_init

from ..core import nn as cnn
from ..core.masks import NEG_INF
from ..ops import flash_attention as fa
from ..ops import short_attention as sa
from .kv_cache import write_layer
from .positional import apply_rotary_pos_emb

_SDPA_IMPL = "auto"


def set_sdpa_impl(impl: str) -> None:
    """Select the attention route: ``"auto" | "xla" | "flash" |
    "short"``."""
    global _SDPA_IMPL
    if impl not in ("auto", "xla", "flash", "short"):
        raise ValueError(f"unknown sdpa impl {impl!r}")
    _SDPA_IMPL = impl


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, H_kv, L, D] -> [B, H_kv * n_rep, L, D], repeat-interleaved on
    heads."""
    if n_rep == 1:
        return x
    b, h, l, d = x.shape
    return x[:, :, None].expand(b, h, n_rep, l, d).reshape(b, h * n_rep, l,
                                                           d)


def sdpa(q, k, v, mask=None, *, causal: bool = False, window=None,
         segments=None):
    """Scaled dot-product attention. q ``[B, H, Lq, D]``; k, v ``[B, H_kv,
    Lk, D]`` with ``H_kv`` dividing ``H``; ``mask`` additive, broadcastable
    to ``[B, H, Lq, Lk]``. ``causal=True`` masks keys after each query
    (queries aligned to the end of the keys)."""
    impl = _SDPA_IMPL
    short_ok = sa.supported(q, k, mask, causal=causal, window=window,
                            segments=segments)
    if impl == "short" and not short_ok:
        raise ValueError(
            "set_sdpa_impl('short'): unsupported call (mask/causal/window/"
            "segments/GQA or out-of-range shape); use 'auto' or 'flash'")
    if impl == "short" or (impl == "auto" and q.is_cuda and short_ok):
        if mask is None:
            return sa.short_attention(q, k, v)
        return sa.short_attention_bias(q, k, v, mask)
    if window is not None or segments is not None:
        raise NotImplementedError(
            "sliding-window and segment-id attention are not ported yet")
    if impl == "flash" or (impl == "auto" and fa.supported(q, k, mask)):
        return fa.flash_attention_bias(q, k, v, mask, causal=causal)
    n_rep = q.shape[1] // k.shape[1]
    return _sdpa_xla(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep), mask,
                     causal=causal)


def _sdpa_xla(q, k, v, mask=None, *, causal: bool = False):
    """Full-matrix attention: scores and softmax in fp32 (fp64 for fp64
    inputs), probabilities cast to v's dtype for the value product."""
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    scores = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * (
        1.0 / q.shape[-1] ** 0.5)
    if mask is not None:
        scores = scores + mask.to(acc)
    if causal:
        lq, lk = q.shape[2], k.shape[2]
        q_pos = (lk - lq) + torch.arange(lq, device=q.device)[:, None]
        k_pos = torch.arange(lk, device=q.device)[None, :]
        scores = scores + torch.where(k_pos <= q_pos, 0.0, NEG_INF).to(acc)
    # clamp so stacked masks do not overflow to -inf (fully-masked rows
    # keep a finite uniform softmax, the reference's behaviour)
    scores = torch.clamp_min(scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


# -- modules --------------------------------------------------------------------

def _linear(in_dim: int, out_dim: int, bias: bool, device, dtype):
    return skip_init(nn.Linear, in_dim, out_dim, bias=bias, device=device,
                     dtype=dtype)


class SelfOutput(nn.Module):
    """``dense`` (h -> h) and ``layernorm`` of the post-LN residual."""

    def __init__(self, config, *, device=None, dtype=torch.float32):
        super().__init__()
        h = config.hidden_size
        self.dense = _linear(h, h, getattr(config, "attention_bias", True),
                             device, dtype)
        self.layernorm = skip_init(nn.LayerNorm, h, device=device,
                                   dtype=dtype)


def _qkv_dims(config, kind: str):
    """(q_out_dim, kv_out_dim)."""
    h = config.hidden_size
    if "gqa" in kind:
        return h, getattr(config, "num_key_value_heads", 4) * (
            h // config.num_attention_heads)
    return h, h


class Attention(nn.Module):
    """``query``, ``key``, ``value`` projections (``kind`` ``"mha"`` or
    ``"gqa"``) or the fused ``qkv`` projection with a bias (``kind``
    ``"vision"``), and ``out`` (:class:`SelfOutput`)."""

    def __init__(self, config, kind: str = "mha", *, device=None,
                 dtype=torch.float32):
        super().__init__()
        nh = config.num_attention_heads
        if config.hidden_size % nh != 0:
            raise ValueError(
                f"The hidden size ({config.hidden_size}) is not a multiple "
                f"of the number of attention heads ({nh})")
        if "gqa" in kind:
            nkv = getattr(config, "num_key_value_heads", 4)
            if nh % nkv != 0 or nh < nkv:
                raise ValueError(
                    f"num_key_value_heads {nkv} should be <= "
                    f"num_attention_heads {nh} and divide it evenly")
        h = config.hidden_size
        self.out = SelfOutput(config, device=device, dtype=dtype)
        if kind == "vision":
            self.qkv = _linear(h, 3 * h, True, device, dtype)
            return
        bias = getattr(config, "attention_bias", True)
        q_dim, kv_dim = _qkv_dims(config, kind)
        self.query = _linear(h, q_dim, bias, device, dtype)
        self.key = _linear(h, kv_dim, bias, device, dtype)
        self.value = _linear(h, kv_dim, bias, device, dtype)


def attention_init_(p: Attention, config, generator: torch.Generator):
    std = config.initializer_range
    lins = ((p.qkv,) if hasattr(p, "qkv") else (p.query, p.key, p.value))
    for lin in (*lins, p.out.dense):
        cnn.linear_init_(lin, std, generator)
    cnn.layer_norm_init_(p.out.layernorm)


def self_output_apply(p: SelfOutput, hidden, input_tensor, config, *,
                      deterministic: bool = True,
                      generator: Optional[torch.Generator] = None):
    h = cnn.linear(p.dense.weight, hidden, p.dense.bias)
    h = cnn.dropout(h, config.hidden_dropout_prob,
                    deterministic=deterministic, generator=generator)
    eps = getattr(config, "layer_norm_eps", 1e-6)
    return cnn.layer_norm(p.layernorm.weight, p.layernorm.bias,
                          h + input_tensor, eps=eps)


def project_qkv(p: Attention, hidden, config, kind: str):
    """hidden ``[B, L, h]`` -> (q ``[B, H, L, D]``, k, v ``[B, H_kv, L,
    D]``)."""
    b, l, _ = hidden.shape
    nh = config.num_attention_heads
    if kind == "vision":
        return _split_qkv(cnn.linear(p.qkv.weight, hidden, p.qkv.bias), nh)
    nkv = getattr(config, "num_key_value_heads", 4) if "gqa" in kind else nh
    hd = config.hidden_size // nh

    def heads(lin, n):
        return cnn.linear(lin.weight, hidden, lin.bias).reshape(
            b, l, n, hd).transpose(1, 2)

    return heads(p.query, nh), heads(p.key, nkv), heads(p.value, nkv)


def _split_qkv(qkv, nh: int):
    """The fused projection ``[B, L, 3*H*D]`` -> q, k, v ``[B, H, L, D]``
    (views: q | k | v along the last dim, heads as D-wide ranges)."""
    b, l, w = qkv.shape
    x5 = qkv.reshape(b, l, 3, nh, w // (3 * nh))
    return tuple(x5[:, :, i].transpose(1, 2) for i in range(3))


def _merge_heads(x):
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def _packed_vision_ctx(qkv, nh: int):
    """The packed path off the card: unpack to ``[B, H, L, D]``,
    full-matrix attention, merge back to ``[B, L, H*D]``."""
    return _merge_heads(_sdpa_xla(*_split_qkv(qkv, nh)))


def encoder_attention_apply(p: Attention, hidden, attention_mask, config, *,
                            kind: str = "mha", freqs=None,
                            deterministic: bool = True,
                            generator: Optional[torch.Generator] = None):
    """Bidirectional self-attention of the encoder and vision blocks.

    The vision kind with no mask and no rotation takes the packed path on
    the ``"auto"`` and ``"short"`` routes: the fused projection
    ``[B, L, 3*H*D]`` goes straight into K6 on the card (no ``[B, H, L,
    D]`` transpose on either pass), into full-matrix attention on the CPU
    under ``"auto"``, and into K6's plain version under ``"short"``."""
    nh = config.num_attention_heads
    if kind == "vision":
        qkv = cnn.linear(p.qkv.weight, hidden, p.qkv.bias)
        if (attention_mask is None and freqs is None
                and _SDPA_IMPL in ("auto", "short")
                and sa.supported_packed(qkv, nh)):
            if _SDPA_IMPL == "short" or qkv.is_cuda:
                ctx = sa.short_attention_qkv(qkv, nh)
            else:
                ctx = _packed_vision_ctx(qkv, nh)
            return self_output_apply(p.out, ctx, hidden, config,
                                     deterministic=deterministic,
                                     generator=generator)
        q, k, v = _split_qkv(qkv, nh)
    else:
        q, k, v = project_qkv(p, hidden, config, kind)
    if freqs is not None:
        q, k = apply_rotary_pos_emb(q, k, freqs)
    if "gqa" in kind:
        n_rep = nh // getattr(config, "num_key_value_heads", 4)
        k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    out = sdpa(q, k, v, attention_mask)
    return self_output_apply(p.out, _merge_heads(out), hidden, config,
                             deterministic=deterministic, generator=generator)


def decoder_attention_apply(p: Attention, hidden, attention_mask, config, *,
                            kind: str = "mha", freqs=None, cache_kv=None,
                            start_pos: int = 0, causal: bool = False,
                            deterministic: bool = True,
                            generator: Optional[torch.Generator] = None):
    """Causal self-attention. Returns ``(output, cache_kv)``.

    ``cache_kv``: optional ``(k_buf, v_buf)``, one layer's static buffers
    ``[B, H_kv, max_len, D]``. The new k/v are written into them IN PLACE
    at ``start_pos`` and the queries attend over the whole buffer (the
    caller's mask hides what is not written yet). ``sdpa`` takes the
    ``H_kv`` heads as they are; only its ``"xla"`` route repeats them."""
    q, k, v = project_qkv(p, hidden, config, kind)
    if freqs is not None:
        q, k = apply_rotary_pos_emb(q, k, freqs)
    if cache_kv is not None:
        k, v = write_layer(cache_kv, k, v, start_pos)
    out = sdpa(q, k, v, attention_mask, causal=causal)
    out = self_output_apply(p.out, _merge_heads(out), hidden, config,
                            deterministic=deterministic, generator=generator)
    return out, cache_kv
