"""Modern decoder layers (counterpart of ``vyomai_tpu.layers.modern``):
pre-norm RMSNorm, GQA attention projections with optional per-head
QK-norm, RoPE, SwiGLU MLP, no biases; the dense attention and layer
(``modern_attention_apply`` / ``modern_layer_apply``, with or without the
static KV cache), and the pieces of them that the paged serving model
(``serving.paged_model``) shares: ``qkv_heads``, ``rope_tables``,
``mlp_residual`` and ``lm_logits``.

The module tree mirrors the JAX param layout of ``modern_layer_init``
(``input_layernorm``, ``self_attn.{q,k,v,o}_proj``, ``self_attn.{q,k}_norm``,
``post_attention_layernorm``, ``mlp.{gate,up,down}_proj``), so a JAX param
path names the same tensor here. Modules are built with
``torch.nn.utils.skip_init`` and filled by :meth:`ModernLayer.init` from an
explicit ``torch.Generator``: the global RNG is never read.
"""

import torch
from torch import nn
from torch.nn.utils import skip_init

from ..core import nn as cnn
from .attention import _merge_heads, sdpa
from .kv_cache import write_layer
from .positional import rotate_half, table_slice


def _linear(in_dim: int, out_dim: int, device, dtype) -> nn.Linear:
    return skip_init(nn.Linear, in_dim, out_dim, bias=False,
                     device=torch.device("cpu" if device is None else device),
                     dtype=dtype)


class RMSNorm(nn.Module):
    """Holds an RMSNorm weight; ``core.nn.rms_norm`` applies it with the
    config's epsilon."""

    def __init__(self, dim: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device,
                                              dtype=dtype))


class Attention(nn.Module):
    """Projection weights of one attention block (the attention itself runs
    in :func:`modern_attention_apply`, or in ``serving.paged_model`` over
    the paged pool)."""

    def __init__(self, config, *, device=None, dtype=torch.float32):
        super().__init__()
        h, nh, nkv, hd = (config.hidden_size, config.num_attention_heads,
                          config.num_key_value_heads, config.head_dim)
        self.q_proj = _linear(h, nh * hd, device, dtype)
        self.k_proj = _linear(h, nkv * hd, device, dtype)
        self.v_proj = _linear(h, nkv * hd, device, dtype)
        self.o_proj = _linear(nh * hd, h, device, dtype)
        if config.qk_norm:
            self.q_norm = RMSNorm(hd, device=device, dtype=dtype)
            self.k_norm = RMSNorm(hd, device=device, dtype=dtype)
        else:
            self.q_norm = self.k_norm = None


class SwiGLU(nn.Module):
    def __init__(self, config, *, device=None, dtype=torch.float32):
        super().__init__()
        h, inter = config.hidden_size, config.intermediate_size
        self.gate_proj = _linear(h, inter, device, dtype)
        self.up_proj = _linear(h, inter, device, dtype)
        self.down_proj = _linear(inter, h, device, dtype)


def swiglu_apply(mlp: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    """``down(silu(gate(x)) * up(x))`` (float or quantized projections)."""
    gate = torch.nn.functional.silu(cnn.apply_linear(mlp.gate_proj, x))
    return cnn.apply_linear(mlp.down_proj,
                            gate * cnn.apply_linear(mlp.up_proj, x))


class ModernLayer(nn.Module):
    def __init__(self, config, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(config.hidden_size, **kw)
        self.self_attn = Attention(config, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, **kw)
        self.mlp = SwiGLU(config, **kw)

    @torch.no_grad()
    def init(self, generator: torch.Generator, std: float = 0.02):
        """The JAX init: normal(0, std) projections, unit norm weights."""
        for name, p in self.named_parameters():
            if name.endswith("_proj.weight"):
                p.normal_(0.0, std, generator=generator)
            else:
                p.fill_(1.0)


# -- apply ----------------------------------------------------------------------

def qkv_heads(attn: Attention, cfg, normed: torch.Tensor, lead,
              norm=cnn.rms_norm):
    """q ``[*lead, H, D]``, k and v ``[*lead, H_kv, D]`` of ``normed [*lead,
    h]``, q and k through their per-head RMSNorm when the block has one
    (float or quantized projections), applied by ``norm`` (``core.nn``'s;
    the paged serving steps pass K12, ``ops.rms_norm``)."""
    nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    q = cnn.apply_linear(attn.q_proj, normed).reshape(*lead, nh, hd)
    k = cnn.apply_linear(attn.k_proj, normed).reshape(*lead, nkv, hd)
    v = cnn.apply_linear(attn.v_proj, normed).reshape(*lead, nkv, hd)
    if attn.q_norm is not None:
        q = norm(attn.q_norm.weight, q, eps=cfg.rms_norm_eps)
        k = norm(attn.k_norm.weight, k, eps=cfg.rms_norm_eps)
    return q, k, v


def _cos_sin(model, freqs: torch.Tensor, dtype):
    emb = torch.cat([freqs, freqs], dim=-1).unsqueeze(-2)
    return ((torch.cos(emb) * model.rope_scale).to(dtype),
            (torch.sin(emb) * model.rope_scale).to(dtype))


def rope_tables(model, positions: torch.Tensor, dtype):
    """cos/sin ``[..., 1, D]`` for absolute ``positions``, from the model's
    fp32 angle table ``emb_freq`` and its ``rope_scale`` (cast to the
    activation dtype as the JAX rotation does)."""
    return _cos_sin(model, model.emb_freq[0][positions], dtype)


def rope_tables_at(model, start_pos: int, length: int, dtype):
    """:func:`rope_tables` ``[length, 1, D]`` for positions ``[start_pos,
    start_pos + length)`` (the start clamped as ``lax.dynamic_slice_in_dim``
    clamps it)."""
    return _cos_sin(model, table_slice(model.emb_freq, start_pos, length)[0],
                    dtype)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    return x * cos + rotate_half(x) * sin


def mlp_residual(layer, cfg, h: torch.Tensor) -> torch.Tensor:
    """``h + mlp(post_attention_layernorm(h))``."""
    normed = cnn.rms_norm(layer.post_attention_layernorm.weight, h,
                          eps=cfg.rms_norm_eps)
    return h + swiglu_apply(layer.mlp, normed)


def lm_logits(model, h: torch.Tensor) -> torch.Tensor:
    """The untied ``lm_head`` or the tied token table (float or
    quantized) over the final hidden state."""
    if model.lm_head is not None:
        return cnn.apply_linear(model.lm_head, h)
    return cnn.apply_tied_lm_head(model.embed_tokens, h)


def modern_attention_apply(attn: Attention, hidden: torch.Tensor, config, *,
                           rope, mask=None, causal: bool = False,
                           cache_kv=None, start_pos: int = 0):
    """Pre-norm attention body over ``hidden [B, L, h]`` (the caller applies
    the input norm and the residual); ``rope``: the ``(cos, sin)`` of
    :func:`rope_tables_at`. With ``cache_kv`` (one layer's ``(k_buf,
    v_buf) [B, H_kv, max_len, D]``) the new k/v are written in place at
    ``start_pos`` and the queries attend over the whole buffer under
    ``mask``. ``sdpa`` takes the ``H_kv`` heads as they are (K1 on the card
    reads the group in place); its ``"xla"`` route repeats them. Returns
    ``(attn_out, cache_kv)``."""
    b, l, _ = hidden.shape
    q, k, v = qkv_heads(attn, config, hidden, (b, l))
    q, k = rotate(q, *rope), rotate(k, *rope)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))      # [B, H, L, D]
    if cache_kv is not None:
        k, v = write_layer(cache_kv, k, v, start_pos)
    out = sdpa(q, k, v, mask, causal=causal)
    return cnn.apply_linear(attn.o_proj, _merge_heads(out)), cache_kv


def modern_layer_apply(layer: ModernLayer, hidden: torch.Tensor, config, *,
                       rope, mask=None, causal: bool = False, cache_kv=None,
                       start_pos: int = 0):
    """``x -> x + attn(norm(x)); h -> h + mlp(norm(h))``. Returns ``(out,
    cache_kv)``."""
    normed = cnn.rms_norm(layer.input_layernorm.weight, hidden,
                          eps=config.rms_norm_eps)
    attn_out, cache_kv = modern_attention_apply(
        layer.self_attn, normed, config, rope=rope, mask=mask, causal=causal,
        cache_kv=cache_kv, start_pos=start_pos)
    return mlp_residual(layer, config, hidden + attn_out), cache_kv
