"""The static KV cache (counterpart of ``vyomai_tpu.layers.kv_cache``).

One preallocated buffer pair for all layers,

    k, v : [num_layers, batch, num_kv_heads, max_len, head_dim]

held in a dict ``{"k": ..., "v": ..., "length": int}``. The models write
each step's k/v into layer ``l``'s ``[B, H_kv, max_len, D]`` slices IN
PLACE at ``start_pos`` (the JAX package returns updated copies), and attend
over the whole buffer under a mask that hides the positions not written
yet (``core.masks.causal_mask_static_kv``). ``length`` is the number of
valid positions, a host integer: every position of a decode loop is known
on the host, so reading it costs no transfer.

``DynamicCacheOne`` / ``StaticCache`` / ``DynamicCache`` are aliases of
``StaticCacheOne``, as in the JAX package: the static cache subsumes the
concat-grow caches. ``trim`` (a speculative-decoding rollback) only rewinds
``length``; the stale tail stays masked.
"""

from typing import Optional

import torch

from ..core.device import resolve_device


def init_cache(config, *, batch_size: int = 1, max_len: Optional[int] = None,
               dtype=torch.float32, num_layers: Optional[int] = None,
               num_kv_heads: Optional[int] = None,
               head_dim: Optional[int] = None, device=None) -> dict:
    """A zeroed static KV cache on ``device`` (the CUDA card unless another
    is named)."""
    device = resolve_device(device)
    if head_dim is None:
        head_dim = getattr(config, "head_dim", None) or (
            config.hidden_size // config.num_attention_heads)
    if num_kv_heads is None:
        num_kv_heads = getattr(config, "num_key_value_heads", None) or \
            config.num_attention_heads
    if num_layers is None:
        num_layers = config.num_hidden_layers
    if max_len is None:
        max_len = config.max_position_embeddings
    shape = (num_layers, batch_size, num_kv_heads, max_len, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "length": 0}


def cache_max_len(cache) -> int:
    return cache["k"].shape[3]


def with_length(cache, length: int) -> dict:
    return {**cache, "length": int(length)}


def trim(cache, num_tokens_to_discard: int) -> dict:
    """Rollback: drop the trailing ``num_tokens_to_discard`` positions
    (``length`` clamped at 0)."""
    return with_length(cache, max(cache["length"] - num_tokens_to_discard,
                                  0))


def write_layer(cache_kv, k: torch.Tensor, v: torch.Tensor,
                start_pos: int):
    """Write ``k, v [B, H_kv, L, D]`` into one layer's ``(k_buf, v_buf)
    [B, H_kv, max_len, D]`` IN PLACE at ``start_pos``, clamped into ``[0,
    max_len - L]`` as ``lax.dynamic_update_slice`` clamps it. Returns the
    buffers, which attention then reads whole. The buffers must hold
    ``k``'s dtype: a cast here would convert every layer's whole buffer on
    every step."""
    k_buf, v_buf = cache_kv
    if k_buf.dtype != k.dtype or v_buf.dtype != v.dtype:
        raise ValueError(
            f"the cache holds {k_buf.dtype} but the layer computes "
            f"{k.dtype}: build it with the model's init_cache")
    n = k.shape[2]
    start = min(max(int(start_pos), 0), k_buf.shape[2] - n)
    k_buf[:, :, start:start + n] = k
    v_buf[:, :, start:start + n] = v
    return k_buf, v_buf


class StaticCacheOne:
    """All-layers static cache with the reference's constructor, less its
    ``is_gqa``, which the JAX package ignores (the config's
    ``num_key_value_heads`` sets the heads); ``data`` (or :meth:`pytree`)
    is the :func:`init_cache` dict."""

    def __init__(self, config, max_cache_len: Optional[int] = None,
                 dtype=torch.float32, batch_size: int = 1, device=None):
        self.data = init_cache(config, batch_size=batch_size,
                               max_len=max_cache_len, dtype=dtype,
                               device=device)

    def pytree(self):
        return self.data


DynamicCacheOne = StaticCacheOne
StaticCache = StaticCacheOne
DynamicCache = StaticCacheOne
