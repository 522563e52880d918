"""Weight bridge from the JAX package's param tree to the port's modules.

``params_from_jax`` takes ``vyomai_tpu.models.qwen.ModelForCausalLM``
params already converted to numpy (``jax.tree_util.tree_map(np.asarray,
params)``; this module never imports jax), unstacks the ``[L, ...]`` layer
stacks and transposes the ``[in, out]`` kernels into ``nn.Linear``'s
``[out, in]``.
"""

import numpy as np
import torch

from ..models.qwen import ModelForCausalLM

_LINEARS = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
            "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj",
            "mlp.down_proj")
_NORMS = ("input_layernorm", "post_attention_layernorm",
          "self_attn.q_norm", "self_attn.k_norm")


def _get(tree, path: str):
    for key in path.split("."):
        tree = tree[key]
    return tree


def _copy(dst: torch.Tensor, src: np.ndarray):
    if tuple(dst.shape) != tuple(src.shape):
        raise ValueError(f"shape {src.shape} does not fit {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(np.array(src)))   # own, writable copy


@torch.no_grad()
def params_from_jax(tree, config, *, device=None, dtype=None
                    ) -> ModelForCausalLM:
    """Build a ``ModelForCausalLM`` holding the JAX params ``tree`` (numpy
    leaves). ``dtype`` defaults to the embedding table's dtype."""
    emb = np.asarray(tree["embed_tokens"]["weight"])
    if dtype is None:
        dtype = torch.from_numpy(np.empty(0, emb.dtype)).dtype
    model = ModelForCausalLM(config, device=device, dtype=dtype)
    _copy(model.embed_tokens.weight, emb)
    _copy(model.norm.weight, np.asarray(tree["norm"]["weight"]))
    if model.lm_head is not None:
        _copy(model.lm_head.weight,
              np.asarray(tree["lm_head"]["kernel"]).T)
    stacks = tree["layers"]
    for i, layer in enumerate(model.layers):
        for path in _LINEARS:
            kernel = np.asarray(_get(stacks, path + ".kernel"))[i]
            _copy(_get_module(layer, path).weight, kernel.T)
        for path in _NORMS:
            mod = _get_module(layer, path)
            if mod is not None:   # q/k norms exist only with qk_norm
                _copy(mod.weight,
                      np.asarray(_get(stacks, path + ".weight"))[i])
    return model


def _get_module(root, path: str):
    for key in path.split("."):
        root = getattr(root, key)
        if root is None:
            return None
    return root
