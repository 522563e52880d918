"""Weight bridge between the JAX package's param trees and the port's
modules.

``params_from_jax`` (``vyomai_tpu.models.qwen.ModelForCausalLM``),
``decoder_params_from_jax`` (``DecoderModel``), ``encoder_params_from_jax``
(``EncoderModel`` and ``EncoderForMaskedLM``) and ``vit_params_from_jax``
(``Vit``) take params already converted to numpy
(``jax.tree_util.tree_map(np.asarray, params)``; this module never imports
jax), unstack the ``[L, ...]`` layer stacks and transpose the ``[in, out]``
kernels into ``nn.Linear``'s ``[out, in]``. ``tree_from_torch`` is the
inverse for the decoder, encoder and ViT models, for parameters or any
tensors named like them (gradients). The loading functions put the model
on the card unless ``device`` names another.
"""

import numpy as np
import torch
from torch import nn

from ..models.decoder import DecoderModel
from ..models.encoder import EncoderForMaskedLM, EncoderModel
from ..models.qwen import ModelForCausalLM
from ..models.vision import Vit

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


def _jax_path(model: nn.Module, name: str):
    """A torch parameter name -> (JAX tree keys, layer index or None,
    whether the tensor is a transposed linear kernel)."""
    parts = name.split(".")
    leaf = parts[-1]
    linear = isinstance(model.get_submodule(".".join(parts[:-1])),
                        nn.Linear) and leaf == "weight"
    if linear:
        leaf = "kernel"
    if "layers" in parts:
        i = parts.index("layers")
        return [*parts[:i + 1], *parts[i + 2:-1], leaf], int(parts[i + 1]), \
            linear
    return [*parts[:-1], leaf], None, linear


def _dtype_of(tree, path: str):
    x = np.asarray(_get(tree, path))
    return torch.from_numpy(np.empty(0, x.dtype)).dtype


@torch.no_grad()
def _load(model: nn.Module, tree) -> nn.Module:
    """Copy every parameter of ``model`` from the JAX tree."""
    for name, p in model.named_parameters():
        keys, layer, linear = _jax_path(model, name)
        x = np.asarray(_get(tree, ".".join(keys)))
        if layer is not None:
            x = x[layer]
        _copy(p, x.T if linear else x)
    return model


@torch.no_grad()
def decoder_params_from_jax(tree, config, pos_embedding_type="absolute",
                            attention_type=None, *, device=None,
                            dtype=None) -> DecoderModel:
    """Build a ``DecoderModel`` holding the JAX params ``tree`` (numpy
    leaves). ``dtype`` defaults to the token table's dtype."""
    dtype = dtype or _dtype_of(tree, "word_embeddings.weight")
    return _load(DecoderModel(config, pos_embedding_type, attention_type,
                              device=device, dtype=dtype),
                 tree)


@torch.no_grad()
def encoder_params_from_jax(tree, config, pos_embedding_type="absolute",
                            attention_type=None, *, device=None,
                            dtype=None):
    """Build an ``EncoderForMaskedLM`` (a tree with ``encoder`` and
    ``lm_head``) or an ``EncoderModel`` holding the JAX params ``tree``
    (numpy leaves). ``dtype`` defaults to the token table's dtype."""
    mlm = "lm_head" in tree
    table = ("encoder." if mlm else "") + "word_embeddings.weight"
    cls = EncoderForMaskedLM if mlm else EncoderModel
    return _load(cls(config, pos_embedding_type, attention_type,
                     device=device, dtype=dtype or _dtype_of(tree, table)),
                 tree)


@torch.no_grad()
def vit_params_from_jax(tree, config, pos_embedding_type="absolute", *,
                        device=None, dtype=None) -> Vit:
    """Build a ``Vit`` holding the JAX params ``tree`` (numpy leaves).
    ``dtype`` defaults to the CLS token's dtype."""
    return _load(Vit(config, pos_embedding_type, device=device,
                     dtype=dtype or _dtype_of(tree, "cls_token")), tree)


def tree_from_torch(model: nn.Module, tensors=None) -> dict:
    """The JAX param tree (numpy leaves, layers stacked on ``[L]``) of
    ``model``'s parameters (a decoder, encoder or ViT model), or of
    ``tensors`` (a dict keyed by parameter name, e.g. gradients)."""
    if tensors is None:
        tensors = dict(model.named_parameters())
    tree, stacks = {}, {}
    for name, _ in model.named_parameters():
        keys, layer, linear = _jax_path(model, name)
        x = tensors[name].detach().cpu().numpy()
        x = x.T if linear else x
        if layer is None:
            _set(tree, keys, x)
        else:
            stacks.setdefault(tuple(keys), []).append(x)
    for keys, xs in stacks.items():
        _set(tree, keys, np.stack(xs))
    return tree


def _set(tree: dict, keys, value):
    for key in keys[:-1]:
        tree = tree.setdefault(key, {})
    tree[keys[-1]] = value
