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

``params_from_jax`` also takes a tree from the JAX ``quantize_params``
(``kernel_q [L, K, N]`` / ``scale [L, N]`` with an optional ``act_q``
marker, ``kernel_q4 [L, K/2, N]`` / ``scale [L, K/gs, N]``, and
``embed_tokens.{weight_q, scale, out_dtype}``): it moves the bytes into the
``quant`` modules, transposing the int8 kernels into ``[out, in]`` and the
packed int4 kernels into ``[out, in/2]``, and never re-quantizes. ``tree_from_torch`` gives such a tree back.
"""

import numpy as np
import torch
from torch import nn

from ..models.decoder import DecoderModel
from ..models.encoder import EncoderForMaskedLM, EncoderModel
from ..models.qwen import ModelForCausalLM
from ..models.vision import Vit
from ..quant import Int4Linear, Int8Embedding, Int8Linear

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


def _tensor(x, device) -> torch.Tensor:
    # own, writable, row-major copy: a transposed kernel comes out
    # contiguous, as the tensor-core matmuls' routes require
    return torch.from_numpy(np.array(x, order="C")).to(device)


def _quantized_linear(node: dict, layer, device):
    """The ``quant`` module of a quantized JAX linear dict (layer ``layer``
    of a stack, or None), or None for a float one."""
    pick = (lambda x: np.asarray(x)) if layer is None else \
        (lambda x: np.asarray(x)[layer])
    if "kernel_q" in node:
        return Int8Linear(_tensor(pick(node["kernel_q"]).T, device),
                          _tensor(pick(node["scale"]), device),
                          act_q="act_q" in node)
    if "kernel_q4" in node:
        return Int4Linear(_tensor(pick(node["kernel_q4"]).T, device),
                          _tensor(pick(node["scale"]), device))
    return None


def _np_dtype(x) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np.asarray(x).dtype)).dtype


@torch.no_grad()
def params_from_jax(tree, config, *, device=None, dtype=None
                    ) -> ModelForCausalLM:
    """Build a ``ModelForCausalLM`` holding the JAX params ``tree`` (numpy
    leaves), float or from ``quantize_params``. ``dtype`` defaults to the
    embedding table's dtype (a quantized table's ``out_dtype``)."""
    emb_node = tree["embed_tokens"]
    quant_emb = "weight_q" in emb_node
    if dtype is None:
        dtype = _np_dtype(emb_node["out_dtype" if quant_emb else "weight"])
    model = ModelForCausalLM(config, device=device, dtype=dtype)
    dev = model.device
    if quant_emb:
        model.embed_tokens = Int8Embedding(
            _tensor(emb_node["weight_q"], dev), _tensor(emb_node["scale"], dev),
            _np_dtype(emb_node["out_dtype"]))
    else:
        _copy(model.embed_tokens.weight, np.asarray(emb_node["weight"]))
    _copy(model.norm.weight, np.asarray(tree["norm"]["weight"]))
    if model.lm_head is not None:
        head = _quantized_linear(tree["lm_head"], None, dev)
        if head is not None:
            model.lm_head = head
        else:
            _copy(model.lm_head.weight,
                  np.asarray(tree["lm_head"]["kernel"]).T)
    stacks = tree["layers"]
    for i, layer in enumerate(model.layers):
        for path in _LINEARS:
            node = _get(stacks, path)
            qmod = _quantized_linear(node, i, dev)
            if qmod is not None:
                parent, name = path.split(".")
                setattr(getattr(layer, parent), name, qmod)
                continue
            kernel = np.asarray(node["kernel"])[i]
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


# quantized module buffer -> (JAX leaf name, transposed?)
_QUANT_LEAVES = {
    Int8Linear: {"weight_q": ("kernel_q", True), "scale": ("scale", False)},
    Int4Linear: {"weight_q4": ("kernel_q4", True),
                 "scale": ("scale", False)},
    Int8Embedding: {"weight_q": ("weight_q", False),
                    "scale": ("scale", False)},
}


def _quant_leaves(model: nn.Module):
    """(name, JAX keys, layer, array) of every quantized module's leaves,
    the ``act_q`` / ``out_dtype`` markers included."""
    for path, mod in model.named_modules():
        table = _QUANT_LEAVES.get(type(mod))
        if table is None:
            continue
        keys, layer, _ = _jax_path(model, path + ".weight")
        keys = keys[:-1]
        for buf, (leaf, transpose) in table.items():
            x = getattr(mod, buf).detach().cpu().numpy()
            yield keys + [leaf], layer, x.T if transpose else x
        if getattr(mod, "act_q", False):
            yield keys + ["act_q"], layer, np.zeros((1,), np.int8)
        if isinstance(mod, Int8Embedding):
            marker = torch.zeros((1,), dtype=mod.out_dtype).numpy()
            yield keys + ["out_dtype"], layer, marker
        if getattr(mod, "bias", None) is not None:
            yield keys + ["bias"], layer, mod.bias.detach().cpu().numpy()


def tree_from_torch(model: nn.Module, tensors=None) -> dict:
    """The JAX param tree (numpy leaves, layers stacked on ``[L]``) of
    ``model``'s parameters (a decoder, encoder, ViT or Qwen model; the
    quantized modules' buffers in the ``quantize_params`` layout), or of
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
    for keys, layer, x in _quant_leaves(model):
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
