"""The PyTorch port's package hygiene, config and JAX weight bridge."""

import os
import subprocess
import sys
from dataclasses import fields
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vyomai_tpu as vt
import vyomai_tpu_torch as tt
from vyomai_tpu_torch.interop import (decoder_params_from_jax,
                                      tree_from_torch,
                                      params_from_jax)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
QCFG = vt.QwenConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, head_dim=32,
                     max_position_embeddings=256, qk_norm=True,
                     eos_token_id=9999, tie_word_embeddings=True)


def test_import_never_loads_jax(tmp_path):
    """``import vyomai_tpu_torch`` (engine, kv manager, kernels' wrappers,
    decoder, trainer and bench included) from a neutral directory leaves
    jax unimported."""
    code = ("import sys, vyomai_tpu_torch, vyomai_tpu_torch.interop, "
            "vyomai_tpu_torch.serving.paged_model, "
            "vyomai_tpu_torch.ops.flash_attention, "
            "vyomai_tpu_torch.ops.paged_decode, vyomai_tpu_torch.ops.fused, "
            "vyomai_tpu_torch.models.decoder, vyomai_tpu_torch.training, "
            "vyomai_tpu_torch.bench, vyomai_tpu_torch.quant, "
            "vyomai_tpu_torch.ops.quant_matmul, vyomai_tpu_torch.quant_bench; "
            "print('jax' in sys.modules, 'vyomai_tpu' in sys.modules)")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    done = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert done.returncode == 0, done.stderr
    assert done.stdout.split() == ["False", "False"]


def test_package_sources_never_import_jax():
    pkg = ROOT / "vyomai_tpu_torch"
    for path in pkg.rglob("*.py"):
        if "csrc" in path.relative_to(pkg).parts:   # build outputs
            continue
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path


@pytest.mark.parametrize("name", ["QwenConfig", "EncoderConfig"])
def test_config_defaults_match_jax(name):
    ours, theirs = getattr(tt, name)(), getattr(vt, name)()
    assert [f.name for f in fields(ours)] == [f.name for f in fields(theirs)]
    for f in fields(theirs):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name


@pytest.mark.parametrize("option", [
    dict(rope_scaling={"rope_type": "linear", "factor": 2.0}),
    dict(sliding_window=64), dict(num_experts=4), dict(attention_bias=True)])
def test_config_rejects_unported_options(option):
    with pytest.raises(NotImplementedError):
        tt.QwenConfig(**option)


@pytest.mark.parametrize("tie", [True, False])
def test_bridge_round_trip(tie):
    cfg = QCFG.replace(tie_word_embeddings=tie)
    tcfg = tt.QwenConfig(**{f.name: getattr(cfg, f.name)
                            for f in fields(cfg)})
    params = vt.ModelForCausalLM(cfg).init(jax.random.PRNGKey(0),
                                           dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = params_from_jax(tree, tcfg, device="cpu")
    assert model.dtype == torch.float32 and len(model.layers) == 2
    assert (model.lm_head is None) == tie
    lp = tree["layers"]
    for i, layer in enumerate(model.layers):
        att = layer.self_attn
        assert tuple(att.q_proj.weight.shape) == (4 * 32, 64)
        assert tuple(att.k_proj.weight.shape) == (2 * 32, 64)
        assert tuple(att.o_proj.weight.shape) == (64, 4 * 32)
        assert tuple(layer.mlp.down_proj.weight.shape) == (64, 128)
        np.testing.assert_array_equal(
            att.q_proj.weight.detach().numpy(), lp["self_attn"]["q_proj"]["kernel"][i].T)
        np.testing.assert_array_equal(
            layer.mlp.gate_proj.weight.detach().numpy(),
            lp["mlp"]["gate_proj"]["kernel"][i].T)
        np.testing.assert_array_equal(
            att.k_norm.weight.detach().numpy(), lp["self_attn"]["k_norm"]["weight"][i])
        np.testing.assert_array_equal(
            layer.post_attention_layernorm.weight.detach().numpy(),
            lp["post_attention_layernorm"]["weight"][i])
    np.testing.assert_array_equal(model.embed_tokens.weight.detach().numpy(),
                                  tree["embed_tokens"]["weight"])
    if not tie:
        np.testing.assert_array_equal(model.lm_head.weight.detach().numpy(),
                                      tree["lm_head"]["kernel"].T)
    n_jax = sum(x.size for x in jax.tree_util.tree_leaves(tree))
    assert sum(p.numel() for p in model.parameters()) == n_jax


def test_init_uses_only_its_generator():
    """Random init reads the given generator, never the global RNG."""
    cfg = tt.QwenConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                        num_hidden_layers=1, num_attention_heads=2,
                        num_key_value_heads=1, head_dim=16,
                        max_position_embeddings=32)
    state = torch.get_rng_state()
    a = tt.ModelForCausalLM(cfg, device="cpu").init(
        torch.Generator().manual_seed(5))
    b = tt.ModelForCausalLM(cfg, device="cpu").init(
        torch.Generator().manual_seed(5))
    assert torch.equal(torch.get_rng_state(), state)
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    w = a.layers[0].self_attn.q_proj.weight
    assert abs(float(w.detach().std()) - 0.02) < 0.005
    assert torch.all(a.layers[0].input_layernorm.weight == 1)


@pytest.mark.parametrize("pe,at", [("rope", "gqa"), ("absolute", None),
                                   ("sinusoidal", "gqa")])
def test_decoder_bridge_round_trip(pe, at):
    """``decoder_params_from_jax`` then ``tree_from_torch`` gives
    the JAX tree back bit-exact: same keys, shapes, dtypes and values."""
    cfg = vt.EncoderConfig(hidden_size=64, num_attention_heads=4,
                           num_key_value_heads=2, num_hidden_layers=2,
                           vocab_size=128, max_position_embeddings=64)
    tcfg = tt.EncoderConfig(**{f.name: getattr(cfg, f.name)
                               for f in fields(cfg)})
    params = vt.DecoderModel(cfg, pos_embedding_type=pe,
                             attention_type=at).init(jax.random.PRNGKey(1))
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = decoder_params_from_jax(tree, tcfg, pe, at, device="cpu")
    assert model.dtype == torch.float32 and len(model.layers) == 2
    np.testing.assert_array_equal(
        model.layers[1].attention.key.weight.detach().numpy(),
        tree["layers"]["attention"]["key"]["kernel"][1].T)
    back = tree_from_torch(model)
    want = dict(jax.tree_util.tree_leaves_with_path(tree))
    got = jax.tree_util.tree_leaves_with_path(back)
    assert len(got) == len(want)
    for path, x in got:
        w = want[path]
        assert x.dtype == w.dtype and x.shape == w.shape, path
        np.testing.assert_array_equal(x, w, err_msg=str(path))


@pytest.mark.parametrize("tie", [True, False])
@pytest.mark.parametrize("opts", [dict(bits=8), dict(bits=4, group_size=32),
                                  dict(bits=8, act_bits=8)],
                         ids=["int8", "int4", "w8a8"])
def test_quantized_bridge_round_trip(tie, opts):
    """A ``quantize_params`` tree through ``params_from_jax`` and back
    through ``tree_from_torch`` gives the same bytes: the int8 kernels
    transposed twice, the packed int4 kernels and every scale as they were,
    the ``act_q`` and ``out_dtype`` markers with their shapes and dtypes."""
    from vyomai_tpu_torch.quant import Int4Linear, Int8Embedding, Int8Linear
    cfg = QCFG.replace(tie_word_embeddings=tie)
    tcfg = tt.QwenConfig(**{f.name: getattr(cfg, f.name)
                            for f in fields(cfg)})
    params = vt.ModelForCausalLM(cfg).init(jax.random.PRNGKey(0),
                                           dtype=jnp.float32)
    tree = jax.tree_util.tree_map(
        np.asarray, vt.quantize_params(params, **opts))
    model = params_from_jax(tree, tcfg, device="cpu")
    lin = Int4Linear if opts["bits"] == 4 else Int8Linear
    assert isinstance(model.layers[1].self_attn.o_proj, lin)
    assert isinstance(model.embed_tokens, Int8Embedding)
    assert model.dtype == torch.float32
    back = tree_from_torch(model)
    want = dict(jax.tree_util.tree_leaves_with_path(tree))
    got = jax.tree_util.tree_leaves_with_path(back)
    assert sorted(str(p) for p, _ in got) == sorted(map(str, want))
    for path, x in got:
        w = want[path]
        assert x.dtype == w.dtype and x.shape == w.shape, path
        np.testing.assert_array_equal(x, w, err_msg=str(path))
