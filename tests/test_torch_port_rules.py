"""Two rules of the PyTorch port that every slice must keep.

1. The port stands alone: no module of ``vyomai_tpu_torch`` and nothing
   ``chip_smoke.py`` imports loads or reads a file of the JAX package, and
   jax is never imported. Checked in a fresh interpreter (so the other test
   files' JAX imports cannot leak in) after driving every model, the
   generation loops (``DecoderModel.generate``, ``generate``,
   ``generate_hf``, ``generate_until``), a tiny serving engine and two
   quantized ones (W8A8 + int8 pool, int4 + int4 pool), and by a search of
   the sources for file loaders.
2. Entry points build on the CUDA card unless the caller names another
   device: with no card they raise, naming ``device="cpu"``; they never
   fall back to the CPU quietly.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import vyomai_tpu_torch as tt
from vyomai_tpu_torch.core.device import resolve_device
from vyomai_tpu_torch.interop import (decoder_params_from_jax,
                                      encoder_params_from_jax,
                                      tree_from_torch, vit_params_from_jax)
from vyomai_tpu_torch.serving import paged_model

ROOT = Path(__file__).resolve().parent.parent

ECFG = tt.EncoderConfig(hidden_size=64, num_attention_heads=2,
                        num_key_value_heads=1, num_hidden_layers=1,
                        vocab_size=64, max_position_embeddings=32,
                        hidden_dropout_prob=0.0)
VCFG = tt.VisionConfig(image_size=(16, 16), patch_size=(8, 8),
                       hidden_size=64, num_attention_heads=2,
                       num_hidden_layers=1, hidden_dropout_prob=0.0)
QCFG = tt.QwenConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                     num_hidden_layers=1, num_attention_heads=2,
                     num_key_value_heads=1, head_dim=16,
                     max_position_embeddings=64, eos_token_id=9999)

_DRIVE = r"""
import sys
from pathlib import Path
root = Path(sys.argv[1])
sys.path.insert(0, str(root))
import torch
import chip_smoke  # noqa: F401
import vyomai_tpu_torch as tt
import vyomai_tpu_torch.bench, vyomai_tpu_torch.encoder_bench  # noqa
import vyomai_tpu_torch.interop, vyomai_tpu_torch.training  # noqa
from vyomai_tpu_torch.ops import (flash_attention, fused, paged_decode,  # noqa
                                  quant_matmul, short_attention)
import vyomai_tpu_torch.quant_bench  # noqa: F401
g = lambda: torch.Generator().manual_seed(0)  # noqa: E731
ecfg = tt.EncoderConfig(hidden_size=64, num_attention_heads=2,
                        num_key_value_heads=1, num_hidden_layers=1,
                        vocab_size=64, max_position_embeddings=32)
ids = torch.randint(2, 64, (2, 12), generator=g())
with torch.no_grad():
    for cls in (tt.DecoderModel, tt.EncoderModel, tt.EncoderForMaskedLM):
        cls(ecfg, "rope", "gqa", device="cpu").init(g())(ids)
    vcfg = tt.VisionConfig(image_size=(16, 16), patch_size=(8, 8),
                           hidden_size=64, num_attention_heads=2,
                           num_hidden_layers=1)
    tt.Vit(vcfg, device="cpu").init(g())(torch.randn(1, 3, 16, 16))
qcfg = tt.QwenConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                     num_hidden_layers=1, num_attention_heads=2,
                     num_key_value_heads=1, head_dim=16,
                     max_position_embeddings=64, eos_token_id=9999)
model = tt.ModelForCausalLM(qcfg, device="cpu").init(g())
with torch.no_grad():
    dec = tt.DecoderModel(ecfg, "rope", "gqa", device="cpu").init(g())
    assert dec.generate(ids, max_len=4).shape == (2, 16)
    assert tt.generate_hf(model, ids, max_new_tokens=3).shape == (2, 15)
    assert tt.generate(model, ids, max_new_tokens=2,
                       use_cache=True).shape == (2, 14)
    assert tt.generate_until(model, ids[:1], max_new_tokens=3).shape[0] == 1
eng = tt.ContinuousBatchEngine(model, num_blocks=32, block_size=8,
                               max_batch=2, max_blocks_per_seq=4,
                               max_new_tokens=3, dtype=torch.float32,
                               prefill_buckets=(8, 16))
done = eng.run() if [eng.submit(p) for p in ([3, 7, 9], [5, 6])] else None
assert all(len(t) == 3 for t in done.values()), done
for opts, pool in ((dict(bits=8, act_bits=8), torch.int8),
                   (dict(bits=4, group_size=16), "int4")):
    qmodel = tt.quantize_model(tt.ModelForCausalLM(qcfg, device="cpu").init(
        g()), **opts)
    eng = tt.ContinuousBatchEngine(qmodel, num_blocks=32, block_size=8,
                                   max_batch=2, max_blocks_per_seq=4,
                                   max_new_tokens=3, dtype=pool,
                                   prefill_buckets=(8, 16))
    sid = eng.submit([3, 7, 9])
    assert len(eng.run()[sid]) == 3
jax_pkg = (root / "vyomai_tpu").resolve()
loaded = sorted(
    name for name, mod in list(sys.modules.items())
    if getattr(mod, "__file__", None)
    and Path(mod.__file__).resolve().is_relative_to(jax_pkg))
print("JAX_PACKAGE_FILES", loaded)
print("JAX_IMPORTED", "jax" in sys.modules)
"""


def test_port_loads_nothing_of_the_jax_package(tmp_path):
    """Import every part of the port and ``chip_smoke``, build and run each
    model and a tiny engine on the CPU, in a fresh interpreter from a
    neutral directory: no module file lies under ``vyomai_tpu/`` and jax
    was never imported."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    done = subprocess.run([sys.executable, "-c", _DRIVE, str(ROOT)],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    assert "JAX_PACKAGE_FILES []" in done.stdout, done.stdout
    assert "JAX_IMPORTED False" in done.stdout, done.stdout


def test_no_file_loaders_in_the_port():
    """No source of the port (nor ``chip_smoke.py``) loads a module by
    file path, the way around the package boundary."""
    pkg = ROOT / "vyomai_tpu_torch"
    paths = [ROOT / "chip_smoke.py"] + [
        p for p in pkg.rglob("*.py")
        if "build" not in p.relative_to(pkg).parts]
    assert len(paths) > 20
    for path in paths:
        text = path.read_text()
        for word in ("spec_from_file_location", "SourceFileLoader",
                     "runpy"):
            assert word not in text, f"{path}: {word}"


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None) == torch.device("cuda")
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            resolve_device(None)


def test_decoder_needs_the_card_or_the_cpu_by_name():
    """``tt.DecoderModel(cfg, "rope", "gqa")`` builds on the card; with no
    card it raises, and the same call with ``device="cpu"`` builds on the
    CPU."""
    if torch.cuda.is_available():
        assert tt.DecoderModel(ECFG, "rope", "gqa").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tt.DecoderModel(ECFG, "rope", "gqa")
    assert tt.DecoderModel(ECFG, "rope", "gqa",
                           device="cpu").device.type == "cpu"


def _trees():
    """JAX-shaped trees (numpy leaves) of tiny CPU models, for the
    bridges."""
    g = torch.Generator().manual_seed(0)
    return {
        "decoder": tree_from_torch(tt.DecoderModel(
            ECFG, "rope", "gqa", device="cpu").init(g)),
        "mlm": tree_from_torch(tt.EncoderForMaskedLM(
            ECFG, "rope", "gqa", device="cpu").init(g)),
        "vit": tree_from_torch(tt.Vit(VCFG, device="cpu").init(g)),
    }


ENTRY_POINTS = {
    "DecoderModel": lambda **kw: tt.DecoderModel(ECFG, "rope", "gqa", **kw),
    "EncoderModel": lambda **kw: tt.EncoderModel(ECFG, "rope", "gqa", **kw),
    "EncoderForMaskedLM": lambda **kw: tt.EncoderForMaskedLM(
        ECFG, "rope", "gqa", **kw),
    "Vit": lambda **kw: tt.Vit(VCFG, **kw),
    "ModelForCausalLM": lambda **kw: tt.ModelForCausalLM(QCFG, **kw),
    "init_pool": lambda **kw: paged_model.init_pool(
        QCFG, 4, 8, dtype=torch.float32, **kw),
    "init_cache": lambda **kw: tt.init_cache(QCFG, max_len=8, **kw)["k"],
    "init_pool_int8": lambda **kw: paged_model.init_pool(
        QCFG, 4, 8, dtype=torch.int8, **kw)["kv"],
    "init_pool_int4": lambda **kw: paged_model.init_pool(
        QCFG, 4, 8, dtype="int4", **kw)["scale"],
    "decoder_params_from_jax": lambda **kw: decoder_params_from_jax(
        _trees()["decoder"], ECFG, "rope", "gqa", **kw),
    "encoder_params_from_jax": lambda **kw: encoder_params_from_jax(
        _trees()["mlm"], ECFG, "rope", "gqa", **kw),
    "vit_params_from_jax": lambda **kw: vit_params_from_jax(
        _trees()["vit"], VCFG, **kw),
}


def _device_of(x):
    return x.device if isinstance(x, torch.Tensor) else \
        next(x.parameters()).device


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    build = ENTRY_POINTS[name]
    if torch.cuda.is_available():
        assert _device_of(build()).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build()
    assert _device_of(build(device="cpu")).type == "cpu"


def test_params_from_jax_defaults_to_the_card():
    """The Qwen bridge, from a JAX-initialised tree."""
    jax = pytest.importorskip("jax")
    import numpy as np
    import vyomai_tpu as vt
    from dataclasses import fields
    from vyomai_tpu_torch.interop import params_from_jax
    jcfg = vt.QwenConfig(**{f.name: getattr(QCFG, f.name)
                            for f in fields(QCFG)})
    tree = jax.tree_util.tree_map(np.asarray, vt.ModelForCausalLM(
        jcfg).init(jax.random.PRNGKey(0)))
    if torch.cuda.is_available():
        assert params_from_jax(tree, QCFG).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            params_from_jax(tree, QCFG)
    assert params_from_jax(tree, QCFG, device="cpu").device.type == "cpu"
