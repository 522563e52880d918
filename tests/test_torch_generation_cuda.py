"""Static-cache generation on the card: K1 at the shapes generation gives
it, against its plain version, and the generation loops on the card
against the same loops on the CPU. Every case needs an NVIDIA card and
skips without one (K1 has no CPU mode); this file imports no JAX, so it
runs on a machine without it.

Bounds: fp32 K1 within 1e-4 of its plain version (summation order);
bf16 within ``chip_smoke.attn_bf16_atol`` (one bf16 ulp of the output,
fp32 order, and the tensor-core kernel's rounding of P to bf16). The
loops at fp32 give the CPU's tokens exactly."""

import copy

import numpy as np
import pytest
import torch

import vyomai_tpu_torch as tt
from vyomai_tpu_torch.core.masks import causal_mask_static_kv
from vyomai_tpu_torch.ops import flash_attention as fa


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (K1 has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (B, H, H_kv, Lq, Lk, start): a static-cache prefill and decode steps
SHAPES = [(8, 16, 8, 128, 192, 0), (8, 16, 4, 128, 192, 0),
          (8, 16, 8, 1, 192, 150), (8, 16, 4, 1, 192, 150),
          (8, 16, 8, 1, 197, 150), (3, 4, 2, 1, 37, 36)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_k1_at_generation_shapes_matches_plain(cuda, shape, dtype):
    b, h, h_kv, lq, lk, start = shape
    g = torch.Generator(device=cuda).manual_seed(lq * 1000 + lk)
    q = torch.randn(b, h, lq, 128, device=cuda, generator=g).to(dtype)
    k = torch.randn(b, h_kv, lk, 128, device=cuda, generator=g).to(dtype)
    v = torch.randn(b, h_kv, lk, 128, device=cuda, generator=g).to(dtype)
    am = torch.ones(b, start + lq, dtype=torch.int32, device=cuda) \
        if lq > 1 else None
    bias = causal_mask_static_kv(lq, lk, start, am, batch_size=b,
                                 device=cuda)
    before = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, bias)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    ref, ref_lse = fa.flash_attention_fwd_ref(q, k, v, bias)
    atol = 1e-4
    if dtype == torch.bfloat16:
        atol = (2.0 ** -7 * float(ref.float().abs().max()) + 1e-4
                + 2.0 ** -8 * float(v.float().abs().max()))
    assert float((out.float() - ref.float()).abs().max()) <= atol
    assert float((lse - ref_lse).abs().max()) <= 1e-3


def _qwen(device):
    cfg = tt.QwenConfig(vocab_size=4096, hidden_size=256,
                        intermediate_size=512, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2,
                        head_dim=64, max_position_embeddings=256,
                        eos_token_id=-1)
    return tt.ModelForCausalLM(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(0))


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [None, dict(bits=8)])
def test_generate_hf_on_card_matches_cpu(cuda, quant):
    cpu = _qwen("cpu")
    if quant is not None:
        tt.quantize_model(cpu, **quant)
    card = copy.deepcopy(cpu).to(cuda)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 4096, (3, 20)))
    fa.flash_attention_fwd.launches = 0
    got = tt.generate_hf(card, ids, max_new_tokens=12,
                         repetition_penalty=1.2).cpu()
    assert fa.flash_attention_fwd.launches == 2 * 12
    want = tt.generate_hf(cpu, ids, max_new_tokens=12,
                          repetition_penalty=1.2)
    assert torch.equal(got, want)
    cached = tt.generate(card, ids, max_new_tokens=8, use_cache=True)
    assert torch.equal(cached, tt.generate(card, ids, max_new_tokens=8))


@pytest.mark.cuda
@pytest.mark.parametrize("pe,at", [("rope", "gqa"), ("absolute", None)])
def test_decoder_generate_on_card_matches_cpu(cuda, pe, at):
    cfg = tt.EncoderConfig(hidden_size=256, num_attention_heads=4,
                           num_key_value_heads=2, num_hidden_layers=2,
                           vocab_size=1024, max_position_embeddings=128,
                           intermediate_size=1024, hidden_dropout_prob=0.0)
    cpu = tt.DecoderModel(cfg, pe, at, device="cpu").init(
        torch.Generator().manual_seed(4))
    card = copy.deepcopy(cpu).to(cuda)
    ids = torch.from_numpy(np.random.default_rng(1).integers(2, 1024,
                                                             (3, 20)))
    for use_cache in (True, False):
        fa.flash_attention_fwd.launches = 0
        got = card.generate(ids.to(cuda), max_len=10,
                            use_cache=use_cache).cpu()
        assert fa.flash_attention_fwd.launches > 0
        assert torch.equal(got, cpu.generate(ids, max_len=10,
                                             use_cache=use_cache))
