"""Flash-attention forward in the PyTorch port (``ops.flash_attention``).

On the CPU the wrapper runs its plain version, held here against the JAX
package's Pallas forward kernel in interpret mode (``_fwd`` for out and
lse, ``flash_attention_bias`` for ragged lengths) at fp32, atol 2e-5:
additive bias, causal with q_offset, GQA, ragged lengths and fully-masked
rows (0 output, lse -1e30 from both). The cases marked ``cuda`` run the
hand-written kernel against the plain version and skip without a card.
JAX is loaded by the ``jx`` fixture, so the card's cases also run where
JAX is not installed."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vyomai_tpu_torch.core.masks import NEG_INF
from vyomai_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                  flash_attention_fwd_ref)

torch.set_num_threads(1)

ATOL = 2e-5


@pytest.fixture(scope="module")
def jx():
    """The JAX package's flash forward, in interpret mode."""
    jnp = pytest.importorskip("jax.numpy")
    from vyomai_tpu.ops import flash_attention as jfa
    jfa.set_interpret(True)
    yield SimpleNamespace(jnp=jnp, fa=jfa)
    jfa.set_interpret(False)


def _qkv(seed, b, h, h_kv, lq, lk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, lq, d)).astype(np.float32),
            rng.standard_normal((b, h_kv, lk, d)).astype(np.float32),
            rng.standard_normal((b, h_kv, lk, d)).astype(np.float32))


def _bias(seed, shape, p_mask=0.3):
    rng = np.random.default_rng(seed)
    bias = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    bias[rng.random(shape) < p_mask] = NEG_INF
    return bias


def _compare(jx, q, k, v, bias, causal, q_offset):
    jout, jlse = jx.fa._fwd(*map(jx.jnp.asarray, (q, k, v)),
                            None if bias is None else jx.jnp.asarray(bias),
                            causal, q_offset, block_q=16, block_k=16)
    out, lse = flash_attention_fwd(
        *map(torch.from_numpy, (q, k, v)),
        None if bias is None else torch.from_numpy(bias), causal=causal,
        q_offset=q_offset)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :, 0],
                               atol=ATOL, rtol=1e-6)
    return out.numpy(), lse.numpy()


CASES = {
    # name: (b, h, h_kv, lq, lk, bias shape or None, causal)
    "bias_full": (2, 4, 2, 32, 48, (2, 1, 32, 48), False),
    "bias_row_broadcast": (2, 4, 4, 16, 32, (2, 1, 1, 32), False),
    "bias_per_head": (1, 4, 1, 16, 32, (1, 4, 16, 32), False),
    "causal_offset": (2, 4, 2, 32, 64, None, True),
    "causal_square_gqa": (1, 8, 2, 48, 48, None, True),
    "causal_and_bias": (2, 4, 2, 16, 48, (2, 1, 16, 48), True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_fwd(jx, name):
    b, h, h_kv, lq, lk, bshape, causal = CASES[name]
    q, k, v = _qkv(len(name), b, h, h_kv, lq, lk, 32)
    bias = None if bshape is None else _bias(len(name), bshape)
    _compare(jx, q, k, v, bias, causal, lk - lq)


def test_fully_masked_rows_give_zero_and_floor_lse(jx):
    q, k, v = _qkv(5, 1, 2, 1, 16, 32, 32)
    bias = _bias(5, (1, 1, 16, 32))
    bias[0, 0, 3] = NEG_INF                  # row 3 sees no key
    out, lse = _compare(jx, q, k, v, bias, False, 16)
    assert np.all(out[:, :, 3] == 0) and np.allclose(lse[:, :, 3], -1e30)


def test_causal_rows_before_every_key(jx):
    """q_offset < 0: the first rows precede every key (fully masked)."""
    q, k, v = _qkv(6, 1, 2, 2, 32, 16, 32)
    out, lse = _compare(jx, q, k, v, None, True, -8)
    assert np.all(out[:, :, :8] == 0)


@pytest.mark.parametrize("lq,lk,causal,with_bias", [
    (37, 1000, False, True), (13, 29, True, False), (5, 21, False, False),
    (11, 19, False, True)])
def test_ragged_lengths_match_pad_shim(jx, lq, lk, causal, with_bias):
    """The kernel masks ragged edges itself; the JAX pad-and-slice shim
    must give the same result."""
    q, k, v = _qkv(lq, 2, 4, 2, lq, lk, 32)
    bias = _bias(lk, (2, 1, lq, lk)) if with_bias else None
    ref = np.asarray(jx.fa.flash_attention_bias(
        *map(jx.jnp.asarray, (q, k, v)),
        None if bias is None else jx.jnp.asarray(bias), causal=causal))
    got, _ = flash_attention_fwd(
        *map(torch.from_numpy, (q, k, v)),
        None if bias is None else torch.from_numpy(bias), causal=causal)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def bf16_atol(ref: torch.Tensor, v: torch.Tensor) -> float:
    """Same bf16 inputs on both sides, fp32 reductions: fp32 order (1e-4)
    plus one bf16 ulp of the output after the final cast (2^-7 of its
    largest magnitude), plus the kernel's rounding of P to bf16 before P.V:
    at most 2^-8 of each weight (bf16's unit roundoff), which moves an
    output by at most 2^-8 max|v|."""
    return (2.0 ** -7 * float(ref.float().abs().max())
            + 2.0 ** -8 * float(v.float().abs().max()) + 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,lq,lk,causal,bias_rows", [
    (128, 64, 256, False, 64), (128, 37, 1000, False, 37),
    (64, 100, 100, True, 0), (128, 32, 96, True, 1),
    (64, 37, 1000, False, 37), (128, 130, 130, True, 130)])
def test_kernel_matches_plain_on_card(cuda, dtype, d, lq, lk, causal,
                                      bias_rows):
    g = torch.Generator(device=cuda).manual_seed(1)
    b, h, h_kv = 2, 8, 4
    q = torch.randn(b, h, lq, d, device=cuda, generator=g).to(dtype)
    k = torch.randn(b, h_kv, lk, d, device=cuda, generator=g).to(dtype)
    v = torch.randn(b, h_kv, lk, d, device=cuda, generator=g).to(dtype)
    bias = None
    if bias_rows:
        bias = torch.randn(b, 1, bias_rows, lk, device=cuda, generator=g)
        bias[bias > 1.0] = NEG_INF
        if bias_rows > 1:
            bias[:, :, 5] = NEG_INF          # a fully-masked row
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q, k, v, bias, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    ref, ref_lse = flash_attention_fwd_ref(q, k, v, bias, causal=causal)
    atol = 1e-4 if dtype == torch.float32 else bf16_atol(ref, v)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)
    if bias_rows > 1:
        assert torch.all(out[:, :, 5] == 0)
        assert torch.all(lse[:, :, 5] == -1e30)
