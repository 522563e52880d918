"""Flash-attention backward in the PyTorch port (``ops.flash_attention``).

On the CPU the autograd Function runs the plain versions of K1 and K2/K3;
their gradients are held against the JAX package's Pallas backward
(``_bwd``, and ``jax.vjp`` of ``flash_attention_bias`` for ragged lengths)
in interpret mode, at fp32 with atol 2e-5 times the largest gradient:
causal with q_offset, row-broadcast and full bias, GQA groups 1/2/4,
Lq != Lk, ragged lengths, fully-masked rows (zero gradient from both).
``gradcheck`` holds the Function to finite differences at fp64. The cases
marked ``cuda`` run the hand-written kernels against the plain versions
and skip without a card: fp32 (CUDA cores) within 1e-4 of each gradient's
max, bf16 (tensor cores, P and dS rounded to bf16 before their products)
within ``chip_smoke.grad_atol`` with ``chip_smoke.flash_bwd_rounding``'s
term. JAX is loaded by the ``jx`` fixture, so the
card's cases also run where JAX is not installed."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chip_smoke import flash_bwd_rounding, grad_atol
from vyomai_tpu_torch.core.masks import NEG_INF
from vyomai_tpu_torch.ops import flash_attention as fa
from vyomai_tpu_torch.ops.flash_attention import (
    _delta, flash_attention_bias, flash_attention_bwd,
    flash_attention_bwd_ref, flash_attention_fwd, flash_attention_fwd_ref,
    flash_bwd_dkv, flash_bwd_dq)

torch.set_num_threads(1)

RTOL_OF_MAX = 2e-5


@pytest.fixture(scope="module")
def jx():
    """The JAX package's flash attention, in interpret mode."""
    jax = pytest.importorskip("jax")
    from vyomai_tpu.ops import flash_attention as jfa
    jfa.set_interpret(True)
    yield SimpleNamespace(jax=jax, jnp=jax.numpy, fa=jfa)
    jfa.set_interpret(False)


def _arrays(seed, b, h, h_kv, lq, lk, d):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(b, h, lq, d), f(b, h_kv, lk, d), f(b, h_kv, lk, d), \
        f(b, h, lq, d)


def _bias(seed, shape, p_mask=0.3):
    rng = np.random.default_rng(seed)
    bias = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    bias[rng.random(shape) < p_mask] = NEG_INF
    return bias


def _torch_grads(q, k, v, bias, do, causal):
    """Gradients of ``sum(out * do)`` through the port's Function."""
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention_bias(
        qt, kt, vt, None if bias is None else torch.from_numpy(bias),
        causal=causal)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [x.grad.numpy() for x in (qt, kt, vt)]


def _assert_close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        atol = RTOL_OF_MAX * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


CASES = {
    # name: (b, h, h_kv, lq, lk, bias shape or None, causal)
    "causal_square": (2, 4, 4, 32, 32, None, True),
    "causal_offset_gqa2": (2, 4, 2, 16, 48, None, True),
    "causal_pad_bias_gqa4": (2, 8, 2, 32, 32, (2, 1, 1, 32), True),
    "row_bias_group1": (2, 4, 4, 16, 32, (2, 1, 1, 32), False),
    "full_bias_gqa2": (2, 4, 2, 32, 48, (2, 1, 32, 48), False),
    "per_head_bias_gqa4": (1, 4, 1, 16, 32, (1, 4, 16, 32), False),
    "causal_full_bias_offset": (2, 4, 2, 16, 48, (2, 1, 16, 48), True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_grads_match_pallas_bwd(jx, name):
    b, h, h_kv, lq, lk, bshape, causal = CASES[name]
    q, k, v, do = _arrays(len(name), b, h, h_kv, lq, lk, 32)
    bias = None if bshape is None else _bias(len(name), bshape)
    j = jx.jnp.asarray
    jb = None if bias is None else j(bias)
    q_offset = lk - lq
    jout, jlse = jx.fa._fwd(j(q), j(k), j(v), jb, causal, q_offset,
                            block_q=16, block_k=16)
    want = jx.fa._bwd(j(q), j(k), j(v), jb, causal, q_offset, jout, jlse,
                      j(do), block_q=16, block_k=16)
    out, got = _torch_grads(q, k, v, bias, do, causal)
    np.testing.assert_allclose(out, np.asarray(jout), atol=2e-5, rtol=0)
    _assert_close(got, want)


@pytest.mark.parametrize("lq,lk,causal,with_bias", [
    (13, 29, True, False), (11, 19, False, True), (21, 21, True, True)])
def test_ragged_lengths_match_jax_vjp(jx, lq, lk, causal, with_bias):
    """No padding in the port; the JAX pad-and-slice shim must give the
    same gradients."""
    q, k, v, do = _arrays(lq + lk, 2, 4, 2, lq, lk, 32)
    bias = _bias(lk, (2, 1, lq, lk)) if with_bias else None
    j = jx.jnp.asarray

    def f(q_, k_, v_):
        return jx.fa.flash_attention_bias(
            q_, k_, v_, None if bias is None else j(bias), causal=causal)

    _, vjp = jx.jax.vjp(f, j(q), j(k), j(v))
    _, got = _torch_grads(q, k, v, bias, do, causal)
    _assert_close(got, vjp(j(do)))


def test_fully_masked_rows_get_zero_gradient(jx):
    q, k, v, do = _arrays(7, 1, 4, 2, 16, 32, 32)
    bias = _bias(7, (1, 1, 16, 32))
    bias[0, 0, 3] = NEG_INF                  # row 3 sees no key
    j = jx.jnp.asarray
    jout, jlse = jx.fa._fwd(j(q), j(k), j(v), j(bias), False, 16,
                            block_q=16, block_k=16)
    want = jx.fa._bwd(j(q), j(k), j(v), j(bias), False, 16, jout, jlse,
                      j(do), block_q=16, block_k=16)
    _, got = _torch_grads(q, k, v, bias, do, False)
    _assert_close(got, want)
    assert np.all(got[0][:, :, 3] == 0) and np.all(np.asarray(want[0])[:, :, 3] == 0)
    # a key seen only by the masked row gets nothing from it
    bias2 = np.full((1, 1, 16, 32), NEG_INF, np.float32)
    bias2[..., :8] = 0.0
    _, got2 = _torch_grads(q, k, v, bias2, do, False)
    assert np.all(got2[1][:, :, 8:] == 0) and np.all(got2[2][:, :, 8:] == 0)


def test_causal_rows_before_every_key_get_zero_gradient():
    """q_offset < 0: the first rows precede every key."""
    q, k, v, do = (torch.from_numpy(x) for x in _arrays(8, 1, 2, 1, 32, 16,
                                                        32))
    out, lse = flash_attention_fwd(q, k, v, causal=True, q_offset=-8)
    dq, dk, dv = flash_attention_bwd(q, k, v, None, out, lse, do,
                                     causal=True, q_offset=-8)
    assert torch.all(dq[:, :, :8] == 0) and torch.all(out[:, :, :8] == 0)
    assert torch.isfinite(dk).all() and torch.isfinite(dv).all()


def test_gradcheck_fp64():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 5, 8, generator=g, dtype=torch.float64)
    k = torch.randn(1, 2, 7, 8, generator=g, dtype=torch.float64)
    v = torch.randn(1, 2, 7, 8, generator=g, dtype=torch.float64)
    bias = torch.randn(1, 1, 5, 7, generator=g, dtype=torch.float64)
    for causal in (False, True):
        assert torch.autograd.gradcheck(
            lambda q_, k_, v_: flash_attention_bias(q_, k_, v_, bias,
                                                    causal=causal),
            tuple(x.clone().requires_grad_() for x in (q, k, v)))


def test_wrapper_parts_equal_whole_on_cpu():
    """``flash_bwd_dq``/``flash_bwd_dkv`` on the CPU are the plain
    backward's parts."""
    q, k, v, do = (torch.from_numpy(x) for x in _arrays(9, 2, 4, 2, 16, 24,
                                                        32))
    bias = torch.from_numpy(_bias(9, (2, 1, 1, 24)))
    out, lse = flash_attention_fwd_ref(q, k, v, bias, causal=True)
    delta = _delta(out, do)
    dq = flash_bwd_dq(q, k, v, bias, do, lse, delta, causal=True)
    dk, dv = flash_bwd_dkv(q, k, v, bias, do, lse, delta, causal=True)
    for a, b in zip((dq, dk, dv), flash_attention_bwd_ref(
            q, k, v, bias, out, lse, do, causal=True)):
        assert torch.equal(a, b)


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,h,h_kv,lq,lk,causal,bias_rows,q_offset", [
    (64, 8, 2, 256, 256, True, 1, None), (128, 8, 8, 96, 160, False, 96,
                                          None),
    (64, 4, 4, 37, 1000, True, 0, 900), (128, 8, 4, 100, 100, True, 100,
                                         None),
    (64, 4, 1, 64, 64, False, 1, None)])
def test_kernels_match_plain_on_card(cuda, dtype, d, h, h_kv, lq, lk, causal,
                                     bias_rows, q_offset):
    g = torch.Generator(device=cuda).manual_seed(2)
    b = 2
    q = torch.randn(b, h, lq, d, device=cuda, generator=g).to(dtype)
    k = torch.randn(b, h_kv, lk, d, device=cuda, generator=g).to(dtype)
    v = torch.randn(b, h_kv, lk, d, device=cuda, generator=g).to(dtype)
    do = torch.randn(b, h, lq, d, device=cuda, generator=g).to(dtype)
    bias = None
    if bias_rows:
        bias = torch.randn(b, 1, bias_rows, lk, device=cuda, generator=g)
        bias[bias > 1.0] = NEG_INF
        if bias_rows > 1:
            bias[:, :, 5] = NEG_INF          # a fully-masked row
    out, lse = flash_attention_fwd(q, k, v, bias, causal=causal,
                                   q_offset=q_offset)
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    got = flash_attention_bwd(q, k, v, bias, out, lse, do, causal=causal,
                              q_offset=q_offset)
    torch.cuda.synchronize()
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    want = flash_attention_bwd_ref(q, k, v, bias, out, lse, do,
                                   causal=causal, q_offset=q_offset)
    rounding = {}
    if dtype == torch.bfloat16:   # the tensor cores round P and dS to bf16
        rounding = flash_bwd_rounding(fa, q, k, v, bias, do, lse,
                                      _delta(out, do), causal=causal,
                                      q_offset=q_offset)
    for name, x, ref in zip(("dq", "dk", "dv"), got, want):
        atol = grad_atol(ref, dtype == torch.bfloat16,
                         rounding.get(name, 0.0))
        torch.testing.assert_close(x.float(), ref.float(), atol=atol,
                                   rtol=0)
    if bias_rows > 1:
        assert torch.all(got[0][:, :, 5] == 0)
