"""Paged-decode attention in the PyTorch port (``ops.paged_decode``).

On the CPU the wrapper runs its plain version, held here against the JAX
package's Pallas kernel (interpret mode, as
``tests/test_paged_decode_kernel.py`` runs it) and against its XLA gather
fallback, at that test's shapes and fp32 bound (atol 2e-5). Dead lanes
(seq_len 0) are compared with the kernel only: the fallback gives them the
mean of V. The cases marked ``cuda`` run the hand-written kernel against
the plain version and skip without a card. JAX is loaded by the ``jx``
fixture, so the card's cases also run where JAX is not installed."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vyomai_tpu_torch.ops import paged_attention as tpa
from vyomai_tpu_torch.ops.paged_decode import (paged_attention_decode_ref,
                                               paged_decode)

torch.set_num_threads(1)

ATOL = 2e-5   # tests/test_paged_decode_kernel.py fp32 bound
B, H, H_KV, D, BS, MAXB, NB = 3, 8, 2, 64, 8, 6, 32


@pytest.fixture(scope="module")
def jx():
    """The JAX package's kernel (in interpret mode) and gather fallback."""
    jnp = pytest.importorskip("jax.numpy")
    from vyomai_tpu.ops import paged_decode_pallas as pdp
    from vyomai_tpu.ops.paged_attention import paged_attention_decode
    pdp.set_interpret(True)
    yield SimpleNamespace(jnp=jnp, pdp=pdp, xla=paged_attention_decode)
    pdp.set_interpret(False)


def _setup(seed=0, h=H, h_kv=H_KV, ctx=(17, 33, 48)):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, h, D)).astype(np.float32)
    pool = rng.standard_normal((NB, 2, BS, h_kv * D)).astype(np.float32)
    bt = rng.permutation(NB)[:B * MAXB].reshape(B, MAXB).astype(np.int32)
    return q, pool, bt, np.asarray(ctx, np.int32)


def _both(jx, q, pool, bt, sl, h_kv):
    ref = np.asarray(jx.pdp.paged_attention_decode_pallas(
        *map(jx.jnp.asarray, (q, pool, bt, sl)), h_kv))
    got = paged_decode(*map(torch.from_numpy, (q, pool, bt, sl)), h_kv)
    return got.numpy(), ref


CASES = {
    "gqa": dict(),
    "mha": dict(h=2, h_kv=2),
    "partial_blocks": dict(ctx=(1, 9, 47)),
    "oversized_seq_len": dict(ctx=(MAXB * BS + 13, 9, MAXB * BS)),
    "dead_lane": dict(ctx=(0, 20, 5)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_kernel(jx, name):
    kw = CASES[name]
    q, pool, bt, sl = _setup(seed=len(name), **kw)
    h_kv = kw.get("h_kv", H_KV)
    got, ref = _both(jx, q, pool, bt, sl, h_kv)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    if name == "dead_lane":
        assert np.all(got[0] == 0.0)


def test_minus_one_table_entries_read_block_zero(jx):
    q, pool, bt, sl = _setup(seed=7, ctx=(10, 3, 16))
    bt[:, 2:] = -1                      # only two live blocks per lane
    got, ref = _both(jx, q, pool, bt, sl, H_KV)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["gqa", "mha", "oversized_seq_len"])
def test_plain_matches_xla_fallback(jx, name):
    kw = CASES[name]
    q, pool, bt, sl = _setup(seed=11, **kw)
    h_kv = kw.get("h_kv", H_KV)
    capped = np.minimum(sl, MAXB * BS)
    ref = np.asarray(jx.xla(*map(jx.jnp.asarray, (q, pool, bt, capped)),
                            h_kv))
    got = paged_attention_decode_ref(*map(torch.from_numpy,
                                          (q, pool, bt, sl)), h_kv)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


def test_port_fallback_matches_jax_fallback_incl_dead_lane(jx):
    q, pool, bt, sl = _setup(seed=3, ctx=(0, 20, 5))
    ref = np.asarray(jx.xla(*map(jx.jnp.asarray, (q, pool, bt, sl)), H_KV))
    got = tpa.paged_attention_decode(*map(torch.from_numpy,
                                          (q, pool, bt, sl)), H_KV)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


def test_wrapper_counts_no_cpu_launch():
    before = paged_decode.launches
    q, pool, bt, sl = _setup()
    paged_decode(*map(torch.from_numpy, (q, pool, bt, sl)), H_KV)
    assert paged_decode.launches == before


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def bf16_atol(ref: torch.Tensor) -> float:
    """Both versions read the same bf16 inputs and reduce in fp32; they can
    differ by fp32 summation order (1e-4) plus one bf16 ulp of the output
    after the final cast (2^-7 of its largest magnitude)."""
    return 2.0 ** -7 * float(ref.float().abs().max()) + 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_kernel_matches_plain_on_card(cuda, dtype, d):
    g = torch.Generator(device=cuda).manual_seed(0)
    b, h, h_kv, bs, maxb, nb = 5, 16, 8, 16, 8, 64
    q = torch.randn(b, h, d, device=cuda, generator=g).to(dtype)
    pool = torch.randn(nb, 2, bs, h_kv * d, device=cuda,
                       generator=g).to(dtype)
    bt = torch.randperm(nb, device=cuda, generator=g)[:b * maxb].reshape(
        b, maxb).int()
    bt[1, 5:] = -1
    sl = torch.tensor([37, 70, 0, 128, 500], dtype=torch.int32, device=cuda)
    before = paged_decode.launches
    out = paged_decode(q, pool, bt, sl, h_kv)
    torch.cuda.synchronize()
    assert paged_decode.launches == before + 1
    ref = paged_attention_decode_ref(q, pool, bt, sl, h_kv)
    atol = 1e-4 if dtype == torch.float32 else bf16_atol(ref)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    assert torch.all(out[2] == 0)
