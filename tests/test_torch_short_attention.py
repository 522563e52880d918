"""Short attention in the PyTorch port (``ops.short_attention``).

On the CPU the autograd Functions run the plain versions of K5/K6 and K7;
they are held against the JAX package's Pallas kernels in interpret mode
(``short_attention``, ``short_attention_bias``, ``short_attention_qkv``)
and their ``jax.grad`` at the ViT shape (B=2, H=4, L=197, D=64) and an
odd head count, fp32 at "highest" matmul precision: forward atol 2e-6,
gradients 5e-5 times the largest gradient. Also: the gates, a row whose
keys are all padded (the mean of V), the ``sdpa`` routes, and
``gradcheck`` at fp64. The cases marked ``cuda`` run the hand-written
kernels against the plain versions and skip without a card. JAX is loaded
by the ``jx`` fixture, so the card's cases also run where JAX is not
installed."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from vyomai_tpu_torch.core.masks import NEG_INF
from vyomai_tpu_torch.layers import attention as tattn
from vyomai_tpu_torch.ops import short_attention as sa

torch.set_num_threads(1)

B, H, L, D = 2, 4, 197, 64
FWD_ATOL = 2e-6
GRAD_RTOL_OF_MAX = 5e-5


@pytest.fixture(scope="module")
def jx():
    """The JAX package's short attention, in interpret mode."""
    jax = pytest.importorskip("jax")
    from vyomai_tpu.ops import flash_attention as jfa
    from vyomai_tpu.ops import short_attention as jsa
    jfa.set_interpret(True)   # short attention shares the flash flag
    yield SimpleNamespace(jax=jax, jnp=jax.numpy, sa=jsa)
    jfa.set_interpret(False)


def _arrays(seed, b=B, h=H, l=L, d=D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, l, d)).astype(np.float32)
            for _ in range(4)]


def _keypad(b, l, n_pad, all_padded_row=False):
    """Additive key-pad bias [B, 1, 1, L]: the last ``n_pad`` keys of
    every row padded (every key of row 0 with ``all_padded_row``)."""
    bias = np.zeros((b, 1, 1, l), np.float32)
    bias[..., l - n_pad:] = NEG_INF
    if all_padded_row:
        bias[0] = NEG_INF
    return bias


def _assert_grads(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        atol = GRAD_RTOL_OF_MAX * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


def _torch_run(fn, inputs, do):
    """``fn(*inputs)`` and the gradients of ``sum(out * do)``."""
    ts = [torch.from_numpy(x).requires_grad_() for x in inputs]
    out = fn(*ts)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax_run(jx, fn, inputs, do):
    j = jx.jnp.asarray
    with jx.jax.default_matmul_precision("highest"):
        out = fn(*map(j, inputs))
        grads = jx.jax.grad(lambda *a: jx.jnp.sum(fn(*a) * j(do)),
                            argnums=tuple(range(len(inputs))))(
            *map(j, inputs))
    return np.asarray(out), grads


@pytest.mark.parametrize("heads,with_bias", [(4, False), (4, True),
                                             (3, False), (3, True)])
def test_k5_k7_match_pallas(jx, heads, with_bias):
    """K5 (paired kernel at even H, unpaired at odd H) and its gradients:
    the Pallas backward K7 without a bias, ``_bwd_math`` with one."""
    q, k, v, do = _arrays(heads + 10 * with_bias, h=heads)
    if with_bias:
        bias = _keypad(B, L, 31)

        def jfn(q_, k_, v_):
            return jx.sa.short_attention_bias(q_, k_, v_,
                                              jx.jnp.asarray(bias))

        def tfn(q_, k_, v_):
            return sa.short_attention_bias(q_, k_, v_,
                                           torch.from_numpy(bias))
    else:
        jfn, tfn = jx.sa.short_attention, sa.short_attention
    want_out, want_grads = _jax_run(jx, jfn, (q, k, v), do)
    out, grads = _torch_run(tfn, (q, k, v), do)
    np.testing.assert_allclose(out, want_out, atol=FWD_ATOL, rtol=0)
    _assert_grads(grads, want_grads)


def _pack(q, k, v):
    b, h, l, d = q.shape
    return np.stack([q, k, v], axis=1).transpose(0, 3, 1, 2, 4).reshape(
        b, l, 3 * h * d)


def test_k6_matches_pallas(jx):
    """The packed layout: K6 forward and the K7 backward into packed dx."""
    q, k, v, _ = _arrays(5)
    x3 = _pack(q, k, v)
    do = np.random.default_rng(6).standard_normal(
        (B, L, H * D)).astype(np.float32)
    want_out, want_grads = _jax_run(
        jx, lambda x: jx.sa.short_attention_qkv(x, H), (x3,), do)
    out, grads = _torch_run(lambda x: sa.short_attention_qkv(x, H), (x3,),
                            do)
    np.testing.assert_allclose(out, want_out, atol=FWD_ATOL, rtol=0)
    _assert_grads(grads, want_grads)


def test_k6_odd_heads_equals_unpacked():
    """The port's packed route takes any head count (the TPU's even-H
    condition is its head pairing); it equals K5 on the same heads."""
    q, k, v, _ = _arrays(7, h=3)
    x3 = torch.from_numpy(_pack(q, k, v)).requires_grad_()
    assert sa.supported_packed(x3, 3)
    out = sa.short_attention_qkv(x3, 3)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    ref = sa.short_attention(qt, kt, vt).transpose(1, 2).reshape(B, L, -1)
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=0)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    out.backward(g)
    ref.backward(g)
    want = torch.from_numpy(_pack(qt.grad.numpy(), kt.grad.numpy(),
                                  vt.grad.numpy()))
    torch.testing.assert_close(x3.grad, want, atol=1e-6, rtol=0)


def test_all_padded_row_is_mean_of_v(jx):
    """A row whose keys are all padded gets a uniform softmax: the mean of
    V, from the port, the Pallas kernel and the "xla" route alike (not the
    flash kernels' 0)."""
    q, k, v, _ = _arrays(8)
    bias = _keypad(B, L, 17, all_padded_row=True)
    out, stats = sa.short_attention_fwd(*(torch.from_numpy(x)
                                          for x in (q, k, v, bias)))
    mean_v = v[0].mean(axis=1, keepdims=True)
    np.testing.assert_allclose(out[0].numpy(),
                               np.broadcast_to(mean_v, out[0].shape),
                               atol=1e-6, rtol=0)
    assert torch.all(stats[0, ..., 1] == L)      # every key weighs 1
    with jx.jax.default_matmul_precision("highest"):
        want = np.asarray(jx.sa.short_attention_bias(
            *(jx.jnp.asarray(x) for x in (q, k, v, bias))))
    np.testing.assert_allclose(out.numpy(), want, atol=FWD_ATOL, rtol=0)
    xla = tattn._sdpa_xla(*(torch.from_numpy(x) for x in (q, k, v, bias)))
    torch.testing.assert_close(out, xla, atol=FWD_ATOL, rtol=0)


def test_gates():
    q = torch.zeros(B, H, L, D)
    assert sa.supported(q, q, None)
    assert not sa.supported(q, q, None, causal=True)
    assert not sa.supported(q, q, None, window=64)
    assert not sa.supported(q, q, None, segments=(1, 2))
    assert sa.supported(q, q, torch.zeros(B, 1, 1, L))
    assert sa.supported(q, q, torch.zeros(1, 1, 1, L))
    assert not sa.supported(q, q, torch.zeros(B, 1, L, L))
    assert not sa.supported(q, q[:, :2], None)             # GQA
    assert not sa.supported(q[:, :, :1], q[:, :, :1], None)
    big = torch.zeros(1, 4, 1024, 64)
    assert not sa.supported(big, big, None)
    assert not sa.supported(q.double(), q.double(), None)
    assert not sa.supported(q[..., :16], q[..., :16], None)
    # the TPU's VMEM budget is not a condition here
    huge = torch.zeros(1, 64, 512, 128)
    assert sa.supported(huge, huge, None)
    assert sa.supported(q[:, :, :8, :32], q[:, :, :8, :32], None)
    x = torch.zeros(B, L, 3 * 5 * 64)
    assert sa.supported_packed(x, 5) and not sa.supported_packed(x, 7)
    assert not sa.supported_packed(torch.zeros(B, 600, 3 * 4 * 64), 4)


@pytest.fixture
def short_route():
    tattn.set_sdpa_impl("short")
    yield
    tattn.set_sdpa_impl("auto")


def test_forced_short_raises_on_unsupported(short_route):
    q, k, v, _ = (torch.from_numpy(x) for x in _arrays(9))
    with pytest.raises(ValueError):
        tattn.sdpa(q, k, v, causal=True)
    with pytest.raises(ValueError):
        tattn.sdpa(q, k[:, :2], v[:, :2])                 # GQA
    with pytest.raises(ValueError):
        tattn.sdpa(q, k, v, torch.zeros(B, 1, L, L))      # not key-pad
    with pytest.raises(ValueError):
        tattn.sdpa(q, k, v, window=16)
    bias = torch.from_numpy(_keypad(B, L, 8))
    torch.testing.assert_close(tattn.sdpa(q, k, v, bias),
                               tattn._sdpa_xla(q, k, v, bias),
                               atol=FWD_ATOL, rtol=0)


def test_auto_route_on_cpu_is_xla():
    """CPU tensors take the "xla" route under "auto" (the kernels run only
    on the card)."""
    q, k, v, _ = (torch.from_numpy(x) for x in _arrays(10))
    bias = torch.from_numpy(_keypad(B, L, 8))
    before = sa.short_attention_fwd.launches
    torch.testing.assert_close(tattn.sdpa(q, k, v, bias),
                               tattn._sdpa_xla(q, k, v, bias), atol=0,
                               rtol=0)
    assert sa.short_attention_fwd.launches == before


def test_gradcheck_fp64():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 3, 9, 8, generator=g, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    bias = torch.zeros(1, 1, 1, 9, dtype=torch.float64)
    bias[..., 6:] = NEG_INF
    assert torch.autograd.gradcheck(
        lambda *a: sa.short_attention_bias(*a, bias), (q, k, v))
    x = torch.randn(2, 9, 3 * 3 * 8, generator=g, dtype=torch.float64,
                    requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda x_: sa.short_attention_qkv(x_, 3), (x,))


def test_bwd_writes_given_grads_on_cpu():
    """``short_attention_bwd(..., grads=...)`` fills the given views (the
    packed dx) with the plain backward's values."""
    q, k, v, do = (torch.from_numpy(x) for x in _arrays(11, l=24))
    out, stats = sa.short_attention_fwd(q, k, v)
    delta = sa._delta(out, do)
    want = sa.short_attention_bwd_ref(q, k, v, None, do, stats, delta)
    dx = torch.zeros(B, 24, 3 * H * D)
    got = sa.short_attention_bwd(q, k, v, None, do, stats, delta,
                                 grads=sa._unpack(dx, H))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(sa._unpack(dx, H)[1], want[1])


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _atol(ref: torch.Tensor, dtype) -> float:
    """Same inputs on both sides, fp32 reductions: fp32 order (1e-4 of the
    largest value) plus, for bf16, one ulp of the output after the final
    cast."""
    top = float(ref.float().abs().max())
    return ((2.0 ** -7 if dtype == torch.bfloat16 else 0.0) + 1e-4) * top \
        + 1e-6


def _fwd_atol(ref: torch.Tensor, v: torch.Tensor, dtype) -> float:
    """The forward's bound: ``_atol``, plus for bf16 the kernel's rounding
    of P to bf16 before P.V, at most 2^-8 of each weight (bf16's unit
    roundoff), which moves an output by at most 2^-8 max|v|."""
    extra = (2.0 ** -8 * float(v.float().abs().max())
             if dtype == torch.bfloat16 else 0.0)
    return _atol(ref, dtype) + extra


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,l,d,pad", [
    (4, 12, 197, 64, False), (4, 12, 128, 64, True), (2, 5, 512, 128, True),
    (3, 3, 8, 32, True), (2, 4, 100, 32, False), (2, 3, 300, 32, True),
    (2, 4, 197, 128, False)])
def test_kernels_match_plain_on_card(cuda, dtype, b, h, l, d, pad):
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, do = (torch.randn(b, h, l, d, device=cuda, generator=g)
                   .to(dtype) for _ in range(4))
    bias = None
    if pad:
        bias = torch.zeros(b, 1, 1, l, device=cuda)
        bias[..., l - l // 3:] = NEG_INF
        bias[0] = NEG_INF                     # a row with every key padded
    before = (sa.short_attention_fwd.launches, sa.short_attention_bwd.launches)
    out, stats = sa.short_attention_fwd(q, k, v, bias)
    delta = sa._delta(out, do)
    got = sa.short_attention_bwd(q, k, v, bias, do, stats, delta)
    torch.cuda.synchronize()
    assert (sa.short_attention_fwd.launches,
            sa.short_attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    ref, _ = sa.short_attention_fwd_ref(q, k, v, bias)
    atol = _fwd_atol(ref, v, dtype)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    if pad:   # every key of row 0 padded: the mean of V
        mean_v = v[0].float().mean(dim=1, keepdim=True)
        torch.testing.assert_close(out[0].float(), mean_v.expand_as(
            out[0]), atol=atol, rtol=0)
    # bf16: the tensor-core K7 also rounds P and dS to bf16 before their
    # products (chip_smoke.k7_rounding)
    rounding = (chip_smoke.k7_rounding(torch, q, k, v, bias, do, stats, delta)
                if dtype == torch.bfloat16 else {})
    for name, x, w in zip(("dq", "dk", "dv"), got, sa.short_attention_bwd_ref(
            q, k, v, bias, do, stats, delta)):
        torch.testing.assert_close(
            x.float(), w.float(), atol=_atol(w, dtype) + rounding.get(name, 0.0),
            rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [12, 3])
def test_packed_kernels_match_plain_on_card(cuda, h):
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(4, 197, 3 * h * 64, device=cuda, generator=g).to(
        torch.bfloat16).requires_grad_()
    before = sa.short_attention_qkv_fwd.launches
    out = sa.short_attention_qkv(x, h)
    do = torch.randn(out.shape, device=cuda, generator=g).to(out.dtype)
    out.backward(do)
    torch.cuda.synchronize()
    assert sa.short_attention_qkv_fwd.launches == before + 1
    xr = x.detach().float().cpu().requires_grad_()
    ref = sa.short_attention_qkv(xr, h)
    ref.backward(do.float().cpu())
    torch.testing.assert_close(out.float().cpu(), ref.detach(),
                               atol=_fwd_atol(ref, xr.detach()[..., 2 * h * 64:],
                                             torch.bfloat16),
                               rtol=0)
    # twice the bound: the card's delta = rowsum(dO * O) reads the
    # bf16-rounded O, the CPU's the fp32 O; plus the tensor-core K7's
    # rounding of P and dS (chip_smoke.k7_rounding, on the CPU's operands)
    qr, kr, vr = sa._unpack(xr.detach(), h)
    dor = do.float().cpu().view(4, 197, h, 64).transpose(1, 2)
    _, stats = sa.short_attention_fwd_ref(qr, kr, vr)
    out4 = ref.detach().view(4, 197, h, 64).transpose(1, 2)
    rounding = max(chip_smoke.k7_rounding(torch, qr, kr, vr, None, dor, stats,
                                          sa._delta(out4, dor)).values())
    torch.testing.assert_close(x.grad.float().cpu(), xr.grad,
                               atol=2 * _atol(xr.grad, torch.bfloat16)
                               + rounding, rtol=0)
