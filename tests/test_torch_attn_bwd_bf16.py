"""The bf16 arithmetic of the tensor-core K7 backward:
``short_bwd_dq_kernel_tc`` and ``short_bwd_dkv_kernel_tc``
(``vyomai_tpu_torch/csrc/attn_bwd_tc.cuh``).

On the card those kernels read bf16 q/k/v/dO, take fp32 S = q.k^T and
dP = dO.v^T from the tensor cores, rebuild P = exp(S / sqrt(D) + bias -
max) / sum from the forward's row stats, form dS = P (dP - delta) /
sqrt(D) in fp32, round P and dS to bf16 as the A operands of their
products and accumulate dV = P^T.dO, dK = dS^T.q and dQ = dS.k in fp32
over 64-row tiles. ``emulate_bwd`` below does the same on the CPU. With
bf16-valued inputs made from numpy seeds at small sizes (H 2 and 3, L 8,
100 and 197, D 32 and 64) it is held against the JAX package's ``_kernel_bwd``
in interpret mode (no bias), its ``_bwd_math`` (key-pad bias, with a batch
row whose keys are all padded) and the port's ``short_attention_bwd_ref``
on bf16 tensors, under the card's bound ``chip_smoke.grad_atol``:

    atol = (2^-7 + 1e-4) max|ref| + 1e-6 + rounding,

one bf16 ulp of the gradient after its cast plus fp32 summation order,
plus ``chip_smoke.k7_rounding``: rounding P and dS to bf16 (unit roundoff
2^-8) moves dV by at most 2^-8 max(P^T |dO|), dK by 2^-8 max(|dS|^T |q|)
and dQ by 2^-8 max(|dS| |k|). Before the cast the emulation stays within
the rounding and fp32 terms alone. The ``cuda`` cases hold the kernels to
the plain version under the same bound at the ViT and MLM shapes, and skip
without a card."""

import ctypes
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import grad_atol, k7_rounding
from vyomai_tpu_torch.core.masks import NEG_INF
from vyomai_tpu_torch.ops import _build
from vyomai_tpu_torch.ops import short_attention as sa

torch.set_num_threads(1)

LOG2E = 1.4426950408889634
TILE = 64   # rows of a streamed tile of the kernels
NAMES = ("dq", "dk", "dv")


@pytest.fixture(scope="module")
def jx():
    """The JAX package's short attention, in interpret mode."""
    jax = pytest.importorskip("jax")
    from vyomai_tpu.ops import flash_attention as jfa
    from vyomai_tpu.ops import short_attention as jsa
    jfa.set_interpret(True)   # short attention shares the flash flag
    yield SimpleNamespace(jax=jax, jnp=jax.numpy, sa=jsa)
    jfa.set_interpret(False)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16, held in fp32."""
    return x.bfloat16().float()


def _normal(rng, *shape) -> torch.Tensor:
    return _bf16(torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)))


def emulate_bwd(q, k, v, bias, do, stats, delta):
    """The tensor-core K7's arithmetic on fp32 tensors holding bf16 values
    (``[B, H, L, D]``), with the forward's ``stats`` (row max, row sum) and
    ``delta = rowsum(dO * O)``: fp32 scores, P = 2^((x - max) log2 e) /
    sum, dS in fp32, P and dS rounded to bf16 before their products, and
    fp32 sums over 64-row tiles. Returns (dq, dk, dv) before their cast."""
    scale = torch.tensor(1.0 / np.sqrt(q.shape[-1]), dtype=torch.float32)
    x = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if bias is not None:
        x = x + bias
    # (x - max) first: x * log2e - max * log2e overflows finfo.min
    p = torch.exp2((x - stats[..., :1]) * LOG2E) * (1.0 / stats[..., 1:])
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v)
    ds = p * (dp - delta[..., None]) * scale
    pb, dsb = _bf16(p), _bf16(ds)
    dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
    for t in range(0, q.shape[2], TILE):   # dq: 64-key tiles
        dq += torch.einsum("bhqk,bhkd->bhqd", dsb[..., t:t + TILE],
                           k[:, :, t:t + TILE])
    for t in range(0, q.shape[2], TILE):   # dk/dv: 64-row q tiles
        rows = slice(t, t + TILE)
        dk += torch.einsum("bhqk,bhqd->bhkd", dsb[:, :, rows], q[:, :, rows])
        dv += torch.einsum("bhqk,bhqd->bhkd", pb[:, :, rows], do[:, :, rows])
    return dq, dk, dv


def _inputs(seed, b, h, l, d, pad):
    """bf16-valued q, k, v, dO; a key-pad bias (the last l // 4 keys of
    each batch row, and every key of row 0) when ``pad``; the plain fp32
    forward's stats and delta."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (_normal(rng, b, h, l, d) for _ in range(4))
    bias = None
    if pad:
        bias = torch.zeros(b, 1, 1, l)
        bias[..., l - max(1, l // 4):] = NEG_INF
        bias[0] = NEG_INF
    out, stats = sa.short_attention_fwd_ref(q, k, v, bias)
    return q, k, v, bias, do, stats, sa._delta(out, do)


def _check(emu, want, rounding):
    """``emu`` against fp32 ``want``: before the cast within the rounding
    and fp32 terms, after it within the card's bf16 bound."""
    for name, e, w in zip(NAMES, emu, want):
        w = torch.from_numpy(np.array(w, dtype=np.float32))
        err = float((e - w).abs().max())
        assert err <= grad_atol(w, False, rounding[name]), (name, err)
        err = float((_bf16(e) - w).abs().max())
        assert err <= grad_atol(w, True, rounding[name]), (name, err)


def _check_plain(emu, args):
    """``emu`` cast to bf16 against the port's plain version on bf16
    tensors: the bound that ``chip_smoke`` holds the card to."""
    q, k, v, bias, do, stats, delta = args
    plain = sa.short_attention_bwd_ref(
        *(x.bfloat16() for x in (q, k, v)), bias, do.bfloat16(), stats, delta)
    rounding = k7_rounding(torch, *args)
    for name, e, w in zip(NAMES, emu, plain):
        assert w.dtype == torch.bfloat16
        err = float((_bf16(e) - w.float()).abs().max())
        assert err <= grad_atol(w, True, rounding[name]), (name, err)


SHAPES = [(2, 8, 32), (3, 8, 64), (2, 100, 64), (3, 100, 32), (2, 197, 64),
          (3, 197, 32)]


@pytest.mark.parametrize("h,l,d", SHAPES)
def test_emulation_matches_pallas_kernel_bwd(jx, h, l, d):
    """No bias: the JAX package's ``_kernel_bwd`` (its Pallas K7) in
    interpret mode, fp32 from the same bf16 values."""
    args = _inputs(h * 1000 + l + d, 2, h, l, d, pad=False)
    q, k, v, _, do, _, _ = args
    j = jx.jnp.asarray
    with jx.jax.default_matmul_precision("highest"):
        want = jx.sa._bwd_pallas(*(j(x.numpy()) for x in (q, k, v, do)))
    emu = emulate_bwd(*args)
    _check(emu, want, k7_rounding(torch, *args))
    _check_plain(emu, args)


@pytest.mark.parametrize("h,l,d", SHAPES)
def test_emulation_matches_bwd_math_keypad(jx, h, l, d):
    """Key-pad bias: the JAX package's ``_bwd_math`` (the backward of its
    ``short_attention_bias``), with batch row 0's keys all padded."""
    args = _inputs(h * 1000 + l + d + 1, 2, h, l, d, pad=True)
    q, k, v, bias, do, _, _ = args
    j = jx.jnp.asarray
    with jx.jax.default_matmul_precision("highest"):
        want = jx.sa._bwd_math(*(j(x.numpy()) for x in (q, k, v, do)),
                               j(bias.numpy()))[:3]
    emu = emulate_bwd(*args)
    _check(emu, want, k7_rounding(torch, *args))
    _check_plain(emu, args)


def test_all_padded_row(jx):
    """Every key of batch row 0 padded (every score finfo.min): P is
    uniform, 1/L, and the gradients are the plain version's. The exponent
    is (x - max) log2 e: written as x log2 e - max log2 e it overflows
    finfo.min to -inf and gives NaN."""
    l = 100
    args = _inputs(7, 2, 3, l, 64, pad=True)
    q, k, v, bias, do, stats, delta = args
    x = (torch.einsum("bhqd,bhkd->bhqk", q, k) / 8.0 + bias)[0]
    m = stats[0, ..., :1]
    assert torch.all(x == m) and torch.all(stats[0, ..., 1] == l)
    p = torch.exp2((x - m) * LOG2E) / stats[0, ..., 1:]
    assert torch.all(p == 1.0 / l)
    assert torch.isnan(torch.exp2(x * LOG2E - m * LOG2E)).all()
    emu = emulate_bwd(*args)
    assert all(bool(torch.isfinite(e).all()) for e in emu)
    want = sa.short_attention_bwd_ref(q, k, v, bias, do, stats, delta)
    rounding = k7_rounding(torch, *args)
    for name, e, w in zip(NAMES, emu, want):
        err = float((e[0] - w[0]).abs().max())
        assert err <= grad_atol(w, False, rounding[name]), (name, err)
    j = jx.jnp.asarray
    with jx.jax.default_matmul_precision("highest"):
        jwant = jx.sa._bwd_math(*(j(t.numpy()) for t in (q, k, v, do)),
                                j(bias.numpy()))[:3]
    _check(emu, jwant, rounding)


def test_rounding_term_is_what_the_bound_adds():
    """Without its bf16 rounding of P and dS the emulation is the plain
    arithmetic (within fp32 order), and the rounding moves it by no more
    than ``k7_rounding``, which is not vacuous: it exceeds the fp32 term."""
    args = _inputs(11, 2, 2, 100, 64, pad=True)
    want = sa.short_attention_bwd_ref(*args)
    emu = emulate_bwd(*args)
    rounding = k7_rounding(torch, *args)
    for name, e, w in zip(NAMES, emu, want):
        moved = float((e - w).abs().max())
        assert moved <= rounding[name] + 1e-4 * float(w.abs().max()) + 1e-6
        assert rounding[name] > 1e-4 * float(w.abs().max())


_C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong}


def test_short_bwd_launch_signature_matches_source():
    """The ctypes types ``_build`` declares for ``short_bwd_launch`` match
    its C parameters, the dtype flag (which picks the tensor-core or the
    CUDA-core kernels) an int just before the stream."""
    src = (_build.CSRC / "short_attention.cu").read_text()
    params = re.search(r'extern "C" int short_bwd_launch\(([^)]*)\)',
                       src).group(1).split(",")
    types = []
    for param in params:
        kind = " ".join(param.split()[:-1]).replace("const ", "")
        types.append(ctypes.c_void_p if kind.endswith("*")
                     else _C_TYPES[kind])
    assert _build._SIGNATURES["short_bwd_launch"] == types
    assert params[-2].split()[-1] == "is_bf16" and types[-2] == ctypes.c_int


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,l,packed", [(32, 12, 197, True),
                                          (64, 12, 128, False),
                                          (16, 12, 512, False)])
def test_tensor_core_k7_matches_plain_on_card(cuda, b, h, l, packed):
    """ViT train (packed [32, 197, 2304]) and MLM (S=128 B=64, S=512 B=16,
    key-pad bias with batch row 0 all padded), D=64, bf16: the kernels
    against the plain version on the same inputs, stats and delta."""
    g = torch.Generator(device=cuda).manual_seed(l)
    d = 64
    bias = None
    if packed:
        qkv = torch.randn(b, l, 3 * h * d, device=cuda, generator=g).bfloat16()
        q, k, v = sa._unpack(qkv, h)
        out, stats = sa.short_attention_qkv_fwd(qkv, h)
        out = out.view(b, l, h, d).transpose(1, 2)
        grads = sa._unpack(torch.empty_like(qkv), h)
    else:
        q, k, v = (torch.randn(b, h, l, d, device=cuda, generator=g)
                   .bfloat16() for _ in range(3))
        lens = torch.randint(l // 2, l + 1, (b,), device=cuda, generator=g)
        lens[0] = 0
        bias = torch.where(torch.arange(l, device=cuda)[None]
                           < lens[:, None], 0.0, NEG_INF)[:, None, None]
        out, stats = sa.short_attention_fwd(q, k, v, bias)
        grads = None
    do = torch.randn(b, h, l, d, device=cuda, generator=g).bfloat16()
    delta = sa._delta(out, do)
    before = sa.short_attention_bwd.launches
    got = sa.short_attention_bwd(q, k, v, bias, do, stats, delta,
                                 grads=grads)
    torch.cuda.synchronize()
    assert sa.short_attention_bwd.launches == before + 1
    want = sa.short_attention_bwd_ref(q, k, v, bias, do, stats, delta)
    rounding = chip_smoke.k7_rounding(torch, q, k, v, bias, do, stats, delta)
    for name, x, w in zip(NAMES, got, want):
        assert bool(torch.isfinite(x).all()), name
        err = float((x.float() - w.float()).abs().max())
        assert err <= grad_atol(w, True, rounding[name]), (name, err)
