"""The bf16 arithmetic of the tensor-core attention forwards: K1's
``flash_fwd_kernel_tc`` and K5/K6's ``short_fwd_kernel_tc``
(``vyomai_tpu_torch/csrc/attn_fwd_tc.cuh``).

On the card those kernels read bf16 q/k/v, take fp32 scores from the
tensor cores, run an online softmax over 64-key tiles, round P to bf16
before the value product, keep fp32 row sums of the unrounded P and
normalise at the end. ``emulate`` below does the same on the CPU. With
bf16-valued inputs made from numpy seeds at small sizes (a few heads,
L <= 200, D 32/64) it is held against (a) the JAX package's Pallas
kernels in interpret mode, which compute in fp32 from the same values, and
(b) the port's plain versions on bf16 tensors, which the card's checks
compare the kernels with, under the card's bf16 tolerance

    atol = 2^-7 max|ref| + 2^-8 max|v| + 1e-4:

one bf16 ulp of the output after the final cast, plus the rounding of P
(at most 2^-8 of each weight, bf16's unit roundoff, so at most 2^-8 max|v|
on an output), plus fp32 summation order. Before the final cast the
emulation stays within the P term alone. The contracts hold too: a fully
masked K1 row gives 0 and lse -1e30, a K5 row whose keys are all padded
gives the mean of V. Last, the C launchers' declared signatures match their
sources, with the flash launchers' bias strides 64-bit."""

import ctypes
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vyomai_tpu_torch.core.masks import NEG_INF
from vyomai_tpu_torch.ops import _build
from vyomai_tpu_torch.ops import flash_attention as fa
from vyomai_tpu_torch.ops import short_attention as sa

torch.set_num_threads(1)

LOG2E = 1.4426950408889634
TILE = 64   # keys per K/V tile of the kernels


@pytest.fixture(scope="module")
def jx():
    """The JAX package's flash and short attention, in interpret mode."""
    jax = pytest.importorskip("jax")
    from vyomai_tpu.ops import flash_attention as jfa
    from vyomai_tpu.ops import short_attention as jsa
    jfa.set_interpret(True)   # short attention shares the flash flag
    yield SimpleNamespace(jax=jax, jnp=jax.numpy, fa=jfa, sa=jsa)
    jfa.set_interpret(False)


def _bf16(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bf16, held in fp32."""
    return torch.from_numpy(x).bfloat16().float().numpy()


def _normal(rng, *shape) -> np.ndarray:
    return _bf16(rng.standard_normal(shape).astype(np.float32))


def bf16_atol(ref, v) -> float:
    """The card's bound for a bf16 attention forward (module docstring)."""
    return (2.0 ** -7 * float(np.abs(ref).max())
            + 2.0 ** -8 * float(np.abs(v).max()) + 1e-4)


def p_atol(v) -> float:
    """The P-rounding term alone (before the output's cast)."""
    return 2.0 ** -8 * float(np.abs(v).max()) + 1e-4


def emulate(q, k, v, mod, *, floor: bool):
    """The tensor-core kernels' arithmetic on fp32 tensors holding bf16
    values: q ``[B, H, Lq, D]``, k/v ``[B, H, Lk, D]`` (repeated over a GQA
    group); ``mod(s)`` applies the kernel's scale, mask and bias to the fp32
    scores. ``floor`` floors the running max at -1e30 (K1). Returns the
    output before its cast, the final row max and the row sum."""
    s = mod(torch.einsum("bhqd,bhkd->bhqk", q, k))
    m = torch.full(q.shape[:3], -torch.inf)
    l = torch.zeros(q.shape[:3])
    o = torch.zeros(q.shape)
    for k0 in range(0, k.shape[2], TILE):
        x = s[..., k0:k0 + TILE]
        m_new = torch.maximum(m, x.amax(dim=-1))
        if floor:
            m_new = m_new.clamp_min(-1e30)
        m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
        alpha = torch.exp2((m - m_use) * LOG2E)
        p = torch.exp2((x - m_use[..., None]) * LOG2E)
        l = alpha * l + p.sum(dim=-1)
        o = alpha[..., None] * o + torch.einsum(
            "bhqk,bhkd->bhqd", p.bfloat16().float(), v[..., k0:k0 + TILE, :])
        m = m_new
    return o, m, l


def _scale(d: int) -> torch.Tensor:
    return torch.tensor(1.0 / np.sqrt(d), dtype=torch.float32)


# -- K1 ------------------------------------------------------------------------

def _engine_bias(rng, n, tp, tctx):
    """The serving prefill's causal-with-offset mask [N, 1, Tp, Tctx]."""
    cached = rng.integers(0, tctx - tp, n)
    t = rng.integers(1, tp + 1, n)
    t[0] = tp
    pos = np.minimum(cached[:, None] + np.arange(tp), (cached + t - 1)[:, None])
    k_pos = np.arange(tctx)[None, None]
    ok = (k_pos <= pos[:, :, None]) & (k_pos < (cached + t)[:, None, None])
    return np.where(ok, 0.0, NEG_INF).astype(np.float32)[:, None]


K1_CASES = {
    # name: (b, h, h_kv, lq, lk, bias kind, causal, q_offset)
    "engine_bias_gqa": (2, 4, 2, 48, 144, "engine", False, None),
    "causal_q_offset": (1, 4, 4, 32, 160, None, True, 80),
    "gqa_causal_square": (1, 8, 2, 80, 80, None, True, 0),
    "masked_row": (1, 2, 1, 32, 96, "masked", False, None),
    "rows_before_keys": (1, 2, 2, 32, 80, None, True, -8),
}


def _k1_inputs(name):
    b, h, h_kv, lq, lk, kind, causal, q_offset = K1_CASES[name]
    rng = np.random.default_rng(len(name))
    d = 64
    q, k, v = (_normal(rng, b, n, l, d)
               for n, l in ((h, lq), (h_kv, lk), (h_kv, lk)))
    bias = None
    if kind == "engine":
        bias = _engine_bias(rng, b, lq, lk)
    elif kind == "masked":
        bias = (rng.standard_normal((b, 1, lq, lk)) * 0.5).astype(np.float32)
        bias[rng.random(bias.shape) < 0.3] = NEG_INF
        bias[:, :, 3] = NEG_INF                  # row 3 sees no key
    return q, k, v, bias, causal, lk - lq if q_offset is None else q_offset


def _k1_emulate(q, k, v, bias, causal, q_offset):
    group = q.shape[1] // k.shape[1]
    lq, lk, d = q.shape[2], k.shape[2], q.shape[3]
    bt = None if bias is None else torch.from_numpy(bias)

    def mod(s):
        s = s * _scale(d)
        if causal:
            past = (torch.arange(lk)[None, :]
                    <= q_offset + torch.arange(lq)[:, None])
            s = s + torch.where(past, 0.0, NEG_INF)
        return s if bt is None else s + bt

    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    o, m, l = emulate(qt, kt.repeat_interleave(group, dim=1),
                      vt.repeat_interleave(group, dim=1), mod, floor=True)
    l_safe = torch.where(l == 0, 1.0, l)
    out = o / l_safe[..., None]
    return out.numpy(), (m + torch.log(l_safe)).numpy()


@pytest.mark.parametrize("name", sorted(K1_CASES))
def test_k1_tensor_core_arithmetic(jx, name):
    q, k, v, bias, causal, q_offset = _k1_inputs(name)
    j = jx.jnp.asarray
    jout, jlse = jx.fa._fwd(j(q), j(k), j(v),
                            None if bias is None else j(bias), causal,
                            q_offset, block_q=16, block_k=16)
    want, want_lse = np.asarray(jout), np.asarray(jlse)[:, :, 0]
    emu, emu_lse = _k1_emulate(q, k, v, bias, causal, q_offset)
    emu_bf16 = _bf16(emu)
    assert np.abs(emu_bf16 - want).max() <= bf16_atol(want, v)
    assert np.abs(emu - want).max() <= p_atol(v)
    np.testing.assert_allclose(emu_lse, want_lse, atol=1e-4, rtol=1e-6)
    plain, plain_lse = fa.flash_attention_fwd(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
        None if bias is None else torch.from_numpy(bias), causal=causal,
        q_offset=q_offset)
    plain = plain.float().numpy()
    assert np.abs(emu_bf16 - plain).max() <= bf16_atol(plain, v)
    np.testing.assert_allclose(emu_lse, plain_lse.numpy(), atol=1e-4,
                               rtol=1e-6)
    dead = np.all(want == 0, axis=-1)            # fully masked rows
    if name in ("masked_row", "rows_before_keys"):
        assert dead.any()
    assert np.all(emu_bf16[dead] == 0) and np.all(emu_lse[dead] == -1e30)
    assert np.all(want_lse[dead] == np.float32(-1e30))


# -- K5 / K6 -------------------------------------------------------------------

def _short_emulate(q, k, v, bias):
    d = q.shape[-1]
    bt = None if bias is None else torch.from_numpy(bias)

    def mod(s):
        s = s * _scale(d)
        return s if bt is None else s + bt

    o, m, l = emulate(*(torch.from_numpy(x) for x in (q, k, v)), mod,
                      floor=False)
    return (o / l[..., None]).numpy(), m.numpy(), l.numpy()


def _check_short(emu, want, plain, v):
    emu_bf16 = _bf16(emu)
    assert np.abs(emu_bf16 - want).max() <= bf16_atol(want, v)
    assert np.abs(emu - want).max() <= p_atol(v)
    assert np.abs(emu_bf16 - plain).max() <= bf16_atol(plain, v)


@pytest.mark.parametrize("l,d", [(150, 32), (197, 64)])
def test_k5_keypad_tensor_core_arithmetic(jx, l, d):
    """Key-pad bias with one batch row whose keys are all padded (the mean
    of V) and a ragged last tile."""
    rng = np.random.default_rng(l + d)
    b, h = 2, 3
    q, k, v = (_normal(rng, b, h, l, d) for _ in range(3))
    bias = np.zeros((b, 1, 1, l), np.float32)
    bias[..., l - 40:] = NEG_INF
    bias[0] = NEG_INF
    j = jx.jnp.asarray
    with jx.jax.default_matmul_precision("highest"):
        want = np.asarray(jx.sa.short_attention_bias(j(q), j(k), j(v),
                                                     j(bias)))
    emu, m, s = _short_emulate(q, k, v, bias)
    plain, stats = sa.short_attention_fwd(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
        torch.from_numpy(bias))
    _check_short(emu, want, plain.float().numpy(), v)
    mean_v = v[0].mean(axis=1, keepdims=True)
    np.testing.assert_allclose(_bf16(emu[0]), np.broadcast_to(
        mean_v, emu[0].shape), atol=bf16_atol(mean_v, v), rtol=0)
    assert np.all(s[0] == l)                     # every key weighs 1
    # the stats mean what the plain version's do: (row max, row sum)
    np.testing.assert_allclose(m, stats[..., 0].numpy(), rtol=1e-6, atol=0)
    np.testing.assert_allclose(s, stats[..., 1].numpy(), rtol=1e-5, atol=0)


def test_k5_ragged_tail_tensor_core_arithmetic(jx):
    """ViT's L = 197 without a bias: the last 64-row tile holds 5 rows."""
    rng = np.random.default_rng(197)
    q, k, v = (_normal(rng, 1, 2, 197, 64) for _ in range(3))
    j = jx.jnp.asarray
    with jx.jax.default_matmul_precision("highest"):
        want = np.asarray(jx.sa.short_attention(j(q), j(k), j(v)))
    emu, _, _ = _short_emulate(q, k, v, None)
    plain, _ = sa.short_attention_fwd(*(torch.from_numpy(x).bfloat16()
                                        for x in (q, k, v)))
    _check_short(emu, want, plain.float().numpy(), v)


@pytest.mark.parametrize("h,l,d", [(2, 130, 64), (3, 70, 32)])
def test_k6_packed_tensor_core_arithmetic(jx, h, l, d):
    """The packed ``[B, L, 3*H*D]`` projection: JAX's packed kernel at an
    even head count; at an odd one (the port's packed route takes any) its
    unpacked kernel on the same heads."""
    rng = np.random.default_rng(h * l)
    x = _normal(rng, 2, l, 3 * h * d)
    q, k, v = (np.ascontiguousarray(t.numpy())
               for t in sa._unpack(torch.from_numpy(x), h))
    j = jx.jnp.asarray
    with jx.jax.default_matmul_precision("highest"):
        if h % 2 == 0:
            want = np.asarray(jx.sa.short_attention_qkv(j(x), h))
        else:
            want = np.asarray(sa._merge(torch.from_numpy(np.array(
                jx.sa.short_attention(j(q), j(k), j(v))))))
    emu, _, _ = _short_emulate(q, k, v, None)
    emu = sa._merge(torch.from_numpy(emu)).numpy()
    plain, _ = sa.short_attention_qkv_fwd(torch.from_numpy(x).bfloat16(), h)
    _check_short(emu, want, plain.float().numpy(), v)


# -- launcher signatures --------------------------------------------------------

_C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong}


def _declared(name: str):
    """The ctypes types of ``extern "C" int name(...)`` in ``csrc/*.cu``."""
    for src in sorted(_build.CSRC.glob("*.cu")):
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)",
                      src.read_text())
        if m:
            types = []
            for param in m.group(1).split(","):
                kind = " ".join(param.split()[:-1]).replace("const ", "")
                types.append(ctypes.c_void_p if kind.endswith("*")
                             else _C_TYPES[kind])
            return types
    raise AssertionError(f"{name} not found in {_build.CSRC}")


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_launcher_signatures_match_sources(name):
    assert _build._SIGNATURES[name] == _declared(name)


@pytest.mark.parametrize("name,n_ptr", [("flash_fwd_launch", 6),
                                        ("flash_bwd_dq_launch", 8),
                                        ("flash_bwd_dkv_launch", 9)])
def test_flash_bias_strides_are_64bit(name, n_ptr):
    """B, H, H_kv, Lq, Lk, D follow the pointers, then the bias strides
    (b, h, q): a batch stride times B past 2^31 elements must not wrap."""
    args = _build._SIGNATURES[name]
    assert args[n_ptr:n_ptr + 6] == [ctypes.c_int] * 6
    assert args[n_ptr + 6:n_ptr + 9] == [ctypes.c_longlong] * 3
