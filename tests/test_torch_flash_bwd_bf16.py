"""The bf16 arithmetic of the tensor-core K2/K3 flash backward:
``flash_bwd_dq_kernel_tc`` and ``flash_bwd_dkv_kernel_tc``
(``vyomai_tpu_torch/csrc/flash_bwd.cu`` on ``csrc/attn_bwd_tc.cuh``).

On the card those kernels read bf16 q/k/v/dO, take fp32 S = q.k^T and
dP = dO.v^T from the tensor cores, rebuild P = 2^((S / sqrt(D) + causal +
bias - lse) log2 e) from the forward's lse, form dS = P (dP - delta) /
sqrt(D) in fp32, round P and dS to bf16 as the A operands of their
products and accumulate in fp32: dQ = dS.k over the 64-key tiles up to the
causal edge, dK = dS^T.q and dV = P^T.dO over the GQA group's q heads and,
for each, the 64-row q tiles from the first that sees the keys.
``emulate_flash_bwd`` below does the same on the CPU. With bf16-valued
inputs made from numpy seeds at small sizes (H 4 with H_kv 1, 2 and 4; L
64, 100 and 130; D 64 and 128) it is held against the JAX package's
``_bwd`` in interpret mode and ``jax.vjp`` of its ``flash_attention_bias``
(ragged lengths, causal rows before every key), and against the port's
plain version on bf16 tensors, under the card's bound
``chip_smoke.grad_atol``:

    atol = (2^-7 + 1e-4) max|ref| + 1e-6 + rounding,

one bf16 ulp of the gradient after its cast plus fp32 summation order,
plus ``chip_smoke.flash_bwd_rounding``: rounding P and dS to bf16 (unit
roundoff 2^-8) moves dV by at most 2^-8 max(sum_group P^T |dO|), dK by
2^-8 max(sum_group |dS|^T |q|) and dQ by 2^-8 max(|dS| |k|). Before the
cast the emulation stays within the rounding and fp32 terms alone. A row
that sees no key gets a gradient of exactly 0. The ``cuda`` cases hold the
kernels to the plain version under the same bound at the decoder's
training shape and edges, and skip without a card."""

import ctypes
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import flash_bwd_issued_flops, flash_bwd_rounding, grad_atol
from vyomai_tpu_torch.core.masks import NEG_INF
from vyomai_tpu_torch.ops import _build
from vyomai_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

LOG2E = 1.4426950408889634
TILE = 64   # rows of a q tile, keys of a K/V tile
NAMES = ("dq", "dk", "dv")


@pytest.fixture(scope="module")
def jx():
    """The JAX package's flash attention, in interpret mode."""
    jax = pytest.importorskip("jax")
    from vyomai_tpu.ops import flash_attention as jfa
    jfa.set_interpret(True)
    yield SimpleNamespace(jax=jax, jnp=jax.numpy, fa=jfa)
    jfa.set_interpret(False)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16, held in fp32."""
    return x.bfloat16().float()


def emulate_flash_bwd(q, k, v, bias, do, lse, delta, *, causal: bool,
                      q_offset: int):
    """The tensor-core K2/K3's arithmetic on fp32 tensors holding bf16
    values (q, dO ``[B, H, Lq, D]``, k, v ``[B, H_kv, Lk, D]``), with the
    forward's lse and ``delta = rowsum(dO * O)``: fp32 scores with the
    causal mask and the bias added, P = 2^((x - lse) log2 e), dS in fp32,
    P and dS rounded to bf16 before their products, fp32 sums tile by
    tile in the kernels' order, causal tiles skipped. Returns (dq, dk, dv)
    before their cast."""
    b, h, lq, d = q.shape
    h_kv, lk = k.shape[1], k.shape[2]
    group = h // h_kv
    scale = torch.tensor(1.0 / np.sqrt(d), dtype=torch.float32)
    kk = k.repeat_interleave(group, dim=1)
    x = torch.einsum("bhqd,bhkd->bhqk", q, kk) * scale
    if causal:
        rows = q_offset + torch.arange(lq)[:, None]
        x = x + torch.where(torch.arange(lk)[None] > rows, NEG_INF, 0.0)
    if bias is not None:
        x = x + bias
    # (x - lse) first: x * log2e - lse * log2e overflows finfo.min
    p = torch.exp2((x - lse[..., None]) * LOG2E)
    dp = torch.einsum("bhqd,bhkd->bhqk", do,
                      v.repeat_interleave(group, dim=1))
    ds = p * (dp - delta[..., None]) * scale
    pb, dsb = _bf16(p), _bf16(ds)
    dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
    nk = -(-lk // TILE)
    for q0 in range(0, lq, TILE):   # K2: a q tile's K/V tiles in order
        qs = slice(q0, q0 + TILE)
        last = q_offset + q0 + TILE - 1
        n = nk if not causal else (0 if last < 0 else min(last // TILE + 1,
                                                          nk))
        for k0 in range(0, n * TILE, TILE):
            ks = slice(k0, k0 + TILE)
            dq[:, :, qs] += torch.einsum("bhqk,bhkd->bhqd",
                                         dsb[:, :, qs, ks], kk[:, :, ks])
    nq = -(-lq // TILE)
    for k0 in range(0, lk, TILE):   # K3: (group head, q tile) in order
        ks = slice(k0, k0 + TILE)
        first = 0 if not causal else min(max(k0 - q_offset, 0) // TILE, nq)
        for hq in range(h):
            hk = hq // group
            for q0 in range(first * TILE, lq, TILE):
                qs = slice(q0, q0 + TILE)
                dk[:, hk, ks] += torch.einsum(
                    "bqk,bqd->bkd", dsb[:, hq, qs, ks], q[:, hq, qs])
                dv[:, hk, ks] += torch.einsum(
                    "bqk,bqd->bkd", pb[:, hq, qs, ks], do[:, hq, qs])
    return dq, dk, dv


def _bias(rng, kind, b, lq, lk):
    """None; "pad": the last lk // 4 keys of batch row 1 padded (0
    elsewhere), ``[B, 1, 1, Lk]``; "full": random with 30 % masked and
    row 3 wholly masked, ``[B, 1, Lq, Lk]``."""
    if kind is None:
        return None
    if kind == "pad":
        bias = torch.zeros(b, 1, 1, lk)
        bias[1, ..., lk - lk // 4:] = NEG_INF
        return bias
    bias = rng.standard_normal((b, 1, lq, lk)).astype(np.float32) * 0.5
    bias[rng.random(bias.shape) < 0.3] = NEG_INF
    bias[:, :, 3] = NEG_INF
    return torch.from_numpy(bias)


def _inputs(seed, h_kv, lq, lk, d, kind, causal, q_offset=None, b=2, h=4):
    """bf16-valued q, k, v, dO, the bias, the plain fp32 forward's lse and
    delta, and the keyword arguments (causal, q_offset)."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return _bf16(torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)))

    q, do = normal(b, h, lq, d), normal(b, h, lq, d)
    k, v = normal(b, h_kv, lk, d), normal(b, h_kv, lk, d)
    bias = _bias(rng, kind, b, lq, lk)
    kw = dict(causal=causal, q_offset=lk - lq if q_offset is None
              else q_offset)
    out, lse = fa.flash_attention_fwd_ref(q, k, v, bias, **kw)
    return (q, k, v, bias, do, lse, fa._delta(out, do)), kw


def _check(emu, want, rounding):
    """``emu`` against fp32 ``want``: before the cast within the rounding
    and fp32 terms, after it within the card's bf16 bound."""
    for name, e, w in zip(NAMES, emu, want):
        w = torch.from_numpy(np.array(w, dtype=np.float32))
        err = float((e - w).abs().max())
        assert err <= grad_atol(w, False, rounding[name]), (name, err)
        err = float((_bf16(e) - w).abs().max())
        assert err <= grad_atol(w, True, rounding[name]), (name, err)


def _check_plain(emu, args, kw):
    """``emu`` cast to bf16 against the port's plain version on bf16
    tensors: the bound that ``chip_smoke`` holds the card to."""
    q, k, v, bias, do, lse, delta = args
    bq, bk, bv, bdo = (x.bfloat16() for x in (q, k, v, do))
    plain = (fa.flash_bwd_dq_ref(bq, bk, bv, bias, bdo, lse, delta, **kw),
             *fa.flash_bwd_dkv_ref(bq, bk, bv, bias, bdo, lse, delta, **kw))
    rounding = flash_bwd_rounding(fa, bq, bk, bv, bias, bdo, lse, delta, **kw)
    for name, e, w in zip(NAMES, emu, plain):
        assert w.dtype == torch.bfloat16
        err = float((_bf16(e) - w.float()).abs().max())
        assert err <= grad_atol(w, True, rounding[name]), (name, err)


def _dead_rows(shape, bias, kw, lq, lk):
    """The rows that see no key (fully masked, or before every key),
    ``[B, H, Lq]``."""
    ok = torch.ones(lq, lk, dtype=torch.bool)
    if kw["causal"]:
        rows = kw["q_offset"] + torch.arange(lq)[:, None]
        ok = torch.arange(lk)[None] <= rows
    if bias is not None:
        ok = ok & (bias > -1e30)
    return ~ok.any(dim=-1).expand(shape)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h_kv", [1, 2, 4])
def test_emulation_matches_pallas_bwd(jx, h_kv, d):
    """Causal with a key-pad bias, L=64, H=4: the JAX package's ``_bwd``
    (its Pallas K2/K3) in interpret mode, fp32 from the same bf16
    values."""
    args, kw = _inputs(10 * h_kv + d, h_kv, 64, 64, d, "pad", True)
    q, k, v, bias, do, _, _ = args
    j = jx.jnp.asarray
    jq, jk, jv, jdo, jb = (j(x.numpy()) for x in (q, k, v, do, bias))
    with jx.jax.default_matmul_precision("highest"):
        jout, jlse = jx.fa._fwd(jq, jk, jv, jb, True, kw["q_offset"],
                                block_q=16, block_k=16)
        want = jx.fa._bwd(jq, jk, jv, jb, True, kw["q_offset"], jout, jlse,
                          jdo, block_q=16, block_k=16)
    emu = emulate_flash_bwd(*args, **kw)
    _check(emu, want, flash_bwd_rounding(fa, *args, **kw))
    _check_plain(emu, args, kw)


VJP_CASES = {
    # name: (h_kv, lq, lk, d, bias kind, causal)
    "causal_pad_L100_g4": (1, 100, 100, 64, "pad", True),
    "causal_pad_L130_g2_d128": (2, 130, 130, 128, "pad", True),
    "causal_pad_L130_g1": (4, 130, 130, 64, "pad", True),
    "full_masked_L100_g2_d128": (2, 100, 100, 128, "full", False),
    "full_masked_L130_g4": (1, 130, 130, 64, "full", False),
    "ragged_q37_k100_g2": (2, 37, 100, 64, None, True),
    "ragged_q37_k100_g4_d128_pad": (1, 37, 100, 128, "pad", True),
    "before_keys_q130_k64_g2": (2, 130, 64, 64, None, True),
    "before_keys_q100_k64_g1_d128": (4, 100, 64, 128, "pad", True),
}


@pytest.mark.parametrize("name", sorted(VJP_CASES))
def test_emulation_matches_jax_vjp(jx, name):
    """Ragged lengths (queries end-aligned to the keys: q_offset = Lk - Lq,
    63 at Lq 37 / Lk 100, negative at Lq > Lk) and fully masked rows:
    ``jax.vjp`` of the JAX package's ``flash_attention_bias``, which pads
    to its block multiple around its Pallas K1-K3."""
    h_kv, lq, lk, d, kind, causal = VJP_CASES[name]
    args, kw = _inputs(len(name) + lq + lk, h_kv, lq, lk, d, kind, causal)
    q, k, v, bias, do, _, _ = args
    j = jx.jnp.asarray
    jb = None if bias is None else j(bias.numpy())

    def f(q_, k_, v_):
        return jx.fa.flash_attention_bias(q_, k_, v_, jb, causal=causal)

    with jx.jax.default_matmul_precision("highest"):
        _, vjp = jx.jax.vjp(f, *(j(x.numpy()) for x in (q, k, v)))
        want = vjp(j(do.numpy()))
    emu = emulate_flash_bwd(*args, **kw)
    _check(emu, want, flash_bwd_rounding(fa, *args, **kw))
    _check_plain(emu, args, kw)
    dead = _dead_rows(q.shape[:3], bias, kw, lq, lk)
    assert bool(dead.any()) == (kind == "full" or lq > lk)
    assert torch.all(emu[0][dead] == 0)
    assert np.all(np.asarray(want[0])[dead.numpy()] == 0)


def test_rounding_term_is_what_the_bound_adds():
    """Without its bf16 rounding of P and dS the emulation is the plain
    arithmetic (within fp32 order), and the rounding moves it by no more
    than ``flash_bwd_rounding``, which is not vacuous: it exceeds the fp32
    term."""
    args, kw = _inputs(11, 2, 100, 100, 64, "pad", True)
    want = (fa.flash_bwd_dq_ref(*args, **kw),
            *fa.flash_bwd_dkv_ref(*args, **kw))
    emu = emulate_flash_bwd(*args, **kw)
    rounding = flash_bwd_rounding(fa, *args, **kw)
    for name, e, w in zip(NAMES, emu, want):
        moved = float((e - w).abs().max())
        assert moved <= rounding[name] + 1e-4 * float(w.abs().max()) + 1e-6
        assert rounding[name] > 1e-4 * float(w.abs().max())


def test_group_rounding_sums_the_group():
    """dK's and dV's rounding terms sum over the q heads of a kv head's
    group: with every q head equal, group 4 reads 4x group 1's."""
    args, kw = _inputs(12, 4, 64, 64, 64, None, True, h=4)
    q, k, v, bias, do, lse, delta = args
    one = flash_bwd_rounding(fa, q[:, :1], k[:, :1], v[:, :1], None,
                             do[:, :1], lse[:, :1], delta[:, :1], **kw)
    rep = [x[:, :1].expand(-1, 4, -1, -1).contiguous() for x in (q, do)]
    four = flash_bwd_rounding(fa, rep[0], k[:, :1], v[:, :1], None, rep[1],
                              lse[:, :1].expand(-1, 4, -1).contiguous(),
                              delta[:, :1].expand(-1, 4, -1).contiguous(),
                              **kw)
    assert four["dq"] == pytest.approx(one["dq"], rel=1e-6)
    for name in ("dk", "dv"):
        assert four[name] == pytest.approx(4 * one[name], rel=1e-5)


def test_issued_flops_at_the_decoder_shape():
    """B=4, H=16, L=1024, D=64, causal: 120 whole 64x64 tiles and 16
    diagonal ones a (batch, head). K2's warps stop at their rows' edge in
    32-key steps (32, 32, 64, 64 keys of a diagonal tile for warps 0-3),
    K3's skip the 32-row steps before their keys' edge (64, 64, 32, 32
    q rows); without causal every tile is whole."""
    bh, diag = 4 * 16, 16
    k2 = 6 * 64 * bh * (120 * 4096 + diag * 16 * (32 + 32 + 64 + 64))
    k3 = 8 * 64 * bh * (120 * 4096 + diag * 16 * (64 + 64 + 32 + 32))
    assert flash_bwd_issued_flops(4, 16, 1024, 1024, 64, True) == (k2, k3)
    full = flash_bwd_issued_flops(4, 16, 1024, 1024, 64, False)
    assert full == (6 * 64 * bh * 1024 ** 2, 8 * 64 * bh * 1024 ** 2)
    # ragged: 37 rows in 3 live warps (48 rows) against 1000 keys in
    # 32-steps (1024); 1000 keys in 63 live warps (1008) against 37 rows
    # in 32-steps (64)
    assert flash_bwd_issued_flops(1, 1, 37, 1000, 64, False) == (
        6 * 64 * 48 * 1024, 8 * 64 * 1008 * 64)


_C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong}


@pytest.mark.parametrize("name", ["flash_bwd_dq_launch",
                                  "flash_bwd_dkv_launch"])
def test_launch_signature_matches_source(name):
    """The ctypes types ``_build`` declares for the launchers match their
    C parameters, the dtype flag (which picks the tensor-core or the
    CUDA-core kernels) an int just before the stream."""
    src = (_build.CSRC / "flash_bwd.cu").read_text()
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)',
                       src).group(1).split(",")
    types = []
    for param in params:
        kind = " ".join(param.split()[:-1]).replace("const ", "")
        types.append(ctypes.c_void_p if kind.endswith("*")
                     else _C_TYPES[kind])
    assert _build._SIGNATURES[name] == types
    assert params[-2].split()[-1] == "is_bf16" and types[-2] == ctypes.c_int


def test_unaligned_bias_is_padded_for_the_tensor_cores():
    """A bias whose rows are not 16-byte aligned (Lk = 1001) reaches the
    bf16 kernels as a padded copy with the same values; fp32 reads it in
    place, and an aligned one is not copied."""
    bias = torch.randn(2, 1, 5, 1001)
    q = torch.empty(2, 4, 5, 64, dtype=torch.bfloat16)
    got, strides = fa._kernel_bias(q, bias)
    assert torch.equal(got, bias) and all(s % 4 == 0 for s in strides)
    assert got.data_ptr() % 16 == 0 and strides[2] == 1004
    assert fa._kernel_bias(q.float(), bias)[0] is bias
    aligned = torch.randn(2, 1, 1, 1024)
    got, strides = fa._kernel_bias(q, aligned)
    assert got is aligned and strides == (1024, 0, 0)


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("h_kv,lq,lk,d,rows", [
    (4, 1024, 1024, 64, 1),     # the decoder's training shape
    (16, 1024, 1024, 64, 1),    # group 1
    (2, 1024, 1024, 64, 1),     # group 8
    (8, 512, 512, 128, 512),    # a full bias with a fully masked row
    (4, 300, 200, 64, 0),       # causal rows before every key
    (4, 1001, 1001, 128, 1)])   # bias rows not 16-byte aligned
def test_tensor_core_k2_k3_match_plain_on_card(cuda, h_kv, lq, lk, d, rows):
    """B=4, H=16, bf16: the kernels against the plain version on the same
    inputs, lse and delta, under ``grad_atol`` with the rounding term; rows
    that see no key get exactly 0."""
    g = torch.Generator(device=cuda).manual_seed(lq + h_kv)
    b, h = 4, 16
    q, do = (torch.randn(b, h, lq, d, device=cuda, generator=g).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(b, h_kv, lk, d, device=cuda, generator=g).bfloat16()
            for _ in range(2))
    causal = rows <= 1
    bias = None
    if rows:
        bias = torch.zeros(b, 1, rows, lk, device=cuda)
        if rows > 1:
            bias = torch.randn(b, 1, rows, lk, device=cuda, generator=g)
            bias[bias > 1.0] = NEG_INF
            bias[:, :, 5] = NEG_INF
    kw = dict(causal=causal, q_offset=lk - lq)
    out, lse = fa.flash_attention_fwd(q, k, v, bias, **kw)
    delta = fa._delta(out, do)
    before = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    got = (fa.flash_bwd_dq(q, k, v, bias, do, lse, delta, **kw),
           *fa.flash_bwd_dkv(q, k, v, bias, do, lse, delta, **kw))
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    want = (fa.flash_bwd_dq_ref(q, k, v, bias, do, lse, delta, **kw),
            *fa.flash_bwd_dkv_ref(q, k, v, bias, do, lse, delta, **kw))
    rounding = chip_smoke.flash_bwd_rounding(fa, q, k, v, bias, do, lse,
                                             delta, **kw)
    for name, x, w in zip(NAMES, got, want):
        assert bool(torch.isfinite(x).all()), name
        err = float((x.float() - w.float()).abs().max())
        assert err <= grad_atol(w, True, rounding[name]), (name, err)
    ok = chip_smoke.live_mask(torch, bias, lq, lk, causal, lk - lq)
    dead = ~ok.any(dim=-1).expand(b, h, lq)
    assert bool(dead.any()) == (rows > 1 or lq > lk)
    assert torch.all(got[0][dead] == 0)
