"""The tensor-core K8 and K9/K10's routes and plan
(``ops.quant_matmul.int8_route``, ``int4_route``, ``int8_tc_plan``), their
split-K workspace and the arithmetic of their B fragments, pinned on the
CPU.

The kernels themselves run only on the card (``tests/test_torch_quant.py``'s
``cuda`` cases hold them to their plain versions); what decides which
kernel a call takes, and how the tensor-core one tiles and splits it, is
Python and is held here: the routes by dtype, layout, mode, K, group size
and alignment, and a plan that fills an H100's 132 SMs at every Qwen3-0.6B
linear, the tied head and K10's shape, in whole k steps, with no split at
the head or at prefill. The B-fragment recipes (int8 widening, int4 fold,
stream and noscale) are emulated bit for bit in numpy on every byte."""

import numpy as np
import pytest
import torch

from vyomai_tpu_torch.ops import quant_matmul as tqm

H100_SMS = 132
# (K, N) of Qwen3-0.6B's linears (q, k/v, o, gate/up, down) and tied head
QWEN3_LINEARS = ((1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072),
                 (3072, 1024))
QWEN3_HEAD = (1024, 151936)


def _grid(m, k, n, plan):
    bm, bn, splits = plan
    return -(-m // bm) * -(-n // bn) * splits


@pytest.mark.parametrize("m", [16, 2048])
@pytest.mark.parametrize("k,n", QWEN3_LINEARS + (QWEN3_HEAD,))
def test_tc_plan_fills_the_card_in_whole_k_steps(m, k, n):
    plan = tqm.int8_tc_plan(m, k, n, H100_SMS)
    bm, bn, splits = plan
    assert (bm, bn) in tqm.TC_TILES
    assert (bm, bn) == ((16, 32) if m <= 16 else (64, 128))
    assert _grid(m, k, n, plan) >= H100_SMS
    # each split takes whole 64-deep steps and none is empty
    steps = -(-k // tqm.TC_K_STEP)
    per = -(-steps // splits)
    assert 1 <= splits <= steps and -(-steps // per) == splits
    if (k, n) == QWEN3_HEAD or m == 2048:
        assert splits == 1


@pytest.mark.parametrize("m,k,n", [(16, 1024, 1024), (1, 3072, 1024),
                                   (17, 1024, 1000), (7, 80, 64)])
def test_tc_plan_splits_are_the_fewest_that_fill(m, k, n):
    """One split fewer would leave the grid short of the SMs (unless every
    step is already its own split)."""
    plan = tqm.int8_tc_plan(m, k, n, H100_SMS)
    bm, bn, splits = plan
    tiles = -(-m // bm) * -(-n // bn)
    steps = -(-k // tqm.TC_K_STEP)
    if splits < steps:
        assert tiles * splits >= H100_SMS
    for fewer in range(1, splits):
        per = -(-steps // fewer)
        assert tiles * -(-steps // per) < H100_SMS


@pytest.mark.parametrize("m,k,n,want", [
    (100, 1024, 1000, (16, 32, 1)),      # 64-row tiles: 16 CTAs
    (17, 1024, 1000, (16, 32, 3)),
    (512, 1024, 3072, (64, 128, 1)),     # 64-row tiles: 192 CTAs
    (17, 1024, 151936, (64, 128, 1)),
])
def test_tc_plan_takes_64_row_tiles_only_where_they_fill(m, k, n, want):
    assert tqm.int8_tc_plan(m, k, n, H100_SMS) == want


def _nk(n, k, *, pad=0, offset=0):
    base = torch.zeros(n, k + pad + offset, dtype=torch.int8)
    return base[:, offset:offset + k]


@pytest.mark.parametrize("case,want", [
    ("bf16 nk aligned", "tc"),
    ("fp32 x", "cuda"),
    ("kn layout", "cuda"),
    ("K % 16 != 0", "cuda"),
    ("rows not 16-byte aligned", "cuda"),
    ("weight start not aligned", "cuda"),
    ("x start not aligned", "cuda"),
    ("k not contiguous", "cuda"),
])
def test_int8_route(case, want):
    m, k, n = 16, 1024, 96
    x = torch.zeros(m, k, dtype=torch.bfloat16)
    w, layout = _nk(n, k), "nk"
    if case == "fp32 x":
        x = x.float()
    elif case == "kn layout":
        w, layout = torch.zeros(k, n, dtype=torch.int8), "kn"
    elif case == "K % 16 != 0":
        x, w = torch.zeros(m, k - 8, dtype=torch.bfloat16), _nk(n, k - 8)
    elif case == "rows not 16-byte aligned":
        w = _nk(n, k, pad=8)
    elif case == "weight start not aligned":
        w = _nk(n, k, pad=15, offset=1)
    elif case == "x start not aligned":
        x = torch.zeros(m * k + 1, dtype=torch.bfloat16)[1:].view(m, k)
    elif case == "k not contiguous":
        w = torch.zeros(k, n, dtype=torch.int8).t()
    assert tqm.int8_route(x, w, layout) == want


def test_int8_to_bf16_conversion_is_exact():
    """The kernel's widening of a weight byte: offset to unsigned, set as
    the low mantissa bits of 2^23, subtract 2^23 + 128 in fp32, keep the
    top 16 bits as the bf16. Every int8 value comes back exactly."""
    b = np.arange(-128, 128, dtype=np.int32)
    u = (b & 0xFF) ^ 0x80
    f = (np.uint32(0x4B000000) | u.astype(np.uint32)).view(np.float32)
    f = f - np.float32(8388736.0)
    top = (f.view(np.uint32) >> 16).astype(np.uint16)
    back = (top.astype(np.uint32) << 16).view(np.float32)
    np.testing.assert_array_equal(back, b.astype(np.float32))


@pytest.mark.parametrize("m,k,n,wide,want", [
    (16, 1024, 3072, True, (16, 32, 2)),     # K9's main shape: 192 CTAs
    (8, 2048, 2048, False, (16, 32, 3)),     # K10's shape: 192 CTAs
    (2048, 1024, 3072, True, (64, 128, 1)),  # K9 fold at prefill
    (2048, 2048, 2048, False, (16, 32, 1)),  # K10 keeps the 16 x 32 tile
])
def test_int4_plan_at_the_int4_shapes(m, k, n, wide, want):
    plan = tqm.int8_tc_plan(m, k, n, H100_SMS, wide=wide)
    assert plan == want
    steps = -(-k // tqm.TC_K_STEP)
    per = -(-steps // plan[2])
    assert _grid(m, k, n, plan) >= H100_SMS and -(-steps // per) == plan[2]


@pytest.mark.parametrize("k,n", QWEN3_LINEARS)
def test_int4_plan_fills_the_card_at_every_decode_linear(k, n):
    plan = tqm.int8_tc_plan(16, k, n, H100_SMS, wide=True)
    assert plan[:2] == (16, 32) and _grid(16, k, n, plan) >= H100_SMS


def _nk4(n, k, *, pad=0, offset=0):
    base = torch.zeros(n, k // 2 + pad + offset, dtype=torch.int8)
    return base[:, offset:offset + k // 2]


@pytest.mark.parametrize("case,want", [
    ("bf16 nk aligned fold", "tc"),
    ("stream", "tc"),
    ("noscale", "tc"),
    ("split", "cuda"),
    ("fp32 x", "cuda"),
    ("kn layout", "cuda"),
    ("K % 16 != 0", "cuda"),
    ("gs % 16 != 0", "cuda"),
    ("rows not 16-byte aligned", "cuda"),
    ("weight start not aligned", "cuda"),
    ("x start not aligned", "cuda"),
    ("k not contiguous", "cuda"),
])
def test_int4_route(case, want):
    m, k, n, gs = 16, 1024, 96, 128
    x = torch.zeros(m, k, dtype=torch.bfloat16)
    w, layout, mode = _nk4(n, k), "nk", "fold"
    if case in ("stream", "noscale", "split"):
        mode = case
    elif case == "fp32 x":
        x = x.float()
    elif case == "kn layout":
        w, layout = torch.zeros(k // 2, n, dtype=torch.int8), "kn"
    elif case == "K % 16 != 0":
        x, w, gs = torch.zeros(m, k - 8, dtype=torch.bfloat16), \
            _nk4(n, k - 8), 8
    elif case == "gs % 16 != 0":
        gs = 8
    elif case == "rows not 16-byte aligned":
        w = _nk4(n, k, pad=8)
    elif case == "weight start not aligned":
        w = _nk4(n, k, pad=15, offset=1)
    elif case == "x start not aligned":
        x = torch.zeros(m * k + 1, dtype=torch.bfloat16)[1:].view(m, k)
    elif case == "k not contiguous":
        w = torch.zeros(k // 2, n, dtype=torch.int8).t()
    assert tqm.int4_route(x, w, layout, mode, gs) == want


def test_split_workspace_keeps_grown_buffers_and_splits_streams():
    """A workspace that grows keeps its old buffers alive (a captured CUDA
    graph may still address them), and two streams never share one."""
    dev = torch.device("cpu")
    saved = dict(tqm._WORKSPACE), list(tqm._RETIRED)
    try:
        ws1, cnt1 = tqm._split_workspace(dev, 101, 64, 8)
        assert (ws1.numel(), cnt1.numel()) == (64, 8)
        assert int(cnt1.abs().sum()) == 0
        again = tqm._split_workspace(dev, 101, 32, 4)   # fits: the same
        assert again[0] is ws1 and again[1] is cnt1
        ws2, cnt2 = tqm._split_workspace(dev, 101, 256, 16)
        assert ws2.numel() == 256 and cnt2.numel() == 16
        assert any(t is ws1 for t in tqm._RETIRED)
        assert any(t is cnt1 for t in tqm._RETIRED)
        other = tqm._split_workspace(dev, 202, 64, 8)
        assert other[0] is not ws2 and other[1] is not cnt2
        assert other[0].data_ptr() != ws2.data_ptr()
        assert tqm._split_workspace(dev, 101, 64, 8)[0] is ws2
    finally:
        tqm._WORKSPACE.clear()
        tqm._WORKSPACE.update(saved[0])
        tqm._RETIRED[:] = saved[1]


# -- the B fragments, emulated bit for bit ------------------------------------

def _f32(bits):
    return np.asarray(bits, np.uint32).view(np.float32)


def _bits(f):
    return np.asarray(f, np.float32).view(np.uint32)


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().astype(np.uint16)


def _nibbles_fp32(v):
    """The kernel's ``nibbles_to_bf16`` before the pack: each nibble of the
    byte, ^ 8, as the low mantissa bits of 2^23, minus 2^23 + 8 (fp32)."""
    u = (v.astype(np.uint32) & 0xFF) ^ 0x88
    lo = _f32(0x4B000000 | (u & 0xF)) - np.float32(8388616.0)
    hi = _f32(0x4B000000 | ((u >> 4) & 0xF)) - np.float32(8388616.0)
    return lo, hi


def test_int4_b_fragments_are_the_plain_versions_bits():
    """On all 256 bytes: noscale's nibbles are exact (their bf16 is the top
    half of the fp32), fold's are ``nibble * scale`` rounded to bf16 as
    ``int4_matmul_ref`` rounds it (fp32 product, RNE), and stream's
    duplicated bytes, widened by the int8 recipe, are each byte's int8
    value for both of its k."""
    v = np.arange(256, dtype=np.uint32)
    p8 = torch.from_numpy(v.astype(np.uint8).view(np.int8))
    lo_ref, hi_ref = tqm.unpack_int4(p8)
    lo, hi = _nibbles_fp32(v)
    np.testing.assert_array_equal(lo, lo_ref.numpy().astype(np.float32))
    np.testing.assert_array_equal(hi, hi_ref.numpy().astype(np.float32))
    # noscale: the top halves are the exact bf16 of the small integers
    for got, ref in ((lo, lo_ref), (hi, hi_ref)):
        top = (_bits(got) >> 16).astype(np.uint16)
        np.testing.assert_array_equal(
            top, _bf16_bits(ref.to(torch.bfloat16)))
    # fold: fp32 product, rounded to nearest even at bf16
    rng = np.random.default_rng(0)
    scales = np.concatenate([rng.uniform(1e-4, 0.05, 6),
                             [1.0, 0.0071428571, 3.3e-3]]).astype(np.float32)
    for s in scales:
        ref = (torch.stack([lo_ref, hi_ref]).to(torch.float32)
               * torch.tensor(s)).to(torch.bfloat16)
        prod = torch.from_numpy(np.stack([lo * s, hi * s]))
        np.testing.assert_array_equal(
            _bf16_bits(prod.to(torch.bfloat16)), _bf16_bits(ref))
    # stream: __byte_perm(w, 0, 0x1100) duplicates bytes 0 and 1 (0x3322:
    # 2 and 3); the int8 widening of the result gives (b0, b0), (b1, b1)
    words = rng.integers(0, 2 ** 32, 64, dtype=np.uint64).astype(np.uint32)
    for w in np.concatenate([words, v * 0x01010101]):   # + every byte
        b = [(int(w) >> (8 * i)) & 0xFF for i in range(4)]
        for sel in (0, 1):
            dup = [b[2 * sel], b[2 * sel], b[2 * sel + 1], b[2 * sel + 1]]
            u = np.array(dup, np.uint32) ^ 0x80
            f = _f32(0x4B000000 | u) - np.float32(8388736.0)
            want = np.array(dup, np.uint8).view(np.int8).astype(np.float32)
            np.testing.assert_array_equal(f, want)
            assert np.all(_bits(f) & 0xFFFF == 0)   # exact as bf16
