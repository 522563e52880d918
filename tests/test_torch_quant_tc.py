"""The tensor-core K8's route and plan (``ops.quant_matmul.int8_route``,
``int8_tc_plan``), pinned on the CPU.

The kernel itself runs only on the card (``tests/test_torch_quant.py``'s
``cuda`` cases hold it to its plain version); what decides which kernel a
call takes, and how the tensor-core one tiles and splits it, is Python and
is held here: the route by dtype, layout, K and alignment, and a plan that
fills an H100's 132 SMs at every Qwen3-0.6B linear and the tied head, in
whole k steps, with no split at the head or at prefill."""

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
