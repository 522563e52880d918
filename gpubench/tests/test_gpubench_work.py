"""``work.py``'s FLOP and byte counts against hand counts at small
shapes."""

import pytest

from gpubench import work

CFG = {"hidden_size": 8, "intermediate_size": 16, "num_attention_heads": 4,
       "num_key_value_heads": 2, "head_dim": 2, "vocab_size": 10,
       "num_hidden_layers": 3}


def test_linears_per_token():
    # q 8->8, k 8->4, v 8->4, o 8->8, gate/up 8->16, down 16->8; head 8->10
    per_layer = 64 + 32 + 32 + 64 + 128 + 128 + 128
    assert sum(n * k for n, k in work.linears(CFG)) == 3 * per_layer + 80


def test_token_flops():
    mats = 3 * 576 + 80
    assert work.token_flops(CFG, 5) == 2 * mats + 4 * 3 * 4 * 2 * 5


def test_prompt_flops_is_the_sum_of_its_tokens():
    want = sum(work.token_flops(CFG, p + 1) for p in range(2, 7))
    assert work.prompt_flops(CFG, 2, 7) == pytest.approx(want)


def test_paged_decode_bytes_bf16_and_int8():
    f, b = work.paged_decode(CFG, 5, "bfloat16", 4)
    # a layer: q + out 2*4*2*2 = 32, K and V 2*5*(2*2*2) = 80, 2 blocks of
    # table 8, the length 4
    assert b == 3 * (32 + 80 + 8 + 4)
    assert f == 4 * 4 * 2 * 5 * 3
    _, b8 = work.paged_decode(CFG, 5, "int8", 4)
    assert b8 == 3 * (32 + 2 * 5 * (4 + 4) + 8 + 4)


def test_weight_only_step():
    f, b = work.weight_only_step(CFG, 2, 8)
    mats = [(n, k) for n, k in work.linears(CFG)]
    assert f == sum(2 * 2 * n * k for n, k in mats)
    assert b == sum(n * k + 4 * n + 2 * (2 * k + 2 * n) for n, k in mats)


def test_flash_prefill_and_step():
    f, b = work.flash_prefill(1, 2, 1, 3, 4)
    assert f == 4 * 2 * 4 * (1 + 2 + 3)
    assert b == 4 * 2 * (2 * 2 * 3 + 2 * 1 * 3)
    f, b = work.flash_step(2, 2, 1, 7, 4)
    assert f == 4 * 2 * 2 * 4 * 7
    assert b == 2 * 4 * 2 * (2 * 2 + 2 * 7)


def test_bound_takes_the_larger_side():
    assert work.bound_s(989e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert work.bound_s(1e12, 3.35e12) == pytest.approx(1.0)
