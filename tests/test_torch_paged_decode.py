"""Paged-decode attention in the PyTorch port (``ops.paged_decode``).

On the CPU the wrapper runs its plain version, held here against the JAX
package's Pallas kernel (interpret mode, as
``tests/test_paged_decode_kernel.py`` runs it) and against its XLA gather
fallback, at that test's shapes and fp32 bound (atol 2e-5). Dead lanes
(seq_len 0) are compared with the kernel only: the fallback gives them the
mean of V. The cases marked ``cuda`` run the hand-written kernel against
the plain version and skip without a card. JAX is loaded by the ``jx``
fixture, so the card's cases also run where JAX is not installed.

The card runs a split-KV pair: ``paged_attention_decode_split_ref`` is its
split-and-combine algebra in plain PyTorch, held here to the JAX kernel and
to the full plain version at the same bound, at partitions that cut lanes
at ``P - 1``, ``P`` and ``P + 1`` tokens, with one split, a dead lane,
``-1`` table entries and an oversized ``seq_len``; ``_decode_plan`` is held
to whole blocks, a grid that covers ``MAXB * BS`` and bounded sizes, and to
filling an H100's 132 SMs several times over at the serving shapes."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vyomai_tpu_torch.ops import paged_attention as tpa
from vyomai_tpu_torch.ops import paged_decode as tpd
from vyomai_tpu_torch.ops.paged_decode import (
    paged_attention_decode_ref, paged_attention_decode_split_ref,
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


SPLIT_CASES = {
    "cut_at_p_minus_1_p_p_plus_1": dict(ctx=(15, 16, 17), partition=16),
    "cut_at_one_block": dict(ctx=(7, 8, 9), partition=8),
    "one_split": dict(partition=MAXB * BS),
    "dead_lane": dict(ctx=(0, 20, 5), partition=8),
    "minus_one_entries": dict(ctx=(10, 3, 16), partition=8),
    "oversized_seq_len": dict(ctx=(MAXB * BS + 13, 9, MAXB * BS),
                              partition=16),
    "mha": dict(h=2, h_kv=2, partition=24),
}


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_ref_matches_pallas_kernel_and_plain(jx, name):
    kw = dict(SPLIT_CASES[name])
    part = kw.pop("partition")
    q, pool, bt, sl = _setup(seed=len(name) + 40, **kw)
    if name == "minus_one_entries":
        bt[:, 2:] = -1                  # only two live blocks per lane
    h_kv = kw.get("h_kv", H_KV)
    _, ref = _both(jx, q, pool, bt, sl, h_kv)
    args = tuple(map(torch.from_numpy, (q, pool, bt, sl)))
    got = paged_attention_decode_split_ref(*args, h_kv, partition=part)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    plain = paged_attention_decode_ref(*args, h_kv)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL, rtol=0)
    if name == "dead_lane":
        assert np.all(got[0].numpy() == 0.0)


H100_SMS = 132
PHASE2_LENS = (1, 16, 17, 100, 255, 256, 300, 511, 512, 513, 700, 999,
               1023, 1024, 0, 1500)
# (B, H_kv, BS, MAXB, seq_lens): chip_smoke's traced tick (ctx 500 + the
# 8-step horizon), its phase 2 ragged batch, and one lane at 1,024 tokens
SERVING_SHAPES = {
    "tick": (16, 8, 16, 64, (508,) * 16),
    "ragged": (16, 8, 16, 64, PHASE2_LENS),
    "one_lane": (1, 8, 16, 64, (1024,)),
}


def _plan_ok(b, h_kv, bs, maxb):
    part, splits = tpd._decode_plan(b, h_kv, bs, maxb)
    assert part % bs == 0 and part // bs <= tpd._MAX_TABLE
    assert splits * part >= maxb * bs > (splits - 1) * part or maxb == 0
    return part, splits


@pytest.mark.parametrize("name", sorted(SERVING_SHAPES))
def test_decode_plan_fills_the_card_at_the_serving_shapes(name):
    b, h_kv, bs, maxb, lens = SERVING_SHAPES[name]
    part, splits = _plan_ok(b, h_kv, bs, maxb)
    grid = b * h_kv * splits
    assert min(tpd._TARGET_CTAS, b * h_kv * maxb) // 2 <= grid
    assert grid <= tpd._TARGET_CTAS + b * h_kv
    live = h_kv * sum(-(-min(n, maxb * bs) // part) for n in lens)
    assert live >= 3 * H100_SMS, (part, splits, live)
    # the longest lane's work is cut: no CTA streams more than P tokens
    assert part <= 64


@pytest.mark.parametrize("b,h_kv,bs,maxb", [
    (16, 8, 16, 4096), (1, 1, 16, 100_000), (64, 8, 16, 64), (256, 8, 16, 8),
    (1, 8, 256, 1024), (3, 2, 8, 6), (2, 1, 16, 0)])
def test_decode_plan_bounds_the_grid(b, h_kv, bs, maxb):
    part, splits = _plan_ok(b, h_kv, bs, maxb)
    cap = -(-maxb // tpd._MAX_TABLE)
    assert 1 <= splits
    assert b * h_kv * splits <= max(tpd._TARGET_CTAS + b * h_kv,
                                    b * h_kv * cap)


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


def _split_case(cuda, dtype, d, group, shape, seed):
    """A float pool and lengths at the plan's partition edges: P - 1, P,
    P + 1, a dead lane, an oversized and a full lane, the rest random;
    lane 1's table is -1 past its live blocks."""
    b, h_kv, bs, maxb = shape
    part, _ = tpd._decode_plan(b, h_kv, bs, maxb)
    g = torch.Generator(device=cuda).manual_seed(seed)
    nb = 64
    q = torch.randn(b, h_kv * group, d, device=cuda, generator=g).to(dtype)
    pool = torch.randn(nb, 2, bs, h_kv * d, device=cuda,
                       generator=g).to(dtype)
    bt = torch.randint(0, nb, (b, maxb), device=cuda, generator=g).int()
    lens = _edge_lens(b, part, maxb * bs, seed)
    bt[1, -(-lens[1] // bs):] = -1
    sl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    return q, pool, bt, sl, h_kv


def _edge_lens(b, part, top, seed):
    edge = [min(part - 1, top), min(part, top), min(part + 1, top), 0,
            top + 13, top]
    rest = np.random.default_rng(seed).integers(0, top + 20, b).tolist()
    return (edge + rest)[:b]


# (B, H_kv, BS, MAXB): eight 16-token partitions, phase 2's plan (P = 64,
# S = 16), and one partition (the first kernel writes the output)
CARD_SHAPES = {"p16": (6, 2, 16, 8), "p64": (16, 8, 16, 64),
               "one_split": (256, 8, 16, 8)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_split_pair_matches_plain_on_card(cuda, d, dtype, group, shape):
    q, pool, bt, sl, h_kv = _split_case(cuda, dtype, d, group,
                                        CARD_SHAPES[shape], seed=group + d)
    before = paged_decode.launches
    out = paged_decode(q, pool, bt, sl, h_kv)
    torch.cuda.synchronize()
    assert paged_decode.launches == before + 1
    ref = paged_attention_decode_ref(q, pool, bt, sl, h_kv)
    atol = 1e-4 if dtype == torch.float32 else bf16_atol(ref)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    assert torch.all(out[3] == 0)


@pytest.mark.cuda
def test_split_pair_gives_the_same_bits_twice_on_card(cuda):
    q, pool, bt, sl, h_kv = _split_case(cuda, torch.bfloat16, 128, 2,
                                        CARD_SHAPES["p64"], seed=5)
    outs = [paged_decode(q, pool, bt, sl, h_kv) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
def test_split_pair_graph_replays_after_a_larger_call_on_card(cuda):
    """A CUDA graph captured over ``paged_decode`` (workspace from the
    caching allocator, plan from shapes) replays to the eager output after
    a larger call on the capture stream."""
    q, pool, bt, sl, h_kv = _split_case(cuda, torch.bfloat16, 128, 2,
                                        CARD_SHAPES["p64"], seed=6)
    want = paged_decode(q, pool, bt, sl, h_kv)
    big = _split_case(cuda, torch.bfloat16, 128, 2, (64, 8, 16, 128),
                      seed=7)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):   # warm up on the capture stream
        paged_decode(q, pool, bt, sl, h_kv)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        got = paged_decode(q, pool, bt, sl, h_kv)
    with torch.cuda.stream(stream):
        big_out = paged_decode(*big)
    torch.cuda.synchronize()
    got.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    big_ref = paged_attention_decode_ref(*big)
    torch.testing.assert_close(big_out.float(), big_ref.float(),
                               atol=bf16_atol(big_ref), rtol=0)
