"""The int8 and int4 paged KV pools in the PyTorch port
(``ops.paged_attention``, ``ops.paged_decode``) against the JAX package.

Row quantizers and int4 packers must be byte-identical to JAX's on the same
fp32 input (numpy, from a seed); ``write_kv`` / ``gather_kv`` with their
scale sidecars must leave the same bytes and scales, dead rows included,
and no dead row may overwrite a live row's scale. The plain quantized
paged decode is held to ``paged_attention_decode_pallas`` in interpret mode
and to the XLA gather fallback at ``tests/test_paged_decode_kernel.py``'s
fp32 bound (atol 2e-5); dead lanes (seq_len 0) are compared with the
kernel only, since the fallback gives them the mean of V. The cases marked
``cuda`` run the hand-written kernel's int8/int4 variants against the
plain version and skip without a card; JAX is loaded by the ``jx``
fixture. ``paged_attention_decode_split_ref``, the card's split-and-combine
algebra, is held to the JAX kernel and to the full plain version for both
pools at the partition edges, with one split, a dead lane, ``-1`` entries
and an oversized ``seq_len``."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vyomai_tpu_torch.ops import paged_attention as tpa
from vyomai_tpu_torch.ops import paged_decode as tpd
from vyomai_tpu_torch.ops.paged_decode import (
    paged_attention_decode_ref, paged_attention_decode_split_ref,
    paged_decode, paged_decode_int4, paged_decode_int8)

torch.set_num_threads(1)

ATOL = 2e-5   # tests/test_paged_decode_kernel.py fp32 bound
B, H, H_KV, D, BS, MAXB, NB = 3, 8, 4, 64, 8, 6, 32
W = H_KV * D


@pytest.fixture(scope="module")
def jx():
    """The JAX pool ops, its decode kernel (interpret mode) and fallback."""
    jnp = pytest.importorskip("jax.numpy")
    from vyomai_tpu.ops import paged_attention as jpa
    from vyomai_tpu.ops import paged_decode_pallas as pdp
    pdp.set_interpret(True)
    yield SimpleNamespace(jnp=jnp, pa=jpa, pdp=pdp)
    pdp.set_interpret(False)


def _t(x):
    return torch.from_numpy(np.array(x))   # own, writable copy


def _rows(seed, t=13, width=W):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, width)) * np.exp(rng.standard_normal((t, 1)))
    x[2] = 0.0                                       # a zero row: the eps
    return x.astype(np.float32)


# -- quantizers and packers: byte-identical ----------------------------------------

def test_quantize_rows_byte_identical(jx):
    x = _rows(0)
    jq, js = jx.pa.quantize_rows(jx.jnp.asarray(x))
    q, s = tpa.quantize_rows(_t(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[2] == np.float32(1e-8)              # the eps floor


@pytest.mark.parametrize("h_kv", [1, 2, 4])
def test_pack_unpack_int4_rows_byte_identical(jx, h_kv):
    q4 = np.random.default_rng(h_kv).integers(-8, 8, size=(11, W))
    jp = np.asarray(jx.pa.pack_int4_rows(jx.jnp.asarray(q4, jx.jnp.int32),
                                         h_kv))
    p = tpa.pack_int4_rows(_t(q4), h_kv)
    np.testing.assert_array_equal(p.numpy(), jp)
    back = tpa.unpack_int4_rows(p, h_kv)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jx.pa.unpack_int4_rows(jx.jnp.asarray(jp),
                                                        h_kv)))
    np.testing.assert_array_equal(back.numpy(), q4)


def test_quantize_rows_int4_byte_identical(jx):
    x = _rows(1)
    jp, js = jx.pa.quantize_rows_int4(jx.jnp.asarray(x), H_KV)
    p, s = tpa.quantize_rows_int4(_t(x), H_KV)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


# -- write_kv / gather_kv with scales -------------------------------------------------

def _pools(kind):
    width = W // 2 if kind == "int4" else W
    pool = np.zeros((NB, 2, BS, width), np.int8)
    shape = (NB, 2, H_KV, BS) if kind == "int4" else (NB, 2, BS)
    return pool, np.ones(shape, np.float32)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_write_gather_kv_match_jax(jx, kind):
    rng = np.random.default_rng(2)
    t = 9
    k = rng.standard_normal((t, H_KV, D)).astype(np.float32)
    v = rng.standard_normal((t, H_KV, D)).astype(np.float32)
    # row 2 and row 5 are dead; row 5 aims at row 1's slot (5, 3)
    blocks = np.array([0, 5, -1, 2, 2, -1, 3, 1, 4], np.int32)
    offs = np.array([0, 3, 1, 0, 1, 3, 3, 2, 1], np.int32)
    pool, sc = _pools(kind)
    jpool, jsc = jx.pa.write_kv(jx.jnp.asarray(pool), jx.jnp.asarray(k),
                                jx.jnp.asarray(v), jx.jnp.asarray(blocks),
                                jx.jnp.asarray(offs),
                                scales=jx.jnp.asarray(sc))
    tp, ts = _t(pool), _t(sc)
    tpa.write_kv(tp, _t(k), _t(v), _t(blocks), _t(offs), scales=ts)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jpool))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(jsc))
    tables = np.array([[5, 0, 3], [2, 2, 1]], np.int32)
    gk, gv = tpa.gather_kv(tp, _t(tables).long(), H_KV, ts)
    for lane in range(2):
        jk, jv = jx.pa.gather_kv(jpool, jx.jnp.asarray(tables[lane]), H_KV,
                                 jsc)
        np.testing.assert_array_equal(gk[lane].numpy(), np.asarray(jk))
        np.testing.assert_array_equal(gv[lane].numpy(), np.asarray(jv))


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("dead_first", [False, True])
def test_dead_row_never_overwrites_a_live_scale(kind, dead_first):
    """A dead row aimed at a live row's slot leaves that row's quantized
    bytes AND its scale as the live row wrote them."""
    rows = [np.full((H_KV, D), 21.0, np.float32),
            np.full((H_KV, D), -0.5, np.float32)]
    blocks = [3, -1]
    if dead_first:
        rows, blocks = rows[::-1], blocks[::-1]
    k = _t(np.stack(rows))
    pool, sc = (_t(x) for x in _pools(kind))
    tpa.write_kv(pool, k, k, _t(np.array(blocks)), _t(np.array([1, 1])),
                 scales=sc)
    if kind == "int8":
        assert torch.all(sc[3, :, 1] == np.float32(21.0) / np.float32(127))
        assert torch.all(pool[3, :, 1] == 127)
    else:
        assert torch.all(sc[3, :, :, 1] == 3.0)      # 21 / 7
        assert torch.all(tpa.unpack_int4_rows(pool[3, :, 1], H_KV) == 7)
    assert int((sc != 1.0).sum()) == (2 if kind == "int8" else 2 * H_KV)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_all_dead_rows_leave_pool_and_scales_unchanged(kind):
    rng = np.random.default_rng(4)
    pool, sc = _pools(kind)
    pool = rng.integers(-100, 100, pool.shape).astype(np.int8)
    sc = rng.random(sc.shape).astype(np.float32)
    tp, ts = _t(pool), _t(sc)
    k = _t(rng.standard_normal((3, H_KV, D)).astype(np.float32))
    tpa.write_kv(tp, k, k, _t(np.array([-1, -1, -1])),
                 _t(np.array([1, 0, 1])), scales=ts)
    np.testing.assert_array_equal(tp.numpy(), pool)
    np.testing.assert_array_equal(ts.numpy(), sc)


# -- quantized paged decode ------------------------------------------------------------

def _setup(kind, seed=0, h=H, h_kv=H_KV, ctx=(17, 33, 48)):
    """q, and a quantized pool written through write_kv from fp rows."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, h, D)).astype(np.float32)
    pool_f = rng.standard_normal((NB, 2, BS, h_kv * D)).astype(np.float32)
    width = h_kv * D // (2 if kind == "int4" else 1)
    pool = torch.zeros((NB, 2, BS, width), dtype=torch.int8)
    sc = torch.ones((NB, 2, h_kv, BS) if kind == "int4" else (NB, 2, BS))
    rows = _t(pool_f)
    blocks = torch.arange(NB).repeat_interleave(BS)
    offs = torch.arange(BS).repeat(NB)
    tpa.write_kv(pool, rows[:, 0].reshape(-1, h_kv, D),
                 rows[:, 1].reshape(-1, h_kv, D), blocks, offs, scales=sc)
    bt = rng.permutation(NB)[:B * MAXB].reshape(B, MAXB).astype(np.int32)
    return (q, pool.numpy(), bt, np.asarray(ctx, np.int32), sc.numpy())


CASES = {
    "gqa": dict(),
    "mha": dict(h=4, h_kv=4),
    "partial_blocks": dict(ctx=(1, 9, 47)),
    "oversized_seq_len": dict(ctx=(MAXB * BS + 13, 9, MAXB * BS)),
    "dead_lane": dict(ctx=(0, 20, 5)),
}


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_kernel(jx, kind, name):
    kw = CASES[name]
    q, pool, bt, sl, sc = _setup(kind, seed=len(name), **kw)
    h_kv = kw.get("h_kv", H_KV)
    ref = np.asarray(jx.pdp.paged_attention_decode_pallas(
        *map(jx.jnp.asarray, (q, pool, bt, sl)), h_kv, jx.jnp.asarray(sc)))
    fn = paged_decode_int4 if kind == "int4" else paged_decode_int8
    got = fn(*map(_t, (q, pool, bt, sl)), h_kv, _t(sc)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    if name == "dead_lane":
        assert np.all(got[0] == 0.0)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_plain_matches_xla_fallback_and_table_minus_one(jx, kind):
    q, pool, bt, sl, sc = _setup(kind, seed=7, ctx=(10, 3, 16))
    bt[:, 2:] = -1                       # only two live blocks per lane
    ref = np.asarray(jx.pa.paged_attention_decode(
        *map(jx.jnp.asarray, (q, pool, bt, sl)), H_KV, jx.jnp.asarray(sc)))
    got = paged_decode(*map(_t, (q, pool, bt, sl)), H_KV, scales=_t(sc))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    fallback = tpa.paged_attention_decode(*map(_t, (q, pool, bt, sl)), H_KV,
                                          scales=_t(sc))
    np.testing.assert_allclose(fallback.numpy(), ref, atol=ATOL, rtol=0)


SPLIT_CASES = {
    "cut_at_p_minus_1_p_p_plus_1": dict(ctx=(15, 16, 17), partition=16),
    "cut_at_one_block": dict(ctx=(7, 8, 9), partition=8),
    "one_split": dict(partition=MAXB * BS),
    "dead_lane": dict(ctx=(0, 20, 5), partition=8),
    "minus_one_entries": dict(ctx=(10, 3, 16), partition=8),
    "oversized_seq_len": dict(ctx=(MAXB * BS + 13, 9, MAXB * BS),
                              partition=16),
    "mha": dict(h=4, h_kv=4, partition=24),
}


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_ref_matches_pallas_kernel_and_plain(jx, kind, name):
    kw = dict(SPLIT_CASES[name])
    part = kw.pop("partition")
    q, pool, bt, sl, sc = _setup(kind, seed=len(name) + 40, **kw)
    if name == "minus_one_entries":
        bt[:, 2:] = -1                   # only two live blocks per lane
    h_kv = kw.get("h_kv", H_KV)
    ref = np.asarray(jx.pdp.paged_attention_decode_pallas(
        *map(jx.jnp.asarray, (q, pool, bt, sl)), h_kv, jx.jnp.asarray(sc)))
    args = tuple(map(_t, (q, pool, bt, sl)))
    got = paged_attention_decode_split_ref(*args, h_kv, _t(sc),
                                           partition=part)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    plain = paged_attention_decode_ref(*args, h_kv, _t(sc))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL, rtol=0)
    if name == "dead_lane":
        assert np.all(got[0].numpy() == 0.0)


def test_wrappers_count_no_cpu_launch():
    q, pool, bt, sl, sc = _setup("int4")
    before = (paged_decode.launches, paged_decode_int8.launches,
              paged_decode_int4.launches)
    paged_decode(*map(_t, (q, pool, bt, sl)), H_KV, scales=_t(sc))
    assert (paged_decode.launches, paged_decode_int8.launches,
            paged_decode_int4.launches) == before


# -- on the card -------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_quantized_kernel_matches_plain_on_card(cuda, kind, dtype, d):
    g = torch.Generator(device=cuda).manual_seed(0)
    b, h, h_kv, bs, maxb, nb = 5, 16, 8, 16, 8, 64
    q = torch.randn(b, h, d, device=cuda, generator=g).to(dtype)
    width = h_kv * d // (2 if kind == "int4" else 1)
    pool = torch.randint(-128, 128, (nb, 2, bs, width), device=cuda,
                         generator=g).to(torch.int8)
    shape = (nb, 2, h_kv, bs) if kind == "int4" else (nb, 2, bs)
    sc = torch.rand(shape, device=cuda, generator=g) * 0.05
    bt = torch.randperm(nb, device=cuda, generator=g)[:b * maxb].reshape(
        b, maxb).int()
    bt[1, 5:] = -1
    sl = torch.tensor([37, 70, 0, 128, 500], dtype=torch.int32, device=cuda)
    fn = paged_decode_int4 if kind == "int4" else paged_decode_int8
    before = fn.launches
    out = paged_decode(q, pool, bt, sl, h_kv, scales=sc)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref = paged_attention_decode_ref(q, pool, bt, sl, h_kv, sc)
    top = float(ref.float().abs().max())
    atol = 1e-4 if dtype == torch.float32 else 2.0 ** -7 * top + 1e-4
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    assert torch.all(out[2] == 0)


# (B, H_kv, BS, MAXB): eight 16-token partitions, phase 2's plan (P = 64,
# S = 16), and one partition (the first kernel writes the output)
CARD_SHAPES = {"p16": (6, 2, 16, 8), "p64": (16, 8, 16, 64),
               "one_split": (256, 8, 16, 8)}


def _quant_split_case(cuda, kind, dtype, d, group, shape, seed):
    """Random pool bytes and scales, lengths at the plan's partition edges
    (P - 1, P, P + 1, a dead lane, an oversized and a full lane, the rest
    random); lane 1's table is -1 past its live blocks."""
    b, h_kv, bs, maxb = shape
    part, _ = tpd._decode_plan(b, h_kv, bs, maxb)
    g = torch.Generator(device=cuda).manual_seed(seed)
    nb = 64
    q = torch.randn(b, h_kv * group, d, device=cuda, generator=g).to(dtype)
    width = h_kv * d // (2 if kind == "int4" else 1)
    pool = torch.randint(-128, 128, (nb, 2, bs, width), device=cuda,
                         generator=g).to(torch.int8)
    sc_shape = (nb, 2, h_kv, bs) if kind == "int4" else (nb, 2, bs)
    sc = torch.rand(sc_shape, device=cuda, generator=g) * 0.05
    bt = torch.randint(0, nb, (b, maxb), device=cuda, generator=g).int()
    top = maxb * bs
    edge = [min(part - 1, top), min(part, top), min(part + 1, top), 0,
            top + 13, top]
    lens = (edge + np.random.default_rng(seed).integers(
        0, top + 20, b).tolist())[:b]
    bt[1, -(-lens[1] // bs):] = -1
    sl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    return q, pool, bt, sl, h_kv, sc


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_quantized_split_pair_matches_plain_on_card(cuda, d, dtype, kind,
                                                    group, shape):
    q, pool, bt, sl, h_kv, sc = _quant_split_case(
        cuda, kind, dtype, d, group, CARD_SHAPES[shape], seed=group + d)
    fn = paged_decode_int4 if kind == "int4" else paged_decode_int8
    before = fn.launches
    out = paged_decode(q, pool, bt, sl, h_kv, scales=sc)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref = paged_attention_decode_ref(q, pool, bt, sl, h_kv, sc)
    top = float(ref.float().abs().max())
    atol = 1e-4 if dtype == torch.float32 else 2.0 ** -7 * top + 1e-4
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    assert torch.all(out[3] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantized_split_pair_gives_the_same_bits_twice_on_card(cuda, kind):
    q, pool, bt, sl, h_kv, sc = _quant_split_case(
        cuda, kind, torch.bfloat16, 128, 2, CARD_SHAPES["p64"], seed=5)
    outs = [paged_decode(q, pool, bt, sl, h_kv, scales=sc)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
