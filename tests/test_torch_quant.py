"""Weight quantization in the PyTorch port (``ops.quant_matmul``,
``quant``) against the JAX package.

The quantizers must give bit-identical ints and scales on the same fp32
input (numpy, from a seed). The plain versions of K8 and K9 are held to the
JAX Pallas kernels run in interpret mode (``set_impl("pallas");
set_interpret(True)``, as ``tests/test_quant.py`` runs them) and to the XLA
path, at that file's fp32 tolerance (atol 1e-4, rtol 1e-5); K10's two plain
modes to the kernel bodies' formula with the TPU's scale row.
``quantize_model`` is held to ``quantize_params`` on the tree of
``tests/test_quant.py`` (``QCFG``). The cases marked ``cuda`` run the
hand-written kernels against their plain versions and skip without a card;
JAX is loaded by the ``jx`` fixture, so they also run where JAX is not
installed."""

from dataclasses import fields
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vyomai_tpu_torch import quant as tq
from vyomai_tpu_torch.ops import quant_matmul as tqm

torch.set_num_threads(1)

ATOL, RTOL = 1e-4, 1e-5   # tests/test_quant.py, kernel vs fallback (fp32)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's quantization modules, on the CPU."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import vyomai_tpu as vt
    from vyomai_tpu.core import nn as jnn
    from vyomai_tpu.ops import quant_matmul as jqm
    return SimpleNamespace(jax=jax, jnp=jnp, vt=vt, qm=jqm, nn=jnn,
                           cpu=jax.devices("cpu")[0])


def _rng(seed):
    return np.random.default_rng(seed)


def _t(x):
    return torch.from_numpy(np.array(x))   # own, writable copy


# -- quantizers: bit-identical --------------------------------------------------

@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_weight_bit_identical(jx, axis):
    w = (_rng(0).standard_normal((96, 160)) * 0.04).astype(np.float32)
    w[:, 3] = 0.0 if axis == 0 else w[:, 3]
    w[5] = 0.0 if axis == 1 else w[5]
    jq, js = jx.qm.quantize_weight(jx.jnp.asarray(w), contract_axis=axis)
    q, s = tqm.quantize_weight(_t(w), contract_axis=axis)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert float(s[3 if axis == 0 else 5]) == 1.0   # a zero channel


@pytest.mark.parametrize("gs", [32, 64, 128])
def test_quantize_weight_int4_bit_identical(jx, gs):
    w = (_rng(gs).standard_normal((256, 96)) * 0.05).astype(np.float32)
    w[:gs, 7] = 0.0                                 # a zero group
    jp, js = jx.qm.quantize_weight_int4(jx.jnp.asarray(w), group_size=gs)
    p, s = tqm.quantize_weight_int4(_t(w), group_size=gs)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    lo, hi = tqm.unpack_int4(p)
    jlo, jhi = jx.qm._unpack_int4(jp)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))


def test_unpack_int4_sign_extends_every_byte(jx):
    p8 = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    jlo, jhi = jx.qm._unpack_int4(jx.jnp.asarray(p8))
    lo, hi = tqm.unpack_int4(_t(p8))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))


def test_quantize_activation_bit_identical(jx):
    x = (_rng(1).standard_normal((6, 96)) * 3).astype(np.float32)
    x[2] = 0.0
    jq, js = jx.qm.quantize_activation(jx.jnp.asarray(x))
    q, s = tqm.quantize_activation(_t(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("gs,k", [(32, 256), (64, 256), (128, 256),
                                  (128, 2048), (64, 1024), (128, 3072)])
def test_k10_scale_row_is_the_tpu_kernels(jx, gs, k):
    rows = jx.qm._int4_block_rows(gs, k // 2)
    assert tqm.int4_block_rows(gs, k // 2) == rows
    gpb = rows // (gs // 2)
    assert tqm.k10_scale_row(k, gs) == ((k // 2) // rows - 1) * gpb


# -- plain matmuls against the JAX kernels ---------------------------------------

def _pallas(jx, fn, *args, **kw):
    """Run a JAX quant matmul through its Pallas kernel in interpret mode."""
    jx.qm.set_impl("pallas")
    jx.qm.set_interpret(True)
    try:
        with jx.jax.default_device(jx.cpu):
            return np.asarray(fn(*args, **kw))
    finally:
        jx.qm.set_interpret(False)
        jx.qm.set_impl("xla")


@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("m", [1, 5, 16])
def test_int8_matmul_matches_pallas_and_xla(jx, layout, m):
    rng = _rng(m)
    x = rng.standard_normal((m, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 384)) * 0.05).astype(np.float32)
    q, s = jx.qm.quantize_weight(jx.jnp.asarray(w))
    if layout == "nk":
        q = q.T
    args = (jx.jnp.asarray(x), q, s)
    ref = _pallas(jx, jx.qm.int8_matmul, *args, w_layout=layout)
    with jx.jax.default_device(jx.cpu):
        xla = np.asarray(jx.qm.int8_matmul(*args, w_layout=layout))
    got = tqm.int8_matmul(_t(x), _t(np.asarray(q)), _t(np.asarray(s)),
                          w_layout=layout).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, xla, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("kernel", ["fold", "split"])
@pytest.mark.parametrize("gs", [32, 64, 128])
@pytest.mark.parametrize("m", [1, 5])
def test_int4_matmul_matches_pallas(jx, kernel, gs, m):
    """Both layouts of the packed weight: JAX's ``[K/2, N]`` and the
    modules' k-contiguous ``[N, K/2]`` give the same bits, and both match
    the Pallas kernel."""
    rng = _rng(gs + m)
    x = rng.standard_normal((m, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 384)) * 0.05).astype(np.float32)
    p, s = jx.qm.quantize_weight_int4(jx.jnp.asarray(w), group_size=gs)
    jx.qm.set_int4_kernel(kernel)
    try:
        ref = _pallas(jx, jx.qm.int4_matmul, jx.jnp.asarray(x), p, s)
    finally:
        jx.qm.set_int4_kernel("fold")
    tp, ts = _t(np.asarray(p)), _t(np.asarray(s))
    got = tqm.int4_matmul(_t(x), tp, ts, kernel=kernel).numpy()
    got_nk = tqm.int4_matmul(_t(x), tp.t().contiguous(), ts, kernel=kernel,
                             w_layout="nk").numpy()
    np.testing.assert_array_equal(got_nk, got)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_int4_matmul_matches_xla_reconstruction(jx):
    rng = _rng(9)
    x = rng.standard_normal((5, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 384)) * 0.05).astype(np.float32)
    p, s = jx.qm.quantize_weight_int4(jx.jnp.asarray(w), group_size=128)
    with jx.jax.default_device(jx.cpu):
        ref = np.asarray(jx.qm.int4_matmul(jx.jnp.asarray(x), p, s))
    tp, ts = _t(np.asarray(p)), _t(np.asarray(s))
    for kernel in ("fold", "split"):
        got = tqm.int4_matmul(_t(x), tp, ts, kernel=kernel).numpy()
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("layout", ["kn", "nk"])
def test_w8a8_matmul_matches_jax(jx, layout):
    rng = _rng(31)
    x = rng.standard_normal((5, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 128)) * 0.05).astype(np.float32)
    wq, ws = jx.qm.quantize_weight(jx.jnp.asarray(w))
    if layout == "nk":
        wq = wq.T
    with jx.jax.default_device(jx.cpu):
        ref = np.asarray(jx.qm.w8a8_matmul(jx.jnp.asarray(x), wq, ws,
                                           w_layout=layout))
    got = tqm.w8a8_matmul(_t(x), _t(np.asarray(wq)), _t(np.asarray(ws)),
                          w_layout=layout).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("gs", [32, 128])
@pytest.mark.parametrize("mode", ["stream", "noscale"])
def test_k10_plain_modes_match_the_kernel_bodies(jx, mode, gs):
    """``_stream_kernel`` dots the packed bytes with x's even and odd
    columns; ``_noscale_kernel`` the unpacked nibbles; both then scale by
    the last K block's first group row. The ``nk`` layout gives the same
    bits as the ``kn`` one."""
    m, k, n = 8, 2048, 256
    rng = _rng(5)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    p, s = jx.qm.quantize_weight_int4(jx.jnp.asarray(w), group_size=gs)
    p8, s = np.asarray(p), np.asarray(s)
    rows = jx.qm._int4_block_rows(gs, k // 2)
    row = ((k // 2) // rows - 1) * (rows // (gs // 2))
    xe, xo = x[:, 0::2].astype(np.float64), x[:, 1::2].astype(np.float64)
    if mode == "stream":
        acc = xe @ p8 + xo @ p8
    else:
        lo, hi = (np.asarray(a) for a in jx.qm._unpack_int4(p))
        acc = xe @ lo + xo @ hi
    ref = acc * s[row]
    got = tqm.int4_attribution(_t(x), _t(p8), _t(s), mode=mode,
                               scale_row=tqm.k10_scale_row(k, gs))
    got_nk = tqm.int4_attribution(_t(x), _t(p8.T), _t(s), mode=mode,
                                  scale_row=tqm.k10_scale_row(k, gs),
                                  w_layout="nk")
    np.testing.assert_array_equal(got_nk.numpy(), got.numpy())
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_wrappers_count_no_cpu_launch():
    x = torch.randn(3, 64)
    q, s = tqm.quantize_weight(torch.randn(64, 32))
    p, s4 = tqm.quantize_weight_int4(torch.randn(64, 32), group_size=32)
    counts = (lambda: (tqm.int8_matmul.launches, tqm.int8_matmul.tc_launches,
                       tqm.int4_matmul.launches, tqm.int4_matmul.tc_launches,
                       tqm.int4_attribution.launches,
                       tqm.int4_attribution.tc_launches))
    before = counts()
    tqm.int8_matmul(x, q, s)
    tqm.int8_matmul(x.bfloat16(), q.t().contiguous(), s, w_layout="nk")
    tqm.int4_matmul(x, p, s4)
    tqm.int4_matmul(x.bfloat16(), p.t().contiguous(), s4, w_layout="nk")
    tqm.int4_attribution(x, p, s4, mode="stream", scale_row=0)
    tqm.int4_attribution(x.bfloat16(), p.t().contiguous(), s4,
                         mode="noscale", scale_row=0, w_layout="nk")
    assert counts() == before


# -- quantize_model against quantize_params --------------------------------------

def _qcfg(jx, **kw):
    return jx.vt.QwenConfig(vocab_size=512, hidden_size=64,
                            intermediate_size=128, num_hidden_layers=2,
                            num_attention_heads=4, num_key_value_heads=2,
                            head_dim=32, max_position_embeddings=256,
                            qk_norm=True, eos_token_id=9999,
                            tie_word_embeddings=True).replace(**kw)


def _float_pair(jx, **kw):
    """The JAX tree of tests/test_quant.py (``QCFG``, key 2) and the port's
    model bridged from it."""
    import vyomai_tpu_torch as tt
    from vyomai_tpu_torch.interop import params_from_jax
    cfg = _qcfg(jx, **kw)
    tcfg = tt.QwenConfig(**{f.name: getattr(cfg, f.name)
                            for f in fields(cfg)})
    params = jx.vt.ModelForCausalLM(cfg).init(jx.jax.random.PRNGKey(2),
                                              dtype=jx.jnp.float32)
    tree = jx.jax.tree_util.tree_map(np.asarray, params)
    return params, params_from_jax(tree, tcfg, device="cpu")


def _assert_trees_equal(jx, got, want):
    want = dict(jx.jax.tree_util.tree_leaves_with_path(want))
    got = jx.jax.tree_util.tree_leaves_with_path(got)
    assert sorted(map(str, dict(got))) == sorted(map(str, want))
    for path, x in got:
        w = np.asarray(want[path])
        assert x.dtype == w.dtype and x.shape == w.shape, path
        np.testing.assert_array_equal(x, w, err_msg=str(path))


@pytest.mark.parametrize("opts", [dict(bits=8), dict(bits=4, group_size=64),
                                  dict(bits=4, group_size=32),
                                  dict(bits=8, act_bits=8)],
                         ids=["int8", "int4-gs64", "int4-gs32", "w8a8"])
def test_quantize_model_matches_quantize_params(jx, opts):
    from vyomai_tpu_torch.interop import tree_from_torch
    params, model = _float_pair(jx)
    want = jx.vt.quantize_params(params, **opts)
    tq.quantize_model(model, **opts)
    kinds = {type(m).__name__ for m in model.modules()}
    assert ("Int4Linear" in kinds) == (opts["bits"] == 4)
    assert "Int8Embedding" in kinds and "RMSNorm" in kinds
    _assert_trees_equal(jx, tree_from_torch(model), want)


def test_indivisible_k_stays_int8(jx):
    """tests/test_quant.py: K=48 with group_size=64 falls back to int8."""
    class Proj(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.proj = torch.nn.Linear(48, 64, bias=False)
    w = (_rng(13).standard_normal((48, 64)) * 0.05).astype(np.float32)
    mod = Proj()
    with torch.no_grad():
        mod.proj.weight.copy_(_t(w.T))
    tq.quantize_model(mod, bits=4, group_size=64)
    want = jx.vt.quantize_params({"proj": {"kernel": jx.jnp.asarray(w)}},
                                 bits=4, group_size=64)["proj"]
    assert isinstance(mod.proj, tq.Int8Linear) and "kernel_q" in want
    np.testing.assert_array_equal(mod.proj.weight_q.numpy().T,
                                  np.asarray(want["kernel_q"]))


def test_int4_linear_stores_the_transposed_kernel_q4(jx):
    """``Int4Linear.weight_q4`` is JAX's ``kernel_q4`` transposed to
    ``[out, in/2]``, row-major (k contiguous), with the same group size,
    reconstruction and outputs; ``params_from_jax`` builds the same
    row-major buffers (and int8 ones) from a ``quantize_params`` tree."""
    from vyomai_tpu_torch.interop import params_from_jax
    params, model = _float_pair(jx)
    want = jx.vt.quantize_params(params, bits=4, group_size=32)
    tq.quantize_model(model, bits=4, group_size=32)
    lin = model.layers[1].mlp.down_proj
    kq4 = np.asarray(want["layers"]["mlp"]["down_proj"]["kernel_q4"][1])
    scale = np.asarray(want["layers"]["mlp"]["down_proj"]["scale"][1])
    assert isinstance(lin, tq.Int4Linear) and lin.weight_q4.is_contiguous()
    np.testing.assert_array_equal(lin.weight_q4.numpy(), kq4.T)
    assert lin.group_size == 32
    np.testing.assert_array_equal(
        lin.dequantized().numpy(),
        tqm.dequantize_int4(_t(kq4), _t(scale)).t().numpy())
    x = torch.from_numpy(_rng(3).standard_normal((5, kq4.shape[0] * 2))
                         .astype(np.float32))
    np.testing.assert_array_equal(
        lin(x).numpy(), tqm.int4_matmul(x, _t(kq4), _t(scale)).numpy())
    tcfg = model.config
    tree = jx.jax.tree_util.tree_map(np.asarray, want)
    bridged = params_from_jax(tree, tcfg, device="cpu")
    for a, b in zip(bridged.buffers(), model.buffers()):
        assert a.is_contiguous()
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    tree8 = jx.jax.tree_util.tree_map(
        np.asarray, jx.vt.quantize_params(params, bits=8))
    q_proj = params_from_jax(tree8, tcfg, device="cpu").layers[0].self_attn
    assert q_proj.q_proj.weight_q.is_contiguous()


def test_w8a8_untied_head_stays_weight_only(jx):
    from vyomai_tpu_torch.interop import tree_from_torch
    params, model = _float_pair(jx, tie_word_embeddings=False)
    want = jx.vt.quantize_params(params, act_bits=8)
    tq.quantize_model(model, act_bits=8)
    assert isinstance(model.lm_head, tq.Int8Linear)
    assert not model.lm_head.act_q
    assert model.layers[0].self_attn.q_proj.act_q
    assert "act_q" not in want["lm_head"]
    _assert_trees_equal(jx, tree_from_torch(model), want)


@pytest.mark.parametrize("bits,bound", [(8, 1.0 / 254), (4, 1.0 / 14)])
def test_quantization_error_within_jax_bounds(jx, bits, bound):
    params, model = _float_pair(jx)
    float_model = _float_pair(jx)[1]
    opts = dict(bits=bits, group_size=64)
    errs = tq.quantization_error(float_model,
                                 tq.quantize_model(model, **opts))
    qp = jx.vt.quantize_params(params, **opts)
    assert max(errs.values()) <= bound + 1e-6
    # JAX measures a stacked [L, ...] tensor at once: compare layer by layer
    for i in range(2):
        layer = jx.jax.tree_util.tree_map(lambda x: x[i], params["layers"])
        qlayer = jx.jax.tree_util.tree_map(lambda x: x[i], qp["layers"])
        jerrs = jx.vt.quantization_error(layer, qlayer)
        for key, want in jerrs.items():
            name = key.replace("']['", ".").strip("[']").replace(
                "kernel", "weight")
            assert errs[f"layers.{i}.{name}"] == pytest.approx(
                want, rel=1e-5, abs=1e-9), key
    jemb = jx.vt.quantization_error({"e": params["embed_tokens"]},
                                    {"e": qp["embed_tokens"]})
    assert errs["embed_tokens.weight"] == pytest.approx(
        max(jemb.values()), rel=1e-5)


def test_dequantize_model_matches_dequantize_params(jx):
    from vyomai_tpu_torch.interop import tree_from_torch
    params, model = _float_pair(jx)
    qp = jx.vt.quantize_params(params, bits=4, group_size=64)
    tq.dequantize_model(tq.quantize_model(model, bits=4, group_size=64))
    want = jx.jax.tree_util.tree_map(np.asarray,
                                     jx.vt.dequantize_params(qp))
    got = tree_from_torch(model)
    for path, x in jx.jax.tree_util.tree_leaves_with_path(got):
        w = dict(jx.jax.tree_util.tree_leaves_with_path(want))[path]
        np.testing.assert_allclose(x, w, rtol=1e-6, atol=1e-7,
                                   err_msg=str(path))


def test_quantized_embedding_and_tied_head_match_jax(jx):
    w = (_rng(5).standard_normal((64, 32)) * 0.3).astype(np.float32)
    qp = jx.vt.quantize_params({"embed_tokens": {"weight": jx.jnp.asarray(
        w)}})["embed_tokens"]
    emb = torch.nn.Embedding(64, 32)
    with torch.no_grad():
        emb.weight.copy_(_t(w))
    mod = tq._quantize_embedding(emb)
    ids = np.array([[0, 7, 63, 7]])
    h = _rng(6).standard_normal((3, 32)).astype(np.float32)
    with jx.jax.default_device(jx.cpu):
        rows = np.asarray(jx.nn.embedding(qp, jx.jnp.asarray(ids)))
        logits = np.asarray(jx.nn.tied_lm_head(qp, jx.jnp.asarray(h)))
    np.testing.assert_array_equal(mod(_t(ids)).numpy(), rows)
    np.testing.assert_allclose(mod.tied_lm_head(_t(h)).numpy(), logits,
                               atol=ATOL, rtol=RTOL)


def test_moe_expert_banks_raise():
    class Moe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w_in = torch.nn.Parameter(torch.zeros(2, 4, 8))
            self.w_out = torch.nn.Parameter(torch.zeros(2, 8, 4))
    with pytest.raises(NotImplementedError, match="layers/moe.py"):
        tq.quantize_model(torch.nn.Sequential(Moe()))
    with pytest.raises(ValueError, match="W8A8"):
        tq.quantize_model(torch.nn.Linear(4, 4), bits=4, act_bits=8)


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _atol(ref: torch.Tensor, dtype) -> float:
    """fp32: summation order; bf16: plus one ulp of the output after the
    final cast (2^-7 of its largest magnitude)."""
    top = float(ref.float().abs().max())
    return (2.0 ** -7 * top if dtype == torch.bfloat16 else 0.0) + \
        1e-5 * top + 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [
    (16, 1024, 2048), (37, 200, 90), (300, 512, 1024),
    # the tensor-core route: ragged M and N, decode and prefill tiles
    (1, 1024, 1000), (7, 1024, 1000), (16, 1024, 1000), (17, 1024, 1000),
    (100, 1024, 1000), (2048, 1024, 1000),
    # split-K (decode's narrow N), and K % 64 != 0 (a partial last step)
    (16, 3072, 1024), (1, 3072, 1024), (5, 1040, 300)])
def test_int8_kernel_matches_plain_on_card(cuda, dtype, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn(m, k, device=cuda, generator=g).to(dtype)
    q, s = tqm.quantize_weight(torch.randn(k, n, device=cuda, generator=g))
    for layout, w in (("kn", q), ("nk", q.t().contiguous())):
        before = (tqm.int8_matmul.launches, tqm.int8_matmul.tc_launches)
        out = tqm.int8_matmul(x, w, s, w_layout=layout)
        torch.cuda.synchronize()
        tc = int(dtype == torch.bfloat16 and layout == "nk" and k % 16 == 0)
        assert (tqm.int8_matmul.launches,
                tqm.int8_matmul.tc_launches) == (before[0] + 1,
                                                 before[1] + tc)
        ref = tqm.int8_matmul_ref(x, w, s, layout)
        torch.testing.assert_close(out.float(), ref.float(),
                                   atol=_atol(ref, dtype), rtol=0)


@pytest.mark.cuda
def test_int8_unaligned_nk_takes_the_cuda_cores_on_card(cuda):
    """An ``nk`` weight view whose rows are not 16-byte aligned goes to the
    CUDA-core kernel (the documented route) and still matches."""
    g = torch.Generator(device=cuda).manual_seed(3)
    m, k, n = 16, 1024, 500
    x = torch.randn(m, k, device=cuda, generator=g).bfloat16()
    q, s = tqm.quantize_weight(torch.randn(k, n, device=cuda, generator=g))
    base = torch.zeros(n, k + 8, dtype=torch.int8, device=cuda)
    base[:, :k] = q.t()
    w = base[:, :k]
    assert tqm.int8_route(x, w, "nk") == "cuda"
    before = tqm.int8_matmul.tc_launches
    out = tqm.int8_matmul(x, w, s, w_layout="nk")
    torch.cuda.synchronize()
    assert tqm.int8_matmul.tc_launches == before
    ref = tqm.int8_matmul_ref(x, w, s, "nk")
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=_atol(ref, torch.bfloat16), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(16, 3072, 1024), (16, 1024, 2048),
                                   (17, 1024, 1000)])
def test_int8_split_k_is_deterministic_on_card(cuda, m, k, n):
    """A split-K plan gives the same bits on every call, whatever order its
    CTAs finish in, and leaves every tile counter at 0."""
    index = torch.cuda.current_device()
    bm, bn, splits = tqm.int8_tc_plan(m, k, n, tqm._sm_count(index))
    assert splits > 1
    g = torch.Generator(device=cuda).manual_seed(k)
    x = torch.randn(m, k, device=cuda, generator=g).bfloat16()
    q, s = tqm.quantize_weight(torch.randn(n, k, device=cuda, generator=g),
                               contract_axis=1)
    outs = [tqm.int8_matmul(x, q, s, w_layout="nk") for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    stream = torch.cuda.current_stream().cuda_stream
    counters = tqm._WORKSPACE[(index, stream)][1]
    assert int(counters.abs().sum()) == 0


def _int4_call(x, p, s, mode, layout, gs):
    """(kernel output, plain output) of K9/K10 ``mode``."""
    k = x.shape[-1]
    if mode in ("fold", "split"):
        return (tqm.int4_matmul(x, p, s, kernel=mode, w_layout=layout),
                tqm.int4_matmul_ref(x, p, s, mode, 0, layout))
    row = tqm.k10_scale_row(k, gs) if tqm.int4_block_rows(gs, k // 2) else 0
    return (tqm.int4_attribution(x, p, s, mode=mode, scale_row=row,
                                 w_layout=layout),
            tqm.int4_matmul_ref(x, p, s, mode, row, layout))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["fold", "split", "stream", "noscale"])
@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("m,k,n,gs", [
    (21, 1024, 200, 32), (21, 1024, 200, 128),
    # ragged M and N on the decode and prefill tiles
    (1, 1024, 1000, 128), (7, 1024, 1000, 128), (16, 1024, 1000, 128),
    (17, 1024, 1000, 128), (100, 1024, 1000, 128), (2048, 1024, 3072, 128),
    # split-K (1024 -> 3072 at decode: 2 splits), and K % 64 != 0 (a
    # last step of 16 k: half of an int4 chunk of 32 k)
    (16, 1024, 3072, 128), (5, 1040, 300, 16)])
def test_int4_kernel_matches_plain_on_card(cuda, dtype, mode, layout, m, k,
                                           n, gs):
    """Each mode and layout against its plain version; bf16 ``nk`` fold,
    stream and noscale take the tensor cores (``tc_launches`` moves by
    exactly one), everything else the CUDA cores."""
    g = torch.Generator(device=cuda).manual_seed(gs + m)
    x = torch.randn(m, k, device=cuda, generator=g).to(dtype)
    p, s = tqm.quantize_weight_int4(
        torch.randn(k, n, device=cuda, generator=g), group_size=gs)
    if layout == "nk":   # rows padded to 16 bytes (K = 1040: 520 -> 528)
        base = torch.zeros(n, -(-k // 32) * 16, dtype=torch.int8,
                           device=cuda)
        base[:, :k // 2] = p.t()
        p = base[:, :k // 2]
    fn = tqm.int4_matmul if mode in ("fold", "split") else \
        tqm.int4_attribution
    before = (fn.launches, fn.tc_launches)
    out, ref = _int4_call(x, p, s, mode, layout, gs)
    torch.cuda.synchronize()
    tc = int(dtype == torch.bfloat16 and layout == "nk" and mode != "split")
    assert (fn.launches, fn.tc_launches) == (before[0] + 1, before[1] + tc)
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=_atol(ref, dtype), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fold", "stream", "noscale"])
def test_int4_unaligned_nk_takes_the_cuda_cores_on_card(cuda, mode):
    """An ``nk`` packed weight view whose rows are not 16-byte aligned goes
    to the CUDA-core kernel (the documented route) and still matches."""
    g = torch.Generator(device=cuda).manual_seed(4)
    m, k, n, gs = 16, 1024, 500, 128
    x = torch.randn(m, k, device=cuda, generator=g).bfloat16()
    p, s = tqm.quantize_weight_int4(
        torch.randn(k, n, device=cuda, generator=g), group_size=gs)
    base = torch.zeros(n, k // 2 + 8, dtype=torch.int8, device=cuda)
    base[:, :k // 2] = p.t()
    w = base[:, :k // 2]
    assert tqm.int4_route(x, w, "nk", mode, gs) == "cuda"
    fn = tqm.int4_matmul if mode == "fold" else tqm.int4_attribution
    before = fn.tc_launches
    out, ref = _int4_call(x, w, s, mode, "nk", gs)
    torch.cuda.synchronize()
    assert fn.tc_launches == before
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=_atol(ref, torch.bfloat16), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,m,k,n", [("fold", 16, 1024, 3072),
                                        ("fold", 1, 3072, 1024),
                                        ("stream", 8, 2048, 2048),
                                        ("noscale", 8, 2048, 2048)])
def test_int4_split_k_is_deterministic_on_card(cuda, mode, m, k, n):
    """A split-K int4 plan gives the same bits on every call and leaves
    every tile counter at 0."""
    index = torch.cuda.current_device()
    splits = tqm.int8_tc_plan(m, k, n, tqm._sm_count(index),
                              wide=mode == "fold")[2]
    assert splits > 1
    g = torch.Generator(device=cuda).manual_seed(k + n)
    x = torch.randn(m, k, device=cuda, generator=g).bfloat16()
    p, s = tqm.quantize_weight_int4(
        torch.randn(k, n, device=cuda, generator=g), group_size=128)
    p = p.t().contiguous()
    outs = [_int4_call(x, p, s, mode, "nk", 128)[0] for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    stream = torch.cuda.current_stream().cuda_stream
    assert int(tqm._WORKSPACE[(index, stream)][1].abs().sum()) == 0


@pytest.mark.cuda
def test_split_k_graph_replays_after_a_larger_call_on_card(cuda):
    """A CUDA graph captured over a split-K K9 call replays correctly after
    a larger split-K call on the capture stream has grown that stream's
    workspace: the captured buffers stay alive."""
    g = torch.Generator(device=cuda).manual_seed(8)
    m, k, n = 16, 1024, 3072
    x = torch.randn(m, k, device=cuda, generator=g).bfloat16()
    p, s = tqm.quantize_weight_int4(
        torch.randn(k, n, device=cuda, generator=g), group_size=128)
    p = p.t().contiguous()
    want = tqm.int4_matmul(x, p, s, w_layout="nk")
    big_x = torch.randn(16, 3072, device=cuda, generator=g).bfloat16()
    big_p, big_s = tqm.quantize_weight_int4(
        torch.randn(3072, 4096, device=cuda, generator=g), group_size=128)
    big_p = big_p.t().contiguous()
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):   # warm the capture stream's workspace
        tqm.int4_matmul(x, p, s, w_layout="nk")
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        got = tqm.int4_matmul(x, p, s, w_layout="nk")
    key = (torch.cuda.current_device(), stream.cuda_stream)
    held = tqm._WORKSPACE[key][0].data_ptr()
    with torch.cuda.stream(stream):   # grows the workspace the graph holds
        big = tqm.int4_matmul(big_x, big_p, big_s, w_layout="nk")
    torch.cuda.synchronize()
    assert tqm._WORKSPACE[key][0].data_ptr() != held
    got.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    big_ref = tqm.int4_matmul_ref(big_x, big_p, big_s, "fold", 0, "nk")
    torch.testing.assert_close(big.float(), big_ref.float(),
                               atol=_atol(big_ref, torch.bfloat16), rtol=0)
