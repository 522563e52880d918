"""Quantized serving in the PyTorch port against the JAX package: trees
from ``quantize_params`` (int8; int4 with ``group_size=64``, which divides
the test width where the default 128 would quietly give int8; W8A8)
bridged into the port, then

- ``serving.paged_model`` prefill and decode logits against JAX's at fp64
  with ``tests/test_torch_serving.py``'s atol, on float, int8 and int4
  pools (JAX runs its quantized pools' attention in fp32);
- the engine's greedy tokens against the JAX engine's at fp32, for int8
  weights + int8 pool and int4 weights + int4 pool, with the prompts of
  ``tests/test_quant.py``;
- the port's own ``quantize_model`` on the bridged float model against the
  bridged JAX-quantized tree: the same bytes, so the same tokens."""

from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vyomai_tpu as vt
from vyomai_tpu.serving import ContinuousBatchEngine as JaxEngine
from vyomai_tpu.serving import paged_model as jpm

import vyomai_tpu_torch as tt
from vyomai_tpu_torch.interop import params_from_jax, tree_from_torch
from vyomai_tpu_torch.quant import Int4Linear, Int8Linear, quantize_model
from vyomai_tpu_torch.serving import paged_model as tpm

torch.set_num_threads(1)

QCFG = vt.QwenConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, head_dim=32,
                     max_position_embeddings=256, qk_norm=True,
                     eos_token_id=9999, tie_word_embeddings=True)
TCFG = tt.QwenConfig(**{f.name: getattr(QCFG, f.name) for f in fields(QCFG)})
LOGIT_ATOL = 1e-4   # tests/test_torch_serving.py (fp64 slice logits)
QUANT = {"int8": dict(bits=8), "int4": dict(bits=4, group_size=64),
         "w8a8": dict(bits=8, act_bits=8)}
POOLS = {"float": None, "int8": jnp.int8, "int4": "int4"}
TORCH_POOLS = {"int8": torch.int8, "int4": "int4"}


@pytest.fixture(scope="module")
def model_params():
    model = vt.ModelForCausalLM(QCFG)
    return model, model.init(jax.random.PRNGKey(2), dtype=jnp.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


NB, BS, MAXB = 16, 4, 4


def _prefill_inputs(lanes, t_pad, n_pad=3):
    """lanes: (tokens, cached, table) -> the engine's prefill arrays."""
    ids = np.zeros((n_pad, t_pad), np.int32)
    pos = np.zeros((n_pad, t_pad), np.int32)
    sb = np.full((n_pad, t_pad), -1, np.int32)
    so = np.zeros((n_pad, t_pad), np.int32)
    tables = np.full((n_pad, MAXB), -1, np.int32)
    ctx = np.zeros(n_pad, np.int32)
    true = np.zeros(n_pad, np.int32)
    for i, (toks, cached, table) in enumerate(lanes):
        t = len(toks)
        ids[i, :t] = toks
        pos[i] = np.minimum(cached + np.arange(t_pad), cached + t - 1)
        p = cached + np.arange(t)
        sb[i, :t] = np.asarray(table)[p // BS]
        so[i, :t] = p % BS
        tables[i, :len(table)] = table
        ctx[i] = cached + t
        true[i] = t
    return ids, pos, sb, so, tables, ctx, true


@pytest.mark.parametrize("pool", sorted(POOLS))
@pytest.mark.parametrize("quant", sorted(QUANT))
def test_prefill_decode_logits_fp64(model_params, quant, pool):
    model, params = model_params
    rng = np.random.default_rng(1)
    p0 = rng.integers(0, 512, 7).tolist()
    p1 = rng.integers(0, 512, 10).tolist()
    t0, t1 = [3, 5, 10], [8, 1, 12, 14]
    steps = [([(p0, 0, t0), (p1[:6], 0, t1)], 8), ([(p1[6:], 6, t1)], 4)]
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(
            lambda x: jnp.asarray(np.asarray(x, np.float64)), params)
        qp = vt.quantize_params(p64, **QUANT[quant])
        tmodel = params_from_jax(_np(qp), TCFG, device="cpu")
        assert tmodel.dtype == torch.float64
        jpool = jpm.init_pool(QCFG, NB, BS, dtype=POOLS[pool] or jnp.float64)
        tpool = tpm.init_pool(TCFG, NB, BS,
                              dtype=TORCH_POOLS.get(pool, torch.float64),
                              device="cpu")
        for lanes, t_pad in steps:
            arrays = _prefill_inputs(lanes, t_pad)
            jl, jpool = jpm.prefill(model, False, qp, jpool,
                                    *map(jnp.asarray, arrays))
            tl = tpm.prefill(tmodel, tpool, *map(torch.from_numpy, arrays))
            live = arrays[-1] > 0
            np.testing.assert_allclose(tl.numpy()[live],
                                       np.asarray(jl)[live],
                                       atol=LOGIT_ATOL, rtol=0)
        toks = np.array([17, 99, 0], np.int32)
        pos = np.array([len(p0), len(p1), 0], np.int32)
        tables = np.full((3, MAXB), -1, np.int32)
        tables[0, :3], tables[1, :4] = t0, t1
        for _ in range(3):
            sb = np.array([tables[0, pos[0] // BS], tables[1, pos[1] // BS],
                           -1], np.int32)
            so = (pos % BS).astype(np.int32)
            sl = np.array([pos[0] + 1, pos[1] + 1, 0], np.int32)
            args = (toks, pos, tables, sl, sb, so)
            jl, jpool = jpm.decode(model, False, qp, jpool,
                                   *map(jnp.asarray, args))
            tl = tpm.decode(tmodel, tpool, *map(torch.from_numpy, args))
            np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                                       atol=LOGIT_ATOL, rtol=0)
            toks = np.argmax(np.asarray(jl), -1).astype(np.int32)
            toks[2] = 0
            pos = pos + np.array([1, 1, 0], np.int32)
        if pool != "float":   # the quantized bytes written agree
            kv, _ = tpm.pool_parts(tpool)
            same = np.mean(kv.numpy() == np.asarray(jpool["kv"]))
            assert same > 0.999, same


ENG = dict(num_blocks=64, block_size=8, max_batch=4, max_blocks_per_seq=8,
           max_new_tokens=6, prefill_buckets=(8, 16))
PROMPTS = {  # tests/test_quant.py:143 (int8) and :359 (int4)
    "int8": [[3, 17, 42, 9], [5, 11], [3, 17, 42, 9, 21, 33]],
    "int4": [[3, 17, 42, 9], [5, 11, 19]],
}


def _torch_tokens(tmodel, pool, prompts):
    eng = tt.ContinuousBatchEngine(tmodel, dtype=TORCH_POOLS[pool], **ENG)
    ids = [eng.submit(list(p)) for p in prompts]
    out = eng.run()
    assert eng.kv.num_free() == eng.kv.num_blocks
    return [out[i] for i in ids], eng


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_engine_greedy_matches_jax(model_params, kind):
    model, params = model_params
    qp = vt.quantize_params(params, **QUANT[kind])
    prompts = PROMPTS[kind]
    jeng = JaxEngine(model, qp, dtype=POOLS[kind], kv_backend="python",
                     **ENG)
    with jax.default_matmul_precision("highest"):
        jids = [jeng.submit(list(p)) for p in prompts]
        jout = jeng.run()
    tmodel = params_from_jax(_np(qp), TCFG, device="cpu")
    cls = Int4Linear if kind == "int4" else Int8Linear
    assert isinstance(tmodel.layers[0].mlp.up_proj, cls)
    tout, eng = _torch_tokens(tmodel, kind, prompts)
    assert tout == [jout[s] for s in jids]
    m = eng.metrics()
    weights = sum(x.nbytes for x in jax.tree_util.tree_leaves(_np(qp)))
    # the port holds no act_q / out_dtype markers: a few bytes fewer
    assert 0 <= weights - m["weight_bytes"] <= 64
    kv, sc = tpm.pool_parts(eng.pool)
    assert m["pool_bytes"] == kv.numel() + 4 * sc.numel()


def test_quantized_prefill_attends_the_fp32_context(monkeypatch):
    """A bf16 prefill through an int8 pool attends bf16 q against the
    fp32 dequantized context, as the JAX prefill does (its einsum casts
    both to fp32): each layer's attention equals fp64 attention over the
    context that ``gather_kv`` returned, within fp32 rounding, not within
    the bf16 rounding of that context."""
    model = tt.ModelForCausalLM(TCFG, device="cpu", dtype=torch.bfloat16)
    model.init(torch.Generator().manual_seed(4)).requires_grad_(False)
    pool = tpm.init_pool(TCFG, NB, BS, dtype=torch.int8, device="cpu")
    seen, contexts = [], []
    gather, attend = tpm.gather_kv, tpm.flash_attention_fwd

    def gather_rec(*args):
        got = gather(*args)
        contexts.append(got)
        return got

    def attend_rec(q, k, v, bias, **kw):
        got = attend(q, k, v, bias, **kw)
        seen.append((q, bias, got[0]))
        return got

    monkeypatch.setattr(tpm, "gather_kv", gather_rec)
    monkeypatch.setattr(tpm, "flash_attention_fwd", attend_rec)
    rng = np.random.default_rng(3)
    lanes = [(rng.integers(0, 512, 9).tolist(), 0, [3, 5, 10]),
             (rng.integers(0, 512, 6).tolist(), 0, [8, 1])]
    tpm.prefill(model, pool, *map(torch.from_numpy,
                                  _prefill_inputs(lanes, 12)))
    assert len(seen) == TCFG.num_hidden_layers == len(contexts)
    group = TCFG.num_attention_heads // TCFG.num_key_value_heads
    for (q, bias, out), (kk, vv) in zip(seen, contexts):
        assert kk.dtype == torch.float32
        s = torch.einsum("nhtd,nhsd->nhts", q.double(),
                         kk.double().repeat_interleave(group, dim=1))
        s = s / TCFG.head_dim ** 0.5 + bias.double()
        want = torch.einsum("nhts,nhsd->nhtd", torch.softmax(s, dim=-1),
                            vv.double().repeat_interleave(group, dim=1))
        live = (bias > -1e30).any(dim=-1).expand(want.shape[:3])
        err = (out.double() - want).abs()[live].max()
        assert err <= 1e-5 * want.abs().max(), float(err)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantize_model_serves_like_the_jax_tree(model_params, kind):
    _, params = model_params
    qp = vt.quantize_params(params, **QUANT[kind])
    bridged = params_from_jax(_np(qp), TCFG, device="cpu")
    own = quantize_model(params_from_jax(_np(params), TCFG, device="cpu"),
                         **QUANT[kind])
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(tree_from_torch(own)),
            jax.tree_util.tree_leaves_with_path(tree_from_torch(bridged))):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    prompts = PROMPTS[kind]
    assert _torch_tokens(own, kind, prompts)[0] == \
        _torch_tokens(bridged, kind, prompts)[0]
