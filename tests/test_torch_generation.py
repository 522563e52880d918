"""Static-cache generation of the port's ``DecoderModel`` against the JAX
package, and the pieces under it: ``layers.kv_cache``, the static-cache
mask, the sampling processors and penalties.

Inputs are made with numpy from a seed and go through both packages on the
CPU. Tolerances: cached logits and cache contents at fp64 within atol 1e-4
(``tests/test_torch_decoder.py``'s, after ``tests/test_parity_torch.py``);
greedy tokens exact at fp32; masks exact; processors at fp32 within 1e-6
(the same arithmetic, a different summation order in softmax)."""

from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vyomai_tpu as vt
from vyomai_tpu.core import masks as jmasks
from vyomai_tpu.generation import sampling as jsamp
from vyomai_tpu.layers import kv_cache as jkv

import vyomai_tpu_torch as tt
from vyomai_tpu_torch.core import masks as tmasks
from vyomai_tpu_torch.generation import sampling as tsamp
from vyomai_tpu_torch.interop import decoder_params_from_jax
from vyomai_tpu_torch.layers import kv_cache as tkv

torch.set_num_threads(1)

CFG = vt.EncoderConfig(hidden_size=64, num_attention_heads=4,
                       num_key_value_heads=2, num_hidden_layers=2,
                       vocab_size=128, max_position_embeddings=64,
                       intermediate_size=256, hidden_dropout_prob=0.0)
TCFG = tt.EncoderConfig(**{f.name: getattr(CFG, f.name)
                           for f in fields(CFG)})
VARIANTS = [(pe, at) for pe in ("absolute", "sinusoidal", "rope")
            for at in (None, "gqa")]
LOGIT_ATOL = 1e-4   # fp64, as tests/test_torch_decoder.py


def _np_tree(params, dtype):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, dtype), params)


def _models(pe, at, seed=0, dtype=np.float32, cfg=CFG):
    jmodel = vt.DecoderModel(cfg, pos_embedding_type=pe, attention_type=at)
    params = _np_tree(jmodel.init(jax.random.PRNGKey(seed)), dtype)
    tcfg = tt.EncoderConfig(**{f.name: getattr(cfg, f.name)
                               for f in fields(cfg)})
    tmodel = decoder_params_from_jax(params, tcfg, pe, at, device="cpu")
    return jmodel, params, tmodel


def _prompt(seed, b=2, l=7, vocab=CFG.vocab_size):
    rng = np.random.default_rng(seed)
    return rng.integers(2, vocab, (b, l)).astype(np.int32)


# -- kv cache and mask -------------------------------------------------------------

def test_init_cache_and_trim_match_jax():
    j = jkv.init_cache(CFG, batch_size=3, max_len=20, num_kv_heads=2)
    t = tkv.init_cache(TCFG, batch_size=3, max_len=20, num_kv_heads=2,
                       device="cpu")
    assert tuple(t["k"].shape) == j["k"].shape == (2, 3, 2, 20, 16)
    assert t["v"].shape == t["k"].shape and t["k"].dtype == torch.float32
    assert not t["k"].any() and t["length"] == int(j["length"]) == 0
    assert tkv.cache_max_len(t) == jkv.cache_max_len(j) == 20
    for length, drop in ((9, 4), (3, 5), (0, 1), (7, 0)):
        jt = jkv.trim(jkv.with_length(j, length), drop)
        tt_ = tkv.trim(tkv.with_length(t, length), drop)
        assert tt_["length"] == int(jt["length"]) == max(length - drop, 0)
    one = tt.StaticCacheOne(TCFG, max_cache_len=8, device="cpu").pytree()
    assert tuple(one["k"].shape) == jkv.StaticCacheOne(
        CFG, max_cache_len=8).pytree()["k"].shape == (2, 1, 2, 8, 16)
    assert tt.DynamicCache is tt.StaticCache is tt.DynamicCacheOne \
        is tt.StaticCacheOne


@pytest.mark.parametrize("seq_len,cap,start,mask_len,window,sinks", [
    (5, 12, 0, 5, None, 0),       # prefill, mask shorter than the buffer
    (1, 12, 7, None, None, 0),    # a decode step, no mask
    (3, 10, 4, 14, None, 0),      # mask longer than the buffer
    (4, 16, 6, 10, 3, 2),         # sliding window + sinks
    (2, 9, 3, None, 4, 0),        # window, no mask
])
def test_causal_mask_static_kv_matches_jax(seq_len, cap, start, mask_len,
                                           window, sinks):
    rng = np.random.default_rng(seq_len * 100 + cap)
    am = None if mask_len is None else rng.integers(0, 2, (3, mask_len))
    want = np.asarray(jmasks.causal_mask_static_kv(
        seq_len, cap, start, None if am is None else jnp.asarray(am),
        batch_size=3, window=window, sinks=sinks))
    got = tmasks.causal_mask_static_kv(
        seq_len, cap, start, None if am is None else torch.from_numpy(am),
        batch_size=3, window=window, sinks=sinks)
    assert tuple(got.shape) == want.shape == (3, 1, seq_len, cap)
    np.testing.assert_array_equal(got.numpy(), want)


# -- DecoderModel with a cache -------------------------------------------------------

def _jax_cached_steps(jmodel, params, ids, mask, steps, max_len):
    """Prefill, then ``steps`` greedy cached steps, in JAX at fp64:
    (per-call logits, the tokens fed, the final cache)."""
    with jax.enable_x64(True):
        jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                    params)
        cache = jmodel.init_cache(batch_size=ids.shape[0], max_len=max_len,
                                  dtype=jnp.float64)
        out = jmodel.apply(jp, jnp.asarray(ids), jnp.asarray(mask),
                           cache=cache, start_pos=0)
        logits, fed = [np.asarray(out.logits)], []
        cache, pos = out.kv_cache, ids.shape[1]
        for _ in range(steps):
            tok = np.asarray(out.logits[:, -1]).argmax(-1)[:, None]
            fed.append(tok)
            out = jmodel.apply(jp, jnp.asarray(tok), cache=cache,
                               start_pos=pos)
            cache, pos = out.kv_cache, pos + 1
            logits.append(np.asarray(out.logits))
        cache = {k: np.asarray(v) for k, v in cache.items()}
    return logits, fed, cache


@pytest.mark.parametrize("pe,at", VARIANTS)
def test_cached_prefill_and_steps_match_jax_fp64(pe, at):
    """A left-padded prefill and 4 cached steps: every call's logits and
    the cache's contents and length at fp64."""
    jmodel, params, tmodel = _models(pe, at, dtype=np.float64)
    ids = _prompt(1, l=9)
    mask = np.ones_like(ids)
    mask[1, :3] = 0
    logits, fed, jcache = _jax_cached_steps(jmodel, params, ids, mask, 4, 20)
    cache = tmodel.init_cache(batch_size=2, max_len=20)
    assert cache["k"].dtype == torch.float64
    with torch.no_grad():
        out = tmodel(torch.from_numpy(ids), torch.from_numpy(mask),
                     cache=cache, start_pos=0)
        got = [out.logits.numpy()]
        cache, pos = out.kv_cache, ids.shape[1]
        for tok in fed:
            out = tmodel(torch.from_numpy(tok), cache=cache, start_pos=pos)
            cache, pos = out.kv_cache, pos + 1
            got.append(out.logits.numpy())
    for g, w in zip(got, logits):
        np.testing.assert_allclose(g, w, atol=LOGIT_ATOL, rtol=0)
    assert cache["length"] == int(jcache["length"]) == 13
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), jcache[name],
                                   atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("pe,at", [("rope", "gqa"), ("absolute", None)])
def test_cached_step_argmax_matches_jax_fp32(pe, at):
    """fp32: the argmax of a prefill and 3 cached steps fed the JAX
    tokens, away from near-ties (``tests/test_parity_torch.py``'s
    method)."""
    jmodel, params, tmodel = _models(pe, at, seed=3)
    ids = _prompt(4, b=3, l=10)
    cache = jmodel.init_cache(batch_size=3, max_len=16)
    tcache = tmodel.init_cache(batch_size=3, max_len=16)
    feed, pos = jnp.asarray(ids), 0
    for _ in range(4):
        out = jmodel.apply(params, feed, cache=cache, start_pos=pos)
        want = np.asarray(out.logits)
        with torch.no_grad():
            got = tmodel(torch.from_numpy(np.array(feed)), cache=tcache,
                         start_pos=pos).logits.numpy()
        top2 = np.sort(want, axis=-1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > 1e-5
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(got.argmax(-1)[clear],
                                      want.argmax(-1)[clear])
        pos += feed.shape[1]
        cache = out.kv_cache
        feed = jnp.asarray(want[:, -1].argmax(-1)[:, None])


# -- DecoderModel.generate ----------------------------------------------------------

def _generate_both(pe, at, ids, mask=None, cfg=CFG, **kw):
    jmodel, params, tmodel = _models(pe, at, seed=5, cfg=cfg)
    want = np.asarray(jmodel.generate(
        params, jnp.asarray(ids),
        None if mask is None else jnp.asarray(mask), **kw))
    got = tmodel.generate(torch.from_numpy(ids),
                          None if mask is None else torch.from_numpy(mask),
                          **kw)
    return got.numpy(), want


@pytest.mark.parametrize("use_cache", [True, False])
@pytest.mark.parametrize("pe,at", [("rope", "gqa"), ("absolute", None),
                                   ("sinusoidal", "gqa")])
def test_generate_greedy_matches_jax(pe, at, use_cache):
    got, want = _generate_both(pe, at, _prompt(6), max_len=8,
                               use_cache=use_cache)
    np.testing.assert_array_equal(got, want)


def _eos_for_both_lanes(pe, at, ids):
    """A token that both lanes emit greedily (at different steps), so eos
    on it ends every lane before the buffer is full."""
    got, _ = _generate_both(pe, at, ids, max_len=12)
    gen = got[:, ids.shape[1]:]
    common = sorted(set(gen[0].tolist()) & set(gen[1].tolist()))
    return common


@pytest.mark.parametrize("use_cache", [True, False])
def test_generate_eos_early_exit_matches_jax(use_cache):
    """eos on a token both lanes reach: the JAX loop stops once every lane
    has it and leaves pad after; the port runs every step and writes the
    same pad."""
    ids = _prompt(8)     # both lanes emit token 0 (steps 3 and 2)
    common = _eos_for_both_lanes("rope", "gqa", ids)
    assert common, "no token shared by both lanes: pick another prompt"
    cfg = CFG.replace(eos_token_id=common[0])
    got, want = _generate_both("rope", "gqa", ids, cfg=cfg, max_len=12,
                               use_cache=use_cache)
    np.testing.assert_array_equal(got, want)
    tail = want[:, -1]
    assert (tail == CFG.pad_token_id).all(), "the loop did not stop early"


def test_generate_left_padded_batch_matches_jax_xla_route():
    """A left-padded batch on the CPU's ``"xla"`` route in both packages
    (the cached steps attend the pads, quirk (b))."""
    ids = _prompt(8, l=9)
    mask = np.ones_like(ids)
    mask[0, :4] = 0
    ids[0, :4] = CFG.pad_token_id
    for use_cache in (True, False):
        got, want = _generate_both("rope", "gqa", ids, mask, max_len=6,
                                   use_cache=use_cache)
        np.testing.assert_array_equal(got, want)


def test_generate_checks_the_position_table():
    _, _, tmodel = _models("absolute", None)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        tmodel.generate(torch.ones(1, 60, dtype=torch.long), max_len=5)


def test_generate_rejects_a_dynamic_cache():
    _, _, tmodel = _models("rope", "gqa")
    with pytest.raises(ValueError, match="only cache"):
        tmodel.generate(torch.ones(1, 4, dtype=torch.long), max_len=2,
                        use_static_cache=False)


def test_cache_write_rejects_another_dtype():
    """A layer writes its k/v into the cache uncast: a cache of another
    dtype raises instead of converting the whole buffer every step."""
    _, _, tmodel = _models("rope", "gqa")
    cache = tkv.init_cache(TCFG, max_len=8, num_kv_heads=2,
                           dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="cache holds torch.float64"):
        tmodel(torch.ones(1, 4, dtype=torch.long), cache=cache, start_pos=0)


def test_generate_sampling_is_seeded():
    """Sampled runs draw from the generator: the same seed gives the same
    tokens (``jax.random`` cannot be reproduced, so not JAX's)."""
    _, _, tmodel = _models("rope", "gqa")
    ids = torch.from_numpy(_prompt(9))

    def run(seed, use_cache=True):
        g = torch.Generator().manual_seed(seed)
        return tmodel.generate(ids, max_len=10, do_sample=True,
                               temperature=0.7, generator=g,
                               use_cache=use_cache)
    a, b = run(11), run(11)
    assert torch.equal(a, b)
    assert torch.equal(a, run(11, use_cache=False))
    assert not all(torch.equal(a, run(s)) for s in (12, 13, 14))


# -- processors and penalties ---------------------------------------------------------

def _logits(seed=0, b=3, v=50):
    return np.random.default_rng(seed).normal(0, 2, (b, v)).astype(
        np.float32)


PROCESSORS = [
    ("GreedyProcessor", (1.0,)), ("MultinomialProcessor", (0.8,)),
    ("TopKProcessor", (0.7, 5)), ("NucleusProcessor", (1.3, 0.6)),
    ("TopKNucleusProcessor", (0.9, 8, 0.5)), ("MinPProcessor", (1.1, 0.2)),
]


@pytest.mark.parametrize("name,args", PROCESSORS)
def test_processors_match_jax(name, args):
    x = _logits(1)
    want = np.asarray(getattr(jsamp, name)(*args)(jnp.asarray(x)))
    proc = getattr(tt, name)(*args)
    got = proc(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    g = torch.Generator().manual_seed(0)
    draw = proc.sample(torch.from_numpy(got), g)
    assert tuple(draw.shape) == (3, 1)
    assert (got[np.arange(3), draw[:, 0].numpy()] > 0).all()
    if name == "GreedyProcessor":
        np.testing.assert_array_equal(draw[:, 0].numpy(), got.argmax(-1))


@pytest.mark.parametrize("penalty", [1.0, 1.3, 0.8])
def test_repetition_penalty_matches_jax(penalty):
    x = _logits(2)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 50, (3, 12)).astype(np.int32)
    valid = (np.arange(12)[None] < np.array([[12], [5], [0]])).astype(
        np.int32)
    for v in (None, valid):
        want = np.asarray(jsamp.apply_repetition_penalty(
            jnp.asarray(x), jnp.asarray(ids), penalty,
            None if v is None else jnp.asarray(v)))
        got = tsamp.apply_repetition_penalty(
            torch.from_numpy(x), torch.from_numpy(ids), penalty,
            None if v is None else torch.from_numpy(v))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,cur_len", [(2, 9), (3, 12), (3, 1), (4, 14),
                                       (2, 20)])
def test_no_repeat_ngram_matches_jax(n, cur_len):
    x = _logits(4, b=2, v=8)
    rng = np.random.default_rng(n * 10 + cur_len)
    buf = rng.integers(0, 4, (2, 20)).astype(np.int32)   # many repeats
    want = np.asarray(jsamp.apply_no_repeat_ngram(
        jnp.asarray(x), jnp.asarray(buf), cur_len, n))
    got = tsamp.apply_no_repeat_ngram(torch.from_numpy(x),
                                      torch.from_numpy(buf), cur_len, n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_suppress_forced_min_new_tokens_match_jax():
    x = _logits(5)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    cases = [
        (jsamp.apply_suppress_tokens(jx, [3, 7, 49]),
         tsamp.apply_suppress_tokens(tx, [3, 7, 49])),
        (jsamp.apply_forced_token(jx, 11, True),
         tsamp.apply_forced_token(tx, 11, True)),
        (jsamp.apply_forced_token(jx, 11, False),
         tsamp.apply_forced_token(tx, 11, False)),
    ]
    for eos in (4, (4, 9), -1):
        for new_len in (0, 2, 3):
            cases.append((jsamp.apply_min_new_tokens(jx, eos, new_len, 3),
                          tsamp.apply_min_new_tokens(tx, eos, new_len, 3)))
    for want, got in cases:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("top_k", [1, 4, 50, 80])
def test_top_k_mask_matches_jax(top_k):
    x = _logits(6)
    np.testing.assert_array_equal(
        tsamp._top_k_mask(torch.from_numpy(x), top_k).numpy(),
        np.asarray(jsamp._top_k_mask(jnp.asarray(x), top_k)))
