"""The port's dense ``ModelForCausalLM`` and its free-function generation
loops against the JAX package.

The same JAX-initialised params (``params_from_jax``; quantized trees from
``quantize_params``) and numpy prompts go through both packages on the
CPU. Tolerances: logits at fp64 within atol 1e-4 (as
``tests/test_torch_serving.py``); greedy tokens exact at fp32. Sampled
runs cannot reproduce ``jax.random``: they are held to seeded
determinism."""

from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vyomai_tpu as vt
import vyomai_tpu.generation as jgen

import vyomai_tpu_torch as tt
from vyomai_tpu_torch.interop import params_from_jax
from vyomai_tpu_torch.layers.attention import set_sdpa_impl

torch.set_num_threads(1)

QCFG = vt.QwenConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, head_dim=32,
                     max_position_embeddings=256, qk_norm=True,
                     eos_token_id=9999, tie_word_embeddings=True)
LOGIT_ATOL = 1e-4   # fp64, as tests/test_torch_serving.py


def _tcfg(cfg):
    return tt.QwenConfig(**{f.name: getattr(cfg, f.name)
                            for f in fields(cfg)})


def _np(tree, dtype=None):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if dtype is None or x.dtype.kind != "f"
        else np.asarray(x, dtype), tree)


def _models(cfg=QCFG, seed=2, quant=None):
    """(JAX model, JAX params, port model) at fp32; ``quant``:
    ``quantize_params`` options."""
    jmodel = vt.ModelForCausalLM(cfg)
    params = jmodel.init(jax.random.PRNGKey(seed), dtype=jnp.float32)
    if quant is not None:
        params = vt.quantize_params(params, **quant)
    return jmodel, params, params_from_jax(_np(params), _tcfg(cfg),
                                           device="cpu")


@pytest.fixture(scope="module")
def models():
    return _models()


def _prompt(seed=0, b=2, l=6):
    rng = np.random.default_rng(seed)
    return rng.integers(0, QCFG.vocab_size, (b, l)).astype(np.int32)


# -- the forward ----------------------------------------------------------------

@pytest.mark.parametrize("qk_norm", [True, False])
@pytest.mark.parametrize("tied", [True, False])
def test_forward_matches_jax_fp64(qk_norm, tied):
    """Uncached with a pad mask; cached: a left-padded prefill and 3
    steps. Logits at fp64, and the cache's contents."""
    cfg = QCFG.replace(qk_norm=qk_norm, tie_word_embeddings=tied)
    jmodel = vt.ModelForCausalLM(cfg)
    with jax.enable_x64(True):
        params = jmodel.init(jax.random.PRNGKey(3), dtype=jnp.float64)
        tmodel = params_from_jax(_np(params), _tcfg(cfg), device="cpu")
        assert tmodel.dtype == torch.float64
        ids = _prompt(1, l=8)
        mask = np.ones_like(ids)
        mask[1, :2] = 0
        want = [np.asarray(jmodel.apply(params, jnp.asarray(ids),
                                        jnp.asarray(mask)).logits)]
        cache = jmodel.init_cache(batch_size=2, max_len=12,
                                  dtype=jnp.float64)
        out = jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask),
                           cache=cache, start_pos=0)
        want.append(np.asarray(out.logits))
        fed = []
        for pos in range(8, 11):
            tok = np.asarray(out.logits[:, -1]).argmax(-1)[:, None]
            fed.append(tok.astype(np.int32))
            out = jmodel.apply(params, jnp.asarray(tok), cache=out.kv_cache,
                               start_pos=pos)
            want.append(np.asarray(out.logits))
        jcache = {k: np.asarray(v) for k, v in out.kv_cache.items()}
    with torch.no_grad():
        t_ids, t_mask = torch.from_numpy(ids), torch.from_numpy(mask)
        got = [tmodel(t_ids, t_mask).logits]
        cache = tmodel.init_cache(batch_size=2, max_len=12)
        out = tmodel(t_ids, t_mask, cache=cache, start_pos=0)
        got.append(out.logits)
        for pos, tok in zip(range(8, 11), fed):
            out = tmodel(torch.from_numpy(tok), cache=out.kv_cache,
                         start_pos=pos)
            got.append(out.logits)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=LOGIT_ATOL, rtol=0)
    assert out.kv_cache["length"] == int(jcache["length"]) == 11
    for name in ("k", "v"):
        np.testing.assert_allclose(out.kv_cache[name].numpy(), jcache[name],
                                   atol=LOGIT_ATOL, rtol=0)


def test_forward_flash_route_matches_xla_route(models):
    """On the CPU the flash route runs K1's plain version: with all-valid
    masks (no fully masked rows) it agrees with the ``"xla"`` route, with
    and without a cache."""
    _, _, tmodel = models
    ids = torch.from_numpy(_prompt(2, l=9))
    outs = {}
    for impl in ("xla", "flash"):
        set_sdpa_impl(impl)
        try:
            with torch.no_grad():
                cache = tmodel.init_cache(batch_size=2, max_len=12)
                outs[impl] = (tmodel(ids).logits,
                              tmodel(ids, cache=cache).logits)
        finally:
            set_sdpa_impl("auto")
    for a, b in zip(outs["xla"], outs["flash"]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_packed_inputs_are_unported(models):
    ids = torch.ones(1, 4, dtype=torch.long)
    with pytest.raises(NotImplementedError):
        models[2](ids, segment_ids=ids)


# -- generate and generate_hf -------------------------------------------------------

@pytest.mark.parametrize("use_cache", [True, False])
def test_generate_greedy_matches_jax(models, use_cache):
    jmodel, params, tmodel = models
    ids = _prompt(3)
    want = np.asarray(jgen.generate(jmodel, params, jnp.asarray(ids),
                                    max_new_tokens=7, use_cache=use_cache))
    got = tt.generate(tmodel, torch.from_numpy(ids), max_new_tokens=7,
                      use_cache=use_cache)
    np.testing.assert_array_equal(got.numpy(), want)
    zero = tt.generate(tmodel, torch.from_numpy(ids), max_new_tokens=0,
                       use_cache=use_cache)
    np.testing.assert_array_equal(zero.numpy(), ids)


def _greedy_run(tmodel, ids, n=10):
    return tt.generate_hf(tmodel, torch.from_numpy(ids),
                          max_new_tokens=n).numpy()[:, ids.shape[1]:]


HF_CASES = {
    "greedy": {},
    "repetition_penalty": dict(repetition_penalty=1.8),
    "no_repeat_ngram": dict(no_repeat_ngram_size=2),
    "penalty_and_ngram": dict(repetition_penalty=0.7,
                              no_repeat_ngram_size=3),
    "max_new_tokens_0": dict(max_new_tokens=0),
}


@pytest.mark.parametrize("case", sorted(HF_CASES))
def test_generate_hf_greedy_matches_jax(models, case):
    jmodel, params, tmodel = models
    ids = _prompt(4)
    kw = {"max_new_tokens": 10, **HF_CASES[case]}
    want = np.asarray(jgen.generate_hf(jmodel, params, jnp.asarray(ids),
                                       **kw))
    got = tt.generate_hf(tmodel, torch.from_numpy(ids), **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if case != "greedy" and case != "max_new_tokens_0":
        assert not np.array_equal(want, np.asarray(jgen.generate_hf(
            jmodel, params, jnp.asarray(ids), max_new_tokens=10))), \
            "the option changed nothing: it is not exercised"


@pytest.mark.parametrize("case", ["per_lane", "all_lanes", "min_new_tokens",
                                  "eos_list"])
def test_generate_hf_eos_matches_jax(models, case):
    """Per-lane eos: a finished lane emits pad; the JAX loop stops once
    every lane is done, the port's runs on and emits pad, the same
    tokens."""
    jmodel, params, tmodel = models
    ids = _prompt(5)
    free = _greedy_run(tmodel, ids)
    if case == "per_lane":          # lane 0's third token
        eos, kw = int(free[0, 2]), {}
    elif case == "all_lanes":       # lane 1's second and lane 0's third
        eos, kw = [int(free[1, 1]), int(free[0, 2])], {}
    elif case == "min_new_tokens":  # lane 0's second, banned for 4 tokens
        eos, kw = int(free[0, 1]), dict(min_new_tokens=4)
    else:
        eos, kw = [9998, int(free[1, 3])], {}
    kw.update(max_new_tokens=10, eos_token_id=eos, pad_token_id=7)
    want = np.asarray(jgen.generate_hf(jmodel, params, jnp.asarray(ids),
                                       **kw))
    got = tt.generate_hf(tmodel, torch.from_numpy(ids), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "min_new_tokens":     # eos suppressed at lane 0's 2nd token
        assert want[0, ids.shape[1] + 1] != eos
    else:
        assert (want[:, -1] == 7).any(), "no lane stopped"
    if case == "all_lanes":
        assert (want[:, -3:] == 7).all(), "every lane should have stopped"


def test_generate_hf_sampling_is_seeded(models):
    _, _, tmodel = models
    ids = torch.from_numpy(_prompt(6))

    def run(seed, **kw):
        return tt.generate_hf(tmodel, ids, max_new_tokens=8, do_sample=True,
                              temperature=0.9, top_k=40, top_p=0.9,
                              min_p=0.05, repetition_penalty=1.1,
                              generator=torch.Generator().manual_seed(seed),
                              **kw)
    a = run(1)
    assert torch.equal(a, run(1))
    assert not all(torch.equal(a, run(s)) for s in (2, 3, 4))
    # temperature 0 with sampling is greedy (the 1e-6 clamp)
    cold = tt.generate_hf(tmodel, ids, max_new_tokens=8, do_sample=True,
                          temperature=0.0,
                          generator=torch.Generator().manual_seed(0))
    assert torch.equal(cold, tt.generate_hf(tmodel, ids, max_new_tokens=8))
    g = tt.generate(tmodel, ids, max_new_tokens=5, do_sample=True,
                    use_cache=True, temperature=0.0)
    assert torch.equal(g, tt.generate(tmodel, ids, max_new_tokens=5,
                                      use_cache=True))


@pytest.mark.parametrize("quant", [dict(bits=8), dict(bits=4, group_size=32)])
def test_quantized_generate_hf_matches_jax(quant):
    """Trees from the JAX ``quantize_params`` bridged into the port:
    greedy tokens equal to JAX's (generate_hf and cached generate)."""
    jmodel, params, tmodel = _models(seed=4, quant=quant)
    kinds = {type(m).__name__ for m in tmodel.modules()}
    assert ("Int4Linear" if quant["bits"] == 4 else "Int8Linear") in kinds
    assert tmodel.dtype == torch.float32
    ids = _prompt(7)
    want = np.asarray(jgen.generate_hf(jmodel, params, jnp.asarray(ids),
                                       max_new_tokens=8))
    got = tt.generate_hf(tmodel, torch.from_numpy(ids), max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jgen.generate(jmodel, params, jnp.asarray(ids),
                                    max_new_tokens=6, use_cache=True))
    got = tt.generate(tmodel, torch.from_numpy(ids), max_new_tokens=6,
                      use_cache=True)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_seq2seq_and_multimodel_are_unported():
    with pytest.raises(NotImplementedError, match="item 7"):
        tt.generate_seq2seq(None, None)
    with pytest.raises(NotImplementedError, match="item 7"):
        tt.generate_multimodel(None, None)


# -- generate_until -----------------------------------------------------------------

class _CharTokenizer:
    """id i <-> the letter ``chr(97 + i % 26)``; a one-letter text is one
    id."""

    def __call__(self, text):
        return [ord(c) - 97 for c in text]

    def decode(self, ids):
        return "".join(chr(97 + int(i) % 26) for i in ids)


@pytest.mark.parametrize("stop", ["keyword_id", "substring", "eos", "none"])
def test_generate_until_matches_jax(models, stop):
    jmodel, params, tmodel = models
    ids = _prompt(8, b=1)
    free = _greedy_run(tmodel, ids, n=12)[0]
    tok = _CharTokenizer()
    kw = dict(max_new_tokens=12)
    keywords = None
    if stop == "keyword_id":     # a single-id keyword: the 5th token
        keywords = [chr(97 + int(free[4]))] if free[4] < 26 else None
        kw["eos_token_id"] = int(free[4])   # same stop if not a letter
    elif stop == "substring":    # the 4th and 5th tokens' letters
        keywords = [tok.decode(free[3:5])]
    elif stop == "eos":
        kw["eos_token_id"] = int(free[6])
    results = []
    for pkg, model_args, crit_cls, run in (
            ("jax", (jmodel, params), jgen.KeywordsStoppingCriteria,
             jgen.generate_until),
            ("torch", (tmodel,), tt.KeywordsStoppingCriteria,
             tt.generate_until)):
        crit = None if keywords is None else crit_cls(keywords, tok, ids)
        x = jnp.asarray(ids) if pkg == "jax" else torch.from_numpy(ids)
        results.append(np.asarray(run(*model_args, x,
                                      stopping_criteria=crit, **kw)))
    want, got = results
    np.testing.assert_array_equal(got, want)
    if stop == "none":
        assert want.shape[1] == ids.shape[1] + 12
    else:
        assert want.shape[1] < ids.shape[1] + 12, "the stop never fired"
