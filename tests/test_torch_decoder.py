"""Parity of the port's ``DecoderModel`` with the JAX package's.

The same params (``decoder_params_from_jax``) and the same numpy batch go
through both packages, on the ``"xla"`` route in both (fully-masked rows
are route-defined, and the batch has pad-mask zeros): logits and hidden
states at fp64 with atol 1e-4 for all of {absolute, sinusoidal, rope} x
{mha, gqa}, argmax at fp32. The port's own switches (flash route, remat,
dropout with a generator, the options that raise) are checked against the
port itself."""

from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vyomai_tpu as vt
from vyomai_tpu.core import masks as jmasks
from vyomai_tpu.layers import attention as jattn

import vyomai_tpu_torch as tt
from vyomai_tpu_torch.core import masks as tmasks
from vyomai_tpu_torch.interop import decoder_params_from_jax
from vyomai_tpu_torch.layers.attention import set_sdpa_impl

torch.set_num_threads(1)

CFG = vt.EncoderConfig(hidden_size=64, num_attention_heads=4,
                       num_key_value_heads=2, num_hidden_layers=2,
                       vocab_size=128, max_position_embeddings=64,
                       intermediate_size=256, hidden_dropout_prob=0.0)
TCFG = tt.EncoderConfig(**{f.name: getattr(CFG, f.name)
                           for f in fields(CFG)})
VARIANTS = [(pe, at) for pe in ("absolute", "sinusoidal", "rope")
            for at in (None, "gqa")]
LOGIT_ATOL = 1e-4   # fp64 (ROADMAP ground rule, tests/test_parity_torch.py)


def _batch(seed=0, b=2, l=24):
    """Token ids with pad id 1 inside, and a mask with a padded tail and
    a padded first position (a fully-masked row on both routes)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, CFG.vocab_size, (b, l)).astype(np.int32)
    ids[0, 5] = ids[1, 9] = CFG.pad_token_id
    mask = np.ones((b, l), np.int32)
    mask[1, 17:] = 0
    mask[0, 0] = 0
    return ids, mask


@pytest.fixture(scope="module", autouse=True)
def _xla_route():
    jattn.set_sdpa_impl("xla")
    set_sdpa_impl("xla")
    yield
    jattn.set_sdpa_impl("auto")
    set_sdpa_impl("auto")


def _jax(pe, at, seed=0):
    model = vt.DecoderModel(CFG, pos_embedding_type=pe, attention_type=at)
    return model, model.init(jax.random.PRNGKey(seed))


def _np_tree(params, dtype):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, dtype), params)


@pytest.mark.parametrize("pe,at", VARIANTS)
def test_logits_match_jax_fp64(pe, at):
    model, params = _jax(pe, at)
    ids, mask = _batch()
    with jax.enable_x64(True):
        jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                    _np_tree(params, np.float64))
        jout = model.apply(jp, jnp.asarray(ids), jnp.asarray(mask))
        want_logits = np.asarray(jout.logits)
        want_hidden = np.asarray(jout.hidden_state)
    tmodel = decoder_params_from_jax(_np_tree(params, np.float64), TCFG, pe,
                                     at, device="cpu")
    assert tmodel.dtype == torch.float64
    with torch.no_grad():
        out = tmodel(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(out.logits.numpy(), want_logits,
                               atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(out.hidden_state.numpy(), want_hidden,
                               atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("pe,at", [("rope", "gqa"), ("absolute", None)])
def test_argmax_matches_jax_fp32(pe, at):
    model, params = _jax(pe, at, seed=3)
    ids, mask = _batch(1)
    want = np.asarray(model.apply(params, jnp.asarray(ids),
                                  jnp.asarray(mask)).logits)
    tmodel = decoder_params_from_jax(_np_tree(params, np.float32), TCFG, pe,
                                     at, device="cpu")
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long(),
                     torch.from_numpy(mask)).logits.numpy()
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-5   # no near-ties
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


def _torch_model(pe="rope", at="gqa", remat=False, dtype=torch.float64):
    cfg = TCFG.replace(hidden_dropout_prob=0.1)
    m = tt.DecoderModel(cfg, pe, at, remat=remat, device="cpu", dtype=dtype)
    return m.init(torch.Generator().manual_seed(4))


def test_flash_route_matches_xla_route_off_masked_rows():
    """On the CPU the flash route runs the kernels' plain versions; rows
    that see at least one key agree with the ``"xla"`` route."""
    ids, mask = (torch.from_numpy(x).long() for x in _batch(2))
    model = _torch_model()
    with torch.no_grad():
        xla = model(ids, mask).hidden_state
        set_sdpa_impl("flash")
        try:
            flash = model(ids, mask).hidden_state
        finally:
            set_sdpa_impl("xla")
    # row 0 position 0 is fully masked: layer 2 reads it, so compare the
    # rows of sequence 1 (no leading pad)
    torch.testing.assert_close(flash[1], xla[1], atol=1e-10, rtol=0)


def _loss_and_grads(model, ids, mask, **kw):
    model.zero_grad(set_to_none=True)
    out = model(ids, mask, **kw)
    loss = out.logits.square().mean()
    loss.backward()
    return loss.detach(), [p.grad.clone() for p in model.parameters()]


def test_remat_gives_the_same_loss_and_grads():
    ids, mask = (torch.from_numpy(x).long() for x in _batch(3))
    plain = _torch_model()
    remat = _torch_model(remat=True)
    la, ga = _loss_and_grads(plain, ids, mask)
    lb, gb = _loss_and_grads(remat, ids, mask)
    assert torch.equal(la, lb)
    for a, b in zip(ga, gb):
        torch.testing.assert_close(a, b, atol=1e-14, rtol=0)


def test_remat_with_dropout_replays_the_masks():
    """Same seed, same dropout masks: remat recomputes each layer with the
    forward's masks, and the generator ends where the forward left it."""
    ids, mask = (torch.from_numpy(x).long() for x in _batch(4))
    plain = _torch_model()
    remat = _torch_model(remat=True)
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    la, ga = _loss_and_grads(plain, ids, mask, deterministic=False,
                             generator=g1)
    lb, gb = _loss_and_grads(remat, ids, mask, deterministic=False,
                             generator=g2)
    assert torch.equal(la, lb)
    for a, b in zip(ga, gb):
        torch.testing.assert_close(a, b, atol=1e-14, rtol=0)
    assert torch.equal(g1.get_state(), g2.get_state())
    with torch.no_grad():
        det = plain(ids, mask).logits
    assert not torch.allclose(det, plain(ids, mask, deterministic=False,
                                         generator=g1).logits)


def test_unported_options_raise():
    ids = torch.ones(1, 4, dtype=torch.long)
    model = _torch_model()
    with pytest.raises(NotImplementedError):
        tt.DecoderModel(TCFG, "rope", "gqa", remat="dots", device="cpu")
    with pytest.raises(NotImplementedError):
        model(ids, segment_ids=ids)
    with pytest.raises(NotImplementedError):
        model(ids, cache=model.init_cache(max_len=8), positions=ids)
    with pytest.raises(ValueError):
        set_sdpa_impl("nope")
    with pytest.raises(ValueError):
        model(ids, deterministic=False)


@pytest.mark.parametrize("pe,at", VARIANTS)
def test_param_count_and_init_match_jax(pe, at):
    _, params = _jax(pe, at)
    n_jax = sum(x.size for x in jax.tree_util.tree_leaves(params))
    model = tt.DecoderModel(TCFG, pe, at, device="cpu").init(
        torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert torch.all(model.word_embeddings.weight[TCFG.pad_token_id] == 0)
    w = model.layers[0].attention.query.weight
    assert abs(float(w.detach().std()) - 0.02) < 0.005
    assert torch.all(model.layers[1].ffn.layernorm.weight == 1)
    assert torch.all(model.lm_head.decoder.bias == 0)


@pytest.mark.parametrize("seq_len,start_pos,with_pad,batch", [
    (5, 0, False, 1), (4, 3, True, 2), (6, 2, False, 3)])
def test_masks_match_jax(seq_len, start_pos, with_pad, batch):
    """``additive``, ``bidirectional_mask`` and ``causal_mask`` give the
    JAX package's values bit for bit (0 / NEG_INF)."""
    pad = np.ones((2, start_pos + seq_len), np.int32)
    pad[1, -2:] = 0
    pad[0, 0] = 0
    np.testing.assert_array_equal(
        tmasks.bidirectional_mask(torch.from_numpy(pad)).numpy(),
        np.asarray(jmasks.bidirectional_mask(jnp.asarray(pad))))
    want = jmasks.causal_mask(seq_len, jnp.asarray(pad) if with_pad else
                              None, start_pos, batch_size=batch)
    got = tmasks.causal_mask(seq_len, torch.from_numpy(pad) if with_pad
                             else None, start_pos, batch_size=batch)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
