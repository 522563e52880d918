"""Parity of the port's encoder family (``EncoderModel``,
``EncoderForMaskedLM``, ``Vit``) with the JAX package's.

The same params (``encoder_params_from_jax``, ``vit_params_from_jax``) and
the same numpy inputs go through both packages on the ``"xla"`` route at
fp64, atol 1e-4 (the ROADMAP's fp64 rule, as ``test_torch_decoder.py``):
outputs for {absolute, sinusoidal, rope} x {mha, gqa}, ViT with and without
a mask, and one MLM and one ViT train step's loss and gradients against
``jax.value_and_grad``. The port's own routes (``"short"`` on the plain
versions of K5/K6/K7, ``"xla"``, the CPU's packed ViT path), dropout
replayed under ``remat=True``, the bridges' round trip and a 3-step
``encoder_bench`` run at tiny width are checked against the port itself.
Widths: hidden 128, 4 heads (head_dim 32, which the short route takes), 2
layers."""

from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vyomai_tpu as vt
from vyomai_tpu.layers import attention as jattn
from vyomai_tpu.ops.fused import cross_entropy as j_cross_entropy

import vyomai_tpu_torch as tt
from vyomai_tpu_torch import encoder_bench as eb
from vyomai_tpu_torch.interop import (encoder_params_from_jax,
                                      tree_from_torch, vit_params_from_jax)
from vyomai_tpu_torch.layers.attention import set_sdpa_impl
from vyomai_tpu_torch.ops import short_attention as sa

torch.set_num_threads(1)

CFG = vt.EncoderConfig(hidden_size=128, num_attention_heads=4,
                       num_key_value_heads=2, num_hidden_layers=2,
                       vocab_size=128, max_position_embeddings=64,
                       intermediate_size=512, hidden_dropout_prob=0.0)
VCFG = vt.VisionConfig(image_size=(32, 32), patch_size=(8, 8),
                       hidden_size=128, num_attention_heads=4,
                       num_hidden_layers=2, hidden_dropout_prob=0.0)
TCFG = tt.EncoderConfig(**{f.name: getattr(CFG, f.name)
                           for f in fields(CFG)})
TVCFG = tt.VisionConfig(**{f.name: getattr(VCFG, f.name)
                           for f in fields(VCFG)})
VARIANTS = [(pe, at) for pe in ("absolute", "sinusoidal", "rope")
            for at in (None, "gqa")]
ATOL = 1e-4    # fp64 (ROADMAP ground rule, tests/test_parity_torch.py)
GRAD_RTOL_OF_MAX = 1e-6   # fp64 gradients, each tensor's largest value


def _batch(seed=0, b=3, l=24):
    """Token ids with pad id 1 inside, and a right-padded mask whose last
    row has no key at all (a fully padded row: the mean of V on the
    "xla" and short routes alike)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, CFG.vocab_size, (b, l)).astype(np.int64)
    ids[0, 5] = ids[1, 9] = CFG.pad_token_id
    mask = np.ones((b, l), np.int64)
    mask[1, 17:] = 0
    mask[2] = 0
    return ids, mask


def _images(seed=0, b=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, VCFG.num_channels, *VCFG.image_size))


@pytest.fixture(scope="module", autouse=True)
def _xla_route():
    jattn.set_sdpa_impl("xla")
    set_sdpa_impl("xla")
    yield
    jattn.set_sdpa_impl("auto")
    set_sdpa_impl("auto")


def _np_tree(params, dtype):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, dtype), params)


def _jax64(params):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                  _np_tree(params, np.float64))


def _mlm(pe="rope", at="gqa", seed=0):
    model = vt.EncoderForMaskedLM(CFG, pos_embedding_type=pe,
                                  attention_type=at)
    return model, model.init(jax.random.PRNGKey(seed))


def _vit(seed=0):
    model = vt.Vit(VCFG)
    return model, model.init(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("pe,at", VARIANTS)
def test_mlm_matches_jax_fp64(pe, at):
    model, params = _mlm(pe, at)
    ids, mask = _batch()
    with jax.enable_x64(True):
        jout = model.apply(_jax64(params), jnp.asarray(ids),
                           jnp.asarray(mask))
        want_logits = np.asarray(jout.logits)
        want_hidden = np.asarray(jout.hidden_state)
    tmodel = encoder_params_from_jax(_np_tree(params, np.float64), TCFG, pe,
                                     at, device="cpu")
    assert isinstance(tmodel, tt.EncoderForMaskedLM)
    assert tmodel.dtype == torch.float64
    with torch.no_grad():
        out = tmodel(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(out.logits.numpy(), want_logits, atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(out.hidden_state.numpy(), want_hidden,
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("pe,at", [("absolute", None), ("rope", "gqa")])
def test_encoder_model_matches_jax_fp64(pe, at):
    """The bare encoder, with and without an attention mask (without one
    it builds an all-ones mask, as the JAX model does)."""
    model = vt.EncoderModel(CFG, pos_embedding_type=pe, attention_type=at)
    params = model.init(jax.random.PRNGKey(2))
    ids, mask = _batch(1)
    tmodel = encoder_params_from_jax(_np_tree(params, np.float64), TCFG, pe,
                                     at, device="cpu")
    assert isinstance(tmodel, tt.EncoderModel)
    for m in (mask, None):
        with jax.enable_x64(True):
            want = np.asarray(model.apply(
                _jax64(params), jnp.asarray(ids),
                None if m is None else jnp.asarray(m)).logits)
        with torch.no_grad():
            got = tmodel(torch.from_numpy(ids),
                         None if m is None else torch.from_numpy(m)).logits
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("with_mask", [False, True])
def test_vit_matches_jax_fp64(with_mask):
    model, params = _vit()
    images = _images()
    n = VCFG.num_patches + 1
    mask = np.ones((2, n), np.int64)
    mask[1, 11:] = 0
    with jax.enable_x64(True):
        want = np.asarray(model.apply(
            _jax64(params), jnp.asarray(images),
            jnp.asarray(mask) if with_mask else None).logits)
    tmodel = vit_params_from_jax(_np_tree(params, np.float64), TVCFG,
                                 device="cpu")
    assert tmodel.dtype == torch.float64
    with torch.no_grad():
        got = tmodel(torch.from_numpy(images),
                     torch.from_numpy(mask) if with_mask else None).logits
    assert got.shape == (2, n, VCFG.hidden_size)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def _route(impl, fn):
    set_sdpa_impl(impl)
    try:
        return fn()
    finally:
        set_sdpa_impl("xla")


def test_routes_agree():
    """fp32: the "short" route (the plain versions of K5 and, for ViT,
    K6), the "auto" route (on the CPU: "xla", and the packed ViT path's
    full-matrix attention) and the "xla" route give the same outputs and
    the same gradients; "short" launches nothing on the CPU."""
    ids, mask = (torch.from_numpy(x) for x in _batch(3))
    mlm = tt.EncoderForMaskedLM(TCFG, "rope", "gqa", device="cpu").init(
        torch.Generator().manual_seed(0))
    vit = tt.Vit(TVCFG, device="cpu").init(torch.Generator().manual_seed(1))
    images = torch.from_numpy(_images(4)).float()
    launches = [fn.launches for fn in eb.KERNELS]

    def run(model, *inputs):
        model.zero_grad(set_to_none=True)
        out = model(*inputs).logits
        out.square().mean().backward()
        return [out.detach()] + [p.grad.clone() for p in model.parameters()]

    for model, inputs in ((mlm, (ids, mask)), (vit, (images,))):
        want = _route("xla", lambda: run(model, *inputs))
        for impl in ("short", "auto"):
            got = _route(impl, lambda: run(model, *inputs))
            for a, b in zip(got, want):
                top = float(b.abs().max())
                torch.testing.assert_close(a, b, atol=1e-5 * max(top, 1.0),
                                           rtol=0)
    assert [fn.launches for fn in eb.KERNELS] == launches


def test_vit_short_route_reaches_packed_path(monkeypatch):
    """Under "short", every ViT layer without a mask goes through
    ``short_attention_qkv``; with a mask, through the key-pad route."""
    calls = []
    for name in ("short_attention_qkv", "short_attention_bias"):
        orig = getattr(sa, name)
        monkeypatch.setattr(sa, name, lambda *a, _o=orig, _n=name:
                            calls.append(_n) or _o(*a))
    vit = tt.Vit(TVCFG, device="cpu").init(torch.Generator().manual_seed(1))
    images = torch.from_numpy(_images(5)).float()
    n = TVCFG.num_patches + 1
    with torch.no_grad():
        _route("short", lambda: vit(images))
        assert calls == ["short_attention_qkv"] * 2
        _route("short", lambda: vit(images, torch.ones(2, n)))
    assert calls[2:] == ["short_attention_bias"] * 2


def _grads(model, loss_fn, batch, **kw):
    model.zero_grad(set_to_none=True)
    loss, _ = loss_fn(model, batch, **kw)
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


def test_dropout_replayed_under_remat():
    """Same seed, same dropout masks: remat recomputes each encoder layer
    with the forward's masks, and the generator ends where the forward
    left it."""
    cfg = TCFG.replace(hidden_dropout_prob=0.1)
    ids, mask = (torch.from_numpy(x) for x in _batch(6))
    batch = {"ids": ids, "mask": mask}
    models = [tt.EncoderModel(cfg, "rope", "gqa", remat=remat,
                              device="cpu", dtype=torch.float64)
              .init(torch.Generator().manual_seed(4))
              for remat in (False, True)]
    gens = [torch.Generator().manual_seed(9) for _ in models]

    def loss_fn(model, batch, generator):
        out = model(batch["ids"], batch["mask"], deterministic=False,
                    generator=generator)
        return out.logits.square().mean(), {}

    (la, ga), (lb, gb) = (_grads(m, loss_fn, batch, generator=g)
                          for m, g in zip(models, gens))
    assert torch.equal(la, lb)
    for name in ga:
        torch.testing.assert_close(ga[name], gb[name], atol=1e-14, rtol=0)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    with torch.no_grad():
        det = models[0](ids, mask).logits
    assert not torch.allclose(det, models[0](
        ids, mask, deterministic=False, generator=gens[0]).logits)


@pytest.mark.parametrize("which", ["mlm", "encoder", "vit"])
def test_bridge_round_trip(which):
    """The bridge, then ``tree_from_torch``, gives the JAX tree back
    bit-exact: same keys, shapes, dtypes and values."""
    if which == "vit":
        _, params = _vit(3)
        tree = jax.tree_util.tree_map(np.asarray, params)
        model = vit_params_from_jax(tree, TVCFG, device="cpu")
        np.testing.assert_array_equal(
            model.layers[1].attention.qkv.weight.detach().numpy(),
            tree["layers"]["attention"]["qkv"]["kernel"][1].T)
    else:
        _, params = _mlm("absolute", "gqa", seed=3)
        tree = jax.tree_util.tree_map(np.asarray, params)
        if which == "encoder":
            tree = tree["encoder"]
        model = encoder_params_from_jax(tree, TCFG, "absolute", "gqa",
                                        device="cpu")
    assert model.dtype == torch.float32
    back = tree_from_torch(model)
    want = dict(jax.tree_util.tree_leaves_with_path(tree))
    got = jax.tree_util.tree_leaves_with_path(back)
    assert len(got) == len(want)
    for path, x in got:
        w = want[path]
        assert x.dtype == w.dtype and x.shape == w.shape, path
        np.testing.assert_array_equal(x, w, err_msg=str(path))


def _assert_tree_close(got, want):
    want = dict(jax.tree_util.tree_leaves_with_path(want))
    got = jax.tree_util.tree_leaves_with_path(got)
    assert len(got) == len(want)
    for path, g in got:
        w = np.asarray(want[path])
        # floor: the key projection's bias gets an exactly-zero gradient
        # (softmax ignores a per-row shift), left as ~1e-22 of noise
        atol = GRAD_RTOL_OF_MAX * max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g, w, atol=atol, rtol=0,
                                   err_msg=str(path))


def test_mlm_train_step_matches_jax_fp64():
    """``encoder_bench.mlm_loss`` (CE over the valid positions) and every
    gradient against ``jax.value_and_grad`` of the JAX bench's loss."""
    model, params = _mlm("absolute", None, seed=5)
    ids, mask = _batch(7)
    mask[2, :9] = 1     # the bench's batches have no empty row

    def jloss(p):
        out = model.apply(p, jnp.asarray(ids), jnp.asarray(mask))
        labels = jnp.where(jnp.asarray(mask) > 0, jnp.asarray(ids), -100)
        return j_cross_entropy(out.logits, labels)

    with jax.enable_x64(True):
        want_loss, want = jax.value_and_grad(jloss)(_jax64(params))
    tmodel = encoder_params_from_jax(_np_tree(params, np.float64), TCFG,
                                     "absolute", device="cpu")
    loss, grads = _grads(tmodel, eb.mlm_loss, {
        "ids": torch.from_numpy(ids), "mask": torch.from_numpy(mask)})
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-10)
    _assert_tree_close(tree_from_torch(tmodel, grads), want)


def test_vit_train_step_matches_jax_fp64():
    """``encoder_bench.vit_loss`` (CE of a linear head on the CLS token) and
    every gradient against ``jax.value_and_grad``."""
    model, params = _vit(6)
    rng = np.random.default_rng(8)
    head = {"w": rng.standard_normal((VCFG.hidden_size, 10)) * 0.02,
            "b": rng.standard_normal(10) * 0.02}
    images, labels = _images(9), rng.integers(0, 10, 2)

    def jloss(p):
        hid = model.apply(p["vit"], jnp.asarray(images)).logits
        logits = hid[:, 0] @ p["head"]["w"] + p["head"]["b"]
        return j_cross_entropy(logits, jnp.asarray(labels))

    with jax.enable_x64(True):
        want_loss, want = jax.value_and_grad(jloss)(
            _jax64({"vit": params, "head": head}))
    tmodel = eb.VitClassifier(TVCFG, 10, device="cpu", dtype=torch.float64)
    tmodel.vit = vit_params_from_jax(_np_tree(params, np.float64), TVCFG,
                                     device="cpu")
    with torch.no_grad():
        tmodel.head.weight.copy_(torch.from_numpy(head["w"].T))
        tmodel.head.bias.copy_(torch.from_numpy(head["b"]))
    loss, grads = _grads(tmodel, eb.vit_loss, {
        "images": torch.from_numpy(images), "labels": torch.from_numpy(
            labels)})
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-10)
    vit_grads = {n[len("vit."):]: g for n, g in grads.items()
                 if n.startswith("vit.")}
    _assert_tree_close(tree_from_torch(tmodel.vit, vit_grads), want["vit"])
    np.testing.assert_allclose(grads["head.weight"].numpy().T,
                               np.asarray(want["head"]["w"]), atol=1e-12)
    np.testing.assert_allclose(grads["head.bias"].numpy(),
                               np.asarray(want["head"]["b"]), atol=1e-12)


@pytest.mark.parametrize("which", ["mlm", "vit"])
def test_param_count_and_init_match_jax(which):
    if which == "mlm":
        _, params = _mlm("absolute", None)
        model = tt.EncoderForMaskedLM(TCFG, "absolute", device="cpu").init(
            torch.Generator().manual_seed(0))
        assert torch.all(model.encoder.word_embeddings.weight[
            TCFG.pad_token_id] == 0)
        w = model.encoder.layers[0].attention.query.weight
    else:
        _, params = _vit()
        model = tt.Vit(TVCFG, device="cpu").init(
            torch.Generator().manual_seed(0))
        assert torch.all(model.pixel_seq.bias == 0)
        assert abs(float(model.cls_token.detach().std()) - 1.0) < 0.3
        w = model.layers[0].attention.qkv.weight
    n_jax = sum(x.size for x in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert abs(float(w.detach().std()) - 0.02) < 0.005


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        tt.EncoderModel(TCFG, remat="dots", device="cpu")
    model = tt.EncoderModel(TCFG, device="cpu").init(
        torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        model(torch.ones(1, 4, dtype=torch.long), deterministic=False)


def test_encoder_bench_three_steps_on_cpu():
    """``encoder_bench`` at tiny width on the CPU: both parts, both routes,
    3 timed steps; the losses fall and the routes agree."""
    mlm = eb.bench_mlm(32, 4, config=TCFG, steps=3, warmup=1, fwd_reps=1,
                       device="cpu", dtype=torch.float32)
    for route in ("short", "xla"):
        losses = mlm[f"{route}_losses"]
        assert len(losses) == 4 and losses[-1] < losses[0]
    np.testing.assert_allclose(mlm["short_losses"], mlm["xla_losses"],
                               rtol=1e-6)
    assert mlm["real_tokens"] > 64 and mlm["speedup"] > 0
    vit = eb.bench_vit(config=TVCFG, batch=4, train_batch=2, n_classes=10,
                       steps=3, warmup=1, fwd_reps=1, device="cpu",
                       dtype=torch.float32)
    for route in ("short", "xla"):
        assert vit[route]["losses"][-1] < vit[route]["losses"][0]
        assert vit[route]["fwd_img_s"] > 0 and vit[route]["peak_bytes"] is None
