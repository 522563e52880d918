"""Parity of the port's training slice with the JAX package's: the bench's
fused and naive losses and every gradient (fp64, ``"xla"`` route in both,
a batch with pad-mask zeros and pad token id 1, so the token-table and
position-row detaches are exercised), the flash route at fp32 against the
JAX flash kernels in interpret mode, the chunked cross-entropy, AdamW with
clipping and a warmup-cosine schedule against optax, gradient
accumulation and the JSONL logger."""

import json
from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import vyomai_tpu as vt
from vyomai_tpu.core import nn as jcnn
from vyomai_tpu.layers import attention as jattn
from vyomai_tpu.ops import flash_attention as jfa
from vyomai_tpu.ops import fused as jfused
from vyomai_tpu.training import create_train_state as j_create_state
from vyomai_tpu.training import make_optimizer as j_make_optimizer
from vyomai_tpu.training import make_train_step as j_make_train_step

import vyomai_tpu_torch as tt
from vyomai_tpu_torch import bench
from vyomai_tpu_torch.interop import (decoder_params_from_jax,
                                      tree_from_torch)
from vyomai_tpu_torch.layers.attention import set_sdpa_impl
from vyomai_tpu_torch.ops.fused import cross_entropy, lm_head_ce_loss
from vyomai_tpu_torch.training import (Trainer, create_train_state,
                                       make_optimizer, make_train_step)

torch.set_num_threads(1)

CFG = vt.EncoderConfig(hidden_size=64, num_attention_heads=4,
                       num_key_value_heads=2, num_hidden_layers=2,
                       vocab_size=128, max_position_embeddings=64,
                       intermediate_size=256, hidden_dropout_prob=0.0)
TCFG = tt.EncoderConfig(**{f.name: getattr(CFG, f.name)
                           for f in fields(CFG)})
# fp64, except the RoPE cos/sin tables, which each library evaluates in
# fp32 (one fp32 ulp apart, 6e-8 relative): 1e-6 of each tensor's max
GRAD_RTOL_OF_MAX = 1e-6


@pytest.fixture(autouse=True)
def _routes():
    yield
    jattn.set_sdpa_impl("auto")
    set_sdpa_impl("auto")
    jfa.set_interpret(False)


def _batch(seed=0, b=2, l=24):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, CFG.vocab_size, (b, l)).astype(np.int32)
    ids[0, 1] = ids[0, 6] = ids[1, 11] = CFG.pad_token_id   # pad id 1
    mask = np.ones((b, l), np.int32)
    mask[1, 18:] = 0
    return {"ids": ids, "mask": mask}


def _jax_losses(model, cfg):
    """The two losses of ``bench.py`` (``bench.py:67-80``)."""
    def fused(p, batch, rng=None):
        out = model.apply(p, batch["ids"], batch["mask"])
        h = jcnn.linear(p["lm_head"]["dense"], out.hidden_state)
        h = jcnn.layer_norm(p["lm_head"]["layer_norm"], jcnn.gelu(h),
                            eps=cfg.layer_norm_eps)
        return jfused.lm_head_ce_loss(
            h, p["lm_head"]["decoder"]["kernel"],
            p["lm_head"]["decoder"]["bias"], batch["ids"], shift=True,
            chunk_size=16), {}

    def naive(p, batch, rng=None):
        out = model.apply(p, batch["ids"], batch["mask"])
        return jfused.cross_entropy(out.logits[:, :-1],
                                    batch["ids"][:, 1:]), {}
    return {"fused": fused, "naive": naive}


def _torch_losses(chunk_size):
    def fused(model, batch, generator=None):
        hidden = model.hidden_states(batch["ids"], batch["mask"])
        h = tt.models.encoder.lm_head_transform(model.lm_head, hidden,
                                                model.config)
        head = model.lm_head.decoder
        return lm_head_ce_loss(h, head.weight, head.bias, batch["ids"],
                               shift=True, chunk_size=chunk_size), {}
    return {"fused": fused, "naive": bench.naive_loss}


def _tb(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _assert_tree_close(got, want, rtol_of_max, floor=1e-15):
    """Leafwise ``|got - want| <= rtol_of_max * max|want| + floor``. The
    default floor covers gradient leaves that are zero in exact arithmetic
    (the key bias without RoPE adds a per-row constant that softmax
    ignores): both sides hold rounding noise there."""
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_g) == len(flat_w)
    for path, g in flat_g:
        w = np.asarray(flat_w[path])
        atol = rtol_of_max * float(np.abs(w).max()) + floor
        np.testing.assert_allclose(g, w, atol=atol, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("loss", ["fused", "naive"])
@pytest.mark.parametrize("pe,at", [("rope", "gqa"), ("absolute", None)])
def test_bench_losses_and_grads_match_jax_fp64(pe, at, loss):
    """bench.py's objectives at fp64 on the "xla" route: loss and every
    gradient, the pad rows' zero gradients included."""
    jattn.set_sdpa_impl("xla")
    set_sdpa_impl("xla")
    model = vt.DecoderModel(CFG, pos_embedding_type=pe, attention_type=at)
    params = model.init(jax.random.PRNGKey(1))
    batch = _batch(1)
    with jax.enable_x64(True):
        jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                    params)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        (jloss, _), jgrads = jax.value_and_grad(
            _jax_losses(model, CFG)[loss], has_aux=True)(jp, jb)
        jloss = float(jloss)
        jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    tree = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64),
                                  params)
    tmodel = decoder_params_from_jax(tree, TCFG, pe, at, device="cpu")
    tloss, _ = _torch_losses(16)[loss](tmodel, _tb(batch))
    tloss.backward()
    assert abs(float(tloss.detach()) - jloss) < 1e-10
    grads = tree_from_torch(
        tmodel, {n: p.grad for n, p in tmodel.named_parameters()})
    _assert_tree_close(grads, jgrads, GRAD_RTOL_OF_MAX)
    pad = CFG.pad_token_id
    assert np.all(grads["word_embeddings"]["weight"][pad] == 0)
    assert np.abs(grads["word_embeddings"]["weight"][2:]).max() > 0
    if pe == "absolute":   # position row pad_idx never trains
        assert np.all(grads["position_embeddings"]["weight"][pad] == 0)
        assert np.abs(grads["position_embeddings"]["weight"][0]).max() > 0


def test_flash_route_matches_jax_flash_fp32():
    """The fused loss through flash attention (the kernels' plain versions
    on the CPU) against the JAX flash kernels in interpret mode, fp32."""
    jattn.set_sdpa_impl("flash")
    jfa.set_interpret(True)
    set_sdpa_impl("flash")
    model = vt.DecoderModel(CFG, pos_embedding_type="rope",
                            attention_type="gqa")
    params = model.init(jax.random.PRNGKey(2))
    batch = _batch(2, l=32)
    batch["mask"][0, 0] = 0          # a fully-masked row: 0 on both sides
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.value_and_grad(
        _jax_losses(model, CFG)["fused"], has_aux=True)(params, jb)
    tmodel = decoder_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), TCFG, "rope", "gqa",
        device="cpu")
    tloss, _ = _torch_losses(16)["fused"](tmodel, _tb(batch))
    tloss.backward()
    assert abs(float(tloss.detach()) - float(jloss)) < 1e-5
    grads = tree_from_torch(
        tmodel, {n: p.grad for n, p in tmodel.named_parameters()})
    _assert_tree_close(grads, jax.tree_util.tree_map(np.asarray, jgrads),
                       1e-4)   # fp32 reduction order through 2 layers


@pytest.mark.parametrize("shift,chunk", [(False, 8), (True, 4), (True, 64)])
def test_chunked_ce_matches_plain_and_jax(shift, chunk):
    """Chunked vs plain CE, with shift, padding to the chunk multiple and
    ignore_index (tests/test_training_and_ops.py:31-60)."""
    rng = np.random.default_rng(chunk)
    h = rng.standard_normal((2, 13, 64))
    kern = rng.standard_normal((64, 128)) * 0.05
    bias = rng.standard_normal(128) * 0.1
    tg = rng.integers(0, 128, (2, 13))
    tg[0, 3] = tg[1, 7] = -100
    with jax.enable_x64(True):
        want = float(jfused.lm_head_ce_loss(
            jnp.asarray(h), jnp.asarray(kern), jnp.asarray(bias),
            jnp.asarray(tg), shift=shift, chunk_size=chunk))
    th, tk = torch.tensor(h, requires_grad=True), torch.tensor(kern.T.copy(),
                                                               requires_grad=True)
    tb, tt_ = torch.tensor(bias), torch.tensor(tg)
    got = lm_head_ce_loss(th, tk, tb, tt_, shift=shift, chunk_size=chunk)
    assert abs(float(got.detach()) - want) < 1e-12
    got.backward()
    gh, gk = th.grad.clone(), tk.grad.clone()
    th.grad = tk.grad = None
    logits = th @ tk.t() + tb
    plain = (cross_entropy(logits[:, :-1], tt_[:, 1:]) if shift
             else cross_entropy(logits, tt_))
    plain.backward()
    assert abs(float(plain.detach()) - float(got.detach())) < 1e-12
    torch.testing.assert_close(gh, th.grad, atol=1e-12, rtol=0)
    torch.testing.assert_close(gk, tk.grad, atol=1e-12, rtol=0)


def test_cross_entropy_all_ignored_is_zero():
    logits = torch.randn(2, 4, 16, generator=torch.Generator().manual_seed(0))
    assert float(cross_entropy(logits, torch.full((2, 4), -100))) == 0.0
    assert float(lm_head_ce_loss(logits, torch.zeros(8, 16), None,
                                 torch.full((2, 4), -100),
                                 chunk_size=3)) == 0.0


@pytest.mark.parametrize("schedule,warmup,total", [
    ("cosine", 2, 6), ("cosine", 0, 4), ("constant", 3, None),
    ("constant", 0, None), ("cosine", 9, 5)])
def test_schedule_matches_optax(schedule, warmup, total):
    opt = make_optimizer(0.1, warmup_steps=warmup, total_steps=total,
                         schedule=schedule)
    if schedule == "cosine":
        w = min(warmup, max(total - 1, 0))
        ref = optax.warmup_cosine_decay_schedule(0.0, 0.1, w, total)
    elif warmup:
        ref = optax.linear_schedule(0.0, 0.1, warmup)
    else:
        ref = lambda c: 0.1   # noqa: E731
    for count in range(10):
        assert abs(0.1 * opt.lr_factor(count) - float(ref(count))) < 1e-7


# Adam divides by sqrt(v) + eps: where |g| is below eps (1e-8), a
# gradient's fp64 rounding noise (~1e-16) moves the update by up to
# lr * 1e-16 / eps = 1e-10 per step at lr 1e-2
PARAM_FLOOR = 3 * 1e-2 * 1e-16 / 1e-8 * 10
# optax evaluates the schedule at an int32 count, so its learning rate is
# fp32 (one fp32 ulp, 6e-8 relative, from the port's fp64 rate): each
# update moves every param by ~lr * 6e-8 (2e-10 at lr 1e-2), and the next
# step's Adam normalisation amplifies the moved gradients where they are
# small. 4e-7 of each tensor's max was seen after 3 steps.
PARAM_RTOL_OF_MAX = 1e-6


def test_three_adamw_steps_match_optax_fp64():
    """make_train_step with AdamW + clip(1.0) + warmup-cosine: loss, the
    pre-clip grad_norm (> 1 on every step, so clipping scales) and params
    after each of 3 steps against the JAX train step at fp64. Absolute
    positions keep the fp32 RoPE tables out, so only fp64 rounding and
    optax's fp32 learning rate differ."""
    jattn.set_sdpa_impl("xla")
    set_sdpa_impl("xla")
    model = vt.DecoderModel(CFG, pos_embedding_type="absolute",
                            attention_type="gqa")
    params = model.init(jax.random.PRNGKey(3))
    batch = _batch(3)
    kw = dict(warmup_steps=1, total_steps=4, schedule="cosine",
              weight_decay=0.01)
    tree = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64),
                                  params)
    tmodel = decoder_params_from_jax(tree, TCFG, "absolute", "gqa",
                                     device="cpu")
    topt = make_optimizer(1e-2, **kw)
    tstate = create_train_state(tmodel, topt)
    tstep = make_train_step(bench.naive_loss, topt)
    with jax.enable_x64(True):
        jopt = j_make_optimizer(1e-2, **kw)
        jstate = j_create_state(jax.tree_util.tree_map(jnp.asarray, tree),
                                jopt)
        jstep = j_make_train_step(_jax_losses(model, CFG)["naive"], jopt,
                                  donate=False)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        for i in range(3):
            jstate, jm = jstep(jstate, jb, jax.random.PRNGKey(0))
            tstate, tm = tstep(tstate, _tb(batch))
            # after the first update the params differ slightly (see
            # PARAM_RTOL_OF_MAX), which moves loss and gradients
            assert abs(float(tm["loss"]) - float(jm["loss"])) \
                < 1e-9 * float(jm["loss"])
            assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
                < 1e-7 * float(jm["grad_norm"])
            assert float(jm["grad_norm"]) > 1.0
            _assert_tree_close(tree_from_torch(tmodel),
                               jax.tree_util.tree_map(np.asarray,
                                                      jstate.params),
                               PARAM_RTOL_OF_MAX, floor=PARAM_FLOOR)
    assert tstate.step == 3


def test_grad_accum_matches_full_batch():
    """tests/test_training_and_ops.py:130-153: 4 microbatches give the
    full batch's update."""
    set_sdpa_impl("xla")
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, 128, (8, 12))).long()
    batch = {"ids": ids, "mask": torch.ones_like(ids)}
    states, metrics = [], []
    for accum in (1, 4):
        model = tt.DecoderModel(TCFG, "rope", device="cpu").init(
            torch.Generator().manual_seed(0))
        opt = make_optimizer(1e-2)
        state = create_train_state(model, opt)
        step = make_train_step(bench.naive_loss, opt, grad_accum_steps=accum)
        state, m = step(state, batch)
        states.append(state)
        metrics.append(m)
    for a, b in zip(states[0].params.parameters(),
                    states[1].params.parameters()):
        assert float((a - b).detach().abs().max()) < 1e-5
    assert abs(float(metrics[0]["loss"]) - float(metrics[1]["loss"])) < 1e-5
    with pytest.raises(ValueError):
        make_train_step(bench.naive_loss, make_optimizer(),
                        grad_accum_steps=3)(states[0], batch)


def test_trainer_fit_writes_jsonl(tmp_path):
    path = tmp_path / "metrics.jsonl"
    model = tt.DecoderModel(TCFG, "rope", "gqa", device="cpu").init(
        torch.Generator().manual_seed(0))
    batch = _tb(_batch(4))

    def data():
        while True:
            yield batch

    with Trainer(model, bench.fused_loss, optimizer=make_optimizer(1e-3),
                 log_path=str(path)) as trainer:
        state = trainer.fit(trainer.init_state(), data(), num_steps=4,
                            log_every=2)
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 4]
    assert all(set(r) == {"step", "time", "loss", "grad_norm"} for r in recs)
    assert recs[-1]["loss"] < recs[0]["loss"]
    assert state.step == 4


def test_unported_training_options_raise():
    with pytest.raises(NotImplementedError):
        make_optimizer(kind="muon")
    with pytest.raises(NotImplementedError):
        make_optimizer(kind="adamw8bit")
    with pytest.raises(ValueError):
        make_optimizer(schedule="cosine")
    with pytest.raises(NotImplementedError):
        Trainer(torch.nn.Linear(2, 2), bench.naive_loss, mesh_shape=(1, 1))
