"""K12 (``ops/rms_norm.py``, ``csrc/rms_norm.cu``): RMSNorm with the
residual add that feeds it, one launch a norm site of the paged serving
steps.

On the CPU the op takes its plain version, which must be
``core.nn.rms_norm`` bit for bit (and, with ``residual``, the sum as the
dtype rounds it and the norm of that rounded sum); the paged decode step
and prefill call must send every norm site through the op, which counts
the sites: 4L + 1 with per-head QK-norm, 2L + 1 without, 2L + 2 x
(attention layers) + 1 for LFM2's mix of conv and attention layers. The
engine adds them to its counters for every step and prefill call.

The ``cuda`` cases (skipped without a card) hold the kernel to
``core.nn.rms_norm`` at the row widths of the served models (per-head 64
and 128, hidden 1,024, 2,048, 4,096) and at row counts from one to a
prefill's 2,048, in bf16 and fp32, with and without the residual: only
the fp32 sum's order differs, so bf16 outputs are within one bf16 ulp
(and nearly all identical) and fp32 ones within 1e-6 of each value; the
residual sum is the plain add's, bit for bit. A captured graph replays to
the eager result, and the serving steps launch K12 once a site.
"""

import pytest
import torch

import vyomai_tpu_torch as tt
from vyomai_tpu_torch.core import nn as cnn
from vyomai_tpu_torch.ops import rms_norm as k12
from vyomai_tpu_torch.serving import paged_model as pm

EPS = 1e-6


def _operands(shape, dtype, device="cpu", seed=0):
    """x and delta of ``shape``, a weight of its last dimension near 1."""
    g = torch.Generator(device=device).manual_seed(seed)
    x, delta = (torch.randn(shape, generator=g, device=device).to(dtype)
                for _ in range(2))
    w = (1.0 + 0.1 * torch.randn(shape[-1], generator=g, device=device)
         ).to(dtype)
    return x, delta, w


# -- the plain version on the CPU ----------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("shape", [(5, 64), (3, 4, 128), (2, 1024)])
def test_plain_version_is_core_rms_norm_bit_for_bit(dtype, shape):
    x, delta, w = _operands(shape, dtype)
    assert torch.equal(k12.rms_norm(w, x, EPS),
                       cnn.rms_norm(w, x, eps=EPS))
    s, y = k12.rms_norm(w, delta, EPS, residual=x)
    assert s.dtype == y.dtype == dtype
    assert torch.equal(s, x + delta)
    assert torch.equal(y, cnn.rms_norm(w, x + delta, eps=EPS))


def test_residual_sum_is_rounded_before_the_norm_reads_it():
    x, delta, w = _operands((8, 256), torch.bfloat16)
    s, y = k12.rms_norm(w, delta, EPS, residual=x)
    assert torch.equal(s, (x.float() + delta.float()).to(torch.bfloat16))
    unrounded = cnn.rms_norm(w.float(), x.float() + delta.float(), eps=EPS)
    assert torch.equal(y, cnn.rms_norm(w, s, eps=EPS))
    assert not torch.equal(y, unrounded.to(torch.bfloat16))


def test_counts_a_site_per_call_and_no_launch_on_the_cpu():
    x, delta, w = _operands((4, 64), torch.float32)
    sites, launches = k12.rms_norm.sites, k12.rms_norm.launches
    k12.rms_norm(w, x, EPS)
    k12.rms_norm(w, delta, EPS, residual=x)
    assert k12.rms_norm.sites == sites + 2
    assert k12.rms_norm.launches == launches


def test_gradient_flows_through_the_plain_version():
    x, delta, w = _operands((4, 64), torch.float32)
    w.requires_grad_(True)
    s, y = k12.rms_norm(w, delta, EPS, residual=x)
    y.sum().backward()
    x2 = (x + delta).detach()
    w2 = w.detach().clone().requires_grad_(True)
    cnn.rms_norm(w2, x2, eps=EPS).sum().backward()
    assert torch.equal(w.grad, w2.grad)


# -- the serving steps' norm sites ----------------------------------------------

def _qwen(qk_norm=True, device="cpu", dtype=torch.float32):
    cfg = tt.QwenConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                        num_hidden_layers=3, num_attention_heads=4,
                        num_key_value_heads=2, head_dim=64,
                        max_position_embeddings=256, qk_norm=qk_norm,
                        eos_token_id=9999)
    return tt.ModelForCausalLM(cfg, device=device, dtype=dtype).init(
        torch.Generator(device=device).manual_seed(0))


def _lfm2(device="cpu", dtype=torch.float32):
    cfg = tt.Lfm2MoeConfig(     # head_dim 64, as K4 takes it on the card
        vocab_size=512, hidden_size=256, intermediate_size=128,
        moe_intermediate_size=64, num_hidden_layers=5, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=128,
        layer_types=("conv", "conv", "full_attention", "conv",
                     "full_attention"),
        num_dense_layers=1, num_experts=6, num_experts_per_tok=2,
        eos_token_id=9999)
    return tt.Lfm2MoeForCausalLM(cfg, device=device, dtype=dtype).init(
        torch.Generator(device=device).manual_seed(0))


MODELS = {"qwen": lambda **kw: _qwen(**kw),
          "no_qk_norm": lambda **kw: _qwen(qk_norm=False, **kw),
          "lfm2": lambda **kw: _lfm2(**kw)}
# a step's norm sites: input and post-attention norms in every layer,
# per-head q and k norms in every attention layer that has them, the final
SITES = {"qwen": 4 * 3 + 1, "no_qk_norm": 2 * 3 + 1,
         "lfm2": 2 * 5 + 2 * 2 + 1}


def _steps(model, device="cpu"):
    """One decode step of two lanes and one prefill call of two rows over
    a fresh pool, as closures."""
    cfg, dt = model.config, model.dtype
    pool = pm.init_pool(cfg, 16, 8, dtype=dt, device=device)
    state = pm.init_lane_state(model, 2)
    i32 = dict(dtype=torch.int32, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    tables = torch.tensor([[0, 1], [2, 3]], **i32)
    pos = torch.tensor([3, 5], **i64)

    def decode():
        return pm.decode(model, pool, torch.tensor([7, 9], **i32), pos,
                         tables, (pos + 1).to(torch.int32),
                         torch.tensor([0, 2], **i32), pos % 8, state=state)

    def prefill():
        t = 6
        ids = torch.arange(2 * t, **i64).reshape(2, t) % cfg.vocab_size
        positions = torch.arange(t, **i64).expand(2, t).contiguous()
        blocks = tables[:, :1].expand(2, t).contiguous()
        return pm.prefill(model, pool, ids, positions, blocks, positions,
                          tables, torch.tensor([t, 4], **i64),
                          torch.tensor([t, 4], **i64),
                          torch.tensor([0, 1], **i64), state=state)
    return decode, prefill


@pytest.mark.parametrize("kind", list(MODELS))
def test_paged_steps_send_every_norm_site_through_the_op(kind, monkeypatch):
    model = MODELS[kind]()
    plain_calls = []
    plain = cnn.rms_norm
    monkeypatch.setattr(cnn, "rms_norm", lambda *a, **kw: (
        plain_calls.append(1), plain(*a, **kw))[1])
    for step in _steps(model):
        before = pm.norm_counts()
        step()
        sites, fused = pm.norm_counts()
        # every core.nn.rms_norm call came through the op's plain version
        assert sites - before[0] == SITES[kind] == len(plain_calls)
        assert fused == before[1]
        plain_calls.clear()


def _served_counters(model, device="cpu"):
    """The engine's counters after three requests served one decode step a
    tick (so the steps are the ticks), one prompt chunked over two prefill
    calls."""
    eng = tt.ContinuousBatchEngine(
        model, num_blocks=64, block_size=16, max_batch=4,
        max_blocks_per_seq=4, max_new_tokens=5, dtype=model.dtype,
        prefill_buckets=(8, 16), decode_horizon=1, radix_cache=False,
        device=device)
    for p in ([3, 17, 42, 9], [5, 11], list(range(2, 22))):
        eng.submit(p)
    eng.run()
    c = eng.counters
    steps = c["prefill_calls"] + c["decode_ticks"]
    assert c["prefill_calls"] >= 2 and c["decode_ticks"] >= 4
    return c, steps


@pytest.mark.parametrize("kind", ["qwen", "lfm2"])
def test_engine_counts_the_norm_sites_of_every_step_and_call(kind):
    c, steps = _served_counters(MODELS[kind]())
    assert c["norm_sites"] == SITES[kind] * steps
    assert c["norm_sites_fused"] == 0


# -- the kernel on the card -----------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _ulp_bf16(t):
    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def _close(got, want):
    """bf16: within one ulp, at least 99 % identical; fp32: within 1e-6 of
    each value (products only after the row's sum)."""
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        ulp = torch.maximum(_ulp_bf16(got), _ulp_bf16(want))
        same = float((got == want).float().mean())
        return bool((diff <= ulp).all()) and same >= 0.99, same
    return bool((diff <= 1e-6 * want.float().abs()).all()), float(
        diff.max())


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", [1, 63, 64, 128, 2048])
@pytest.mark.parametrize("width", [64, 128, 1024, 2048, 4096])
def test_k12_matches_plain_on_card(cuda, width, rows, dtype, residual):
    x, delta, w = _operands((rows, width), dtype, cuda, seed=width + rows)
    launches = k12.rms_norm.launches
    if residual:
        s, got = k12.rms_norm(w, delta, EPS, residual=x)
        assert torch.equal(s, x + delta)
        want = cnn.rms_norm(w, x + delta, eps=EPS)
    else:
        got, want = k12.rms_norm(w, x, EPS), cnn.rms_norm(w, x, eps=EPS)
    torch.cuda.synchronize()
    assert k12.rms_norm.launches == launches + 1
    ok, how = _close(got, want)
    assert ok, how
    again = k12.rms_norm(w, delta, EPS, residual=x)[1] if residual else \
        k12.rms_norm(w, x, EPS)
    assert torch.equal(again, got)           # no atomics: the same bits


@pytest.mark.cuda
def test_k12_graph_replays_to_the_eager_result(cuda):
    x, delta, w = _operands((64, 1024), torch.bfloat16, cuda)
    k12.rms_norm(w, delta, EPS, residual=x)          # built before capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        s, y = k12.rms_norm(w, delta, EPS, residual=x)
    x2, delta2, _ = _operands((64, 1024), torch.bfloat16, cuda, seed=5)
    x.copy_(x2)
    delta.copy_(delta2)
    graph.replay()
    s_eager, y_eager = k12.rms_norm(w, delta, EPS, residual=x)
    torch.cuda.synchronize()
    assert torch.equal(s, s_eager) and torch.equal(y, y_eager)


@pytest.mark.cuda
def test_k12_raises_on_what_it_does_not_take(cuda):
    x, delta, w = _operands((8, 128), torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        k12.rms_norm(w, x.t().contiguous().t(), EPS)     # rows not contiguous
    with pytest.raises(ValueError):
        k12.rms_norm(w[:100], x[:, :100].contiguous(), EPS)  # 200-byte rows
    with pytest.raises(ValueError):
        k12.rms_norm(w.float(), x, EPS)                  # weight's dtype
    with pytest.raises(ValueError):
        k12.rms_norm(w, delta.float(), EPS, residual=x)  # residual's dtype
    with pytest.raises(ValueError):
        k12.rms_norm(w.double(), x.double(), EPS)        # fp64: no fallback
    with pytest.raises(ValueError):
        k12.rms_norm(w.detach().requires_grad_(True), x, EPS)  # autograd
    launches = k12.rms_norm.launches
    with torch.no_grad():
        k12.rms_norm(w.detach().requires_grad_(True), x, EPS)
    assert k12.rms_norm.launches == launches + 1


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(MODELS))
def test_serving_steps_launch_k12_once_a_site_on_card(cuda, kind):
    model = MODELS[kind](device=cuda, dtype=torch.bfloat16)
    for step in _steps(model, cuda):
        before = pm.norm_counts()
        step()
        sites, fused = pm.norm_counts()
        assert sites - before[0] == fused - before[1] == SITES[kind]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["qwen", "lfm2"])
def test_engine_on_card_runs_every_site_through_k12(cuda, kind):
    """Through both captured graphs: each replay adds the sites its
    capture counted, and K12 ran every one."""
    model = MODELS[kind](device=cuda, dtype=torch.bfloat16)
    model.requires_grad_(False)
    c, steps = _served_counters(model, cuda)
    assert c["prefill_graph_calls"] == c["prefill_calls"]
    assert c["norm_sites"] == c["norm_sites_fused"] == SITES[kind] * steps
