"""The port's mixture-of-experts layer (``layers/moe.py``) and K11, its
grouped SwiGLU expert matmul (``ops/grouped_matmul.py``).

On the CPU: the softmax router and the grouped dispatch against the JAX
package's ``moe_apply`` (dropless, ``"einsum"`` and ``"ragged"``) at fp64
(``moe_apply`` takes its softmax in fp32, so the routing weights agree to
fp32 rounding: within 2^-20 of each, times the experts' outputs); the
sigmoid router with its
bias against the plain reference (``gpubench/reference/lfm2_moe.py``); K11's
plain version against one row at a time. The ``cuda`` cases hold K11 to
its plain version on the card, at a decode step's and a prefill call's
shapes, and through a CUDA graph replayed after the routing changed. JAX
is loaded by the ``jx`` fixture, so the card's cases run where it is not
installed.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gpubench.reference import lfm2_moe as plain
from vyomai_tpu_torch.layers.moe import MoE, dispatch, moe_apply
from vyomai_tpu_torch.ops.grouped_matmul import (grouped_swiglu,
                                                 grouped_swiglu_ref,
                                                 rounding_bound)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from vyomai_tpu.layers import moe as jmoe
    return jax, jmoe


def _moe(h, inter, e, k, router, dtype=torch.float64, seed=0, **kw):
    g = torch.Generator().manual_seed(seed)
    m = MoE(h, inter, e, k, router=router, device="cpu", dtype=dtype, **kw)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=g, dtype=p.dtype))
    return m


@pytest.mark.parametrize("impl", ["einsum", "ragged"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_softmax_router_matches_jax_moe_apply(jx, impl, k):
    jax, jmoe = jx
    m = _moe(16, 24, 5, k, "softmax")
    x = np.random.default_rng(k).standard_normal((2, 7, 16))
    with jax.enable_x64(True):
        params = {"router": {"kernel": m.gate.weight.detach().numpy().T},
                  "w_gate": m.w1.detach().numpy().transpose(0, 2, 1),
                  "w_in": m.w3.detach().numpy().transpose(0, 2, 1),
                  "w_out": m.w2.detach().numpy().transpose(0, 2, 1)}
        want, _ = jmoe.moe_apply(params, x, top_k=k, capacity_factor=None,
                                 act="silu", impl=impl)
        want = np.asarray(want)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = moe_apply(m, xt).numpy()
        # every expert's output at every token bounds what the fp32
        # routing weights can move
        each = sum(plain.swiglu(xt, m.w1[e], m.w3[e], m.w2[e]).abs()
                   for e in range(5)).numpy()
    assert (np.abs(got - want) <= 2.0 ** -20 * each + 1e-12).all()


@pytest.mark.parametrize("norm,scale", [(True, 1.0), (False, 2.5)])
def test_sigmoid_router_matches_the_plain_reference(norm, scale):
    m = _moe(16, 24, 6, 2, "sigmoid", expert_bias=True,
             norm_topk_prob=norm, routed_scaling_factor=scale)
    x = torch.randn(9, 16, generator=torch.Generator().manual_seed(4),
                    dtype=torch.float64)
    cfg = {"use_expert_bias": True, "num_experts_per_tok": 2,
           "norm_topk_prob": norm, "routed_scaling_factor": scale}
    p = {k: v.detach() for k, v in m.state_dict().items()}
    with torch.no_grad():
        got = moe_apply(m, x)
    want, _ = plain.experts(x, p, "", cfg)
    assert (got - want).abs().max() <= 1e-12


def test_invalid_tokens_route_to_no_expert_and_give_zero():
    m = _moe(16, 24, 6, 2, "sigmoid", expert_bias=True)
    x = torch.randn(2, 5, 16, generator=torch.Generator().manual_seed(5),
                    dtype=torch.float64)
    valid = torch.tensor([[True, True, False, True, False],
                          [False, True, True, False, False]])
    counts = torch.zeros(2, dtype=torch.int64)
    with torch.no_grad():
        got = moe_apply(m, x, valid, counts)
        alone = moe_apply(m, x[valid])
    assert torch.equal(got[~valid], torch.zeros_like(got[~valid]))
    assert (got[valid] - alone).abs().max() <= 1e-12
    assert int(counts[0]) == 5 * 2                       # rows K11 ran
    _, sel = torch.topk(torch.sigmoid(x[valid] @ m.gate.weight.T)
                        + m.expert_bias, 2)
    assert int(counts[1]) == len(set(sel.flatten().tolist()))


def test_dispatch_groups_rows_by_expert_in_token_order():
    sel = torch.tensor([[2, 0], [0, 3], [2, 1], [3, 0]])
    valid = torch.tensor([True, True, False, True])
    pos, src, offsets = dispatch(sel, 4, valid)
    # experts 0..3 then the sentinel: rows (token, choice) in token order
    assert offsets.tolist() == [0, 3, 3, 4, 6]
    flat = torch.where(valid[:, None], sel, 4).reshape(-1)
    assert sorted(pos.tolist()) == list(range(8))
    assert flat[torch.argsort(pos)].tolist() == [0, 0, 0, 2, 3, 3, 4, 4]
    assert src.tolist() == [0, 1, 3, 0, 1, 3, 2, 2]


def _rows(t, k, e, seed, valid_share=1.0, device="cpu"):
    """A routing of ``t`` tokens, ``k`` experts each (distinct), the first
    ``valid_share`` of them real: ``(src, offsets)``."""
    g = torch.Generator().manual_seed(seed)
    sel = torch.rand(t, e, generator=g).topk(k, -1).indices
    valid = torch.arange(t) < int(valid_share * t)
    _, src, offsets = dispatch(sel, e, valid)
    return src.to(device), offsets.to(device)


def _per_row(x, src, offsets, w1, w3, w2):
    """One row at a time, in fp64."""
    y = torch.zeros(src.shape[0], w2.shape[1], dtype=torch.float64)
    off = offsets.tolist()
    for e in range(w1.shape[0]):
        for r in range(off[e], off[e + 1]):
            xr = x[src[r]].double()
            h = F.silu(w1[e].double() @ xr) * (w3[e].double() @ xr)
            y[r] = w2[e].double() @ h
    return y


def test_k11_plain_version_matches_one_row_at_a_time():
    e, i, h = 5, 24, 16
    g = torch.Generator().manual_seed(6)
    w1, w3, w2 = (torch.randn(s, generator=g, dtype=torch.float64)
                  for s in ((e, i, h), (e, i, h), (e, h, i)))
    x = torch.randn(11, h, generator=g, dtype=torch.float64)
    src, offsets = _rows(11, 2, e, 7, valid_share=0.7)
    before = grouped_swiglu.launches
    got = grouped_swiglu(x, src, offsets, w1, w3, w2)
    want = _per_row(x, src, offsets, w1, w3, w2)
    assert (got - want).abs().max() <= 1e-12
    used = int(offsets[-1])
    assert torch.equal(got[used:], torch.zeros_like(got[used:]))
    assert grouped_swiglu.launches == before     # the CPU takes the plain


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _banks(cuda, e=32, i=1792, h=2048, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [0.02 * torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
            for s in ((e, i, h), (e, i, h), (e, h, i))]


@pytest.mark.cuda
@pytest.mark.parametrize("tokens,valid_share", [(128, 1.0), (2048, 0.3)])
def test_k11_matches_plain_on_card(cuda, tokens, valid_share):
    """A decode step (128 lanes, top-4 of 32) and a prefill call (4 x 512
    slots, 30 % real) at LFM2-8B-A1B's widths."""
    w1, w3, w2 = _banks(cuda)
    x = torch.randn(tokens, 2048, device=cuda).to(torch.bfloat16)
    src, offsets = _rows(tokens, 4, 32, 8, valid_share, cuda)
    before = grouped_swiglu.launches
    got = grouped_swiglu(x, src, offsets, w1, w3, w2)
    torch.cuda.synchronize()
    assert grouped_swiglu.launches == before + 1
    want = grouped_swiglu_ref(x, src, offsets, w1, w3, w2)
    used = int(offsets[-1])
    err = (got[:used].float() - want[:used].float()).abs()
    bound = rounding_bound(x, src, offsets, w1, w3, w2)
    assert (err <= bound[:used]).all(), float(err.max())


@pytest.mark.cuda
def test_k11_in_a_graph_reads_the_routing_from_the_device(cuda):
    """Captured once, replayed after the offsets and rows changed in
    place: the replay follows the new routing."""
    w1, w3, w2 = _banks(cuda, e=8, i=256, h=128)
    x = torch.randn(64, 128, device=cuda).to(torch.bfloat16)
    src, offsets = _rows(64, 2, 8, 9, 1.0, cuda)
    grouped_swiglu(x, src, offsets, w1, w3, w2)        # compile, warm
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = grouped_swiglu(x, src, offsets, w1, w3, w2)
    src2, offsets2 = _rows(64, 2, 8, 10, 0.5, cuda)
    src.copy_(src2)
    offsets.copy_(offsets2)
    graph.replay()
    torch.cuda.synchronize()
    want = grouped_swiglu_ref(x, src, offsets, w1, w3, w2)
    used = int(offsets[-1])
    err = (out[:used].float() - want[:used].float()).abs()
    bound = rounding_bound(x, src, offsets, w1, w3, w2)
    assert (err <= bound[:used]).all()
