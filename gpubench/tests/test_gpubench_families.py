"""The model-family seam (``families/``, found by a configuration's
``"family"`` key, ``dense`` by default).

The dense family is pinned to the harness as it stood before families were
looked up by name: its weight layout, the bytes of every seeded group, its
reference's gaps and every count of ``work.py`` and of the K1, K4 and K8
readers, for the tiny configuration and both published ones, are literals
read from that harness. A toy family, defined here only and found through
the lookup alone, shows that ``build_model``, ``make_group``,
``served_gaps`` and ``work``'s counts reach a family that no file of the
harness names, with a weight the dense family lacks and fewer attention
layers than layers.
"""

import hashlib
import json
import sys
import types

import numpy as np
import pytest
import torch

from gpubench import program, run as R, spec, work, weights as W
from gpubench.families import dense
from gpubench.reference import common as C
from gpubench.tests import tiny

SEED = 2 ** 31 + 77
CONFIGS = {"tiny": tiny.CONFIG,
           "qwen3-0.6b": spec.load_json(spec.HERE / "configs/qwen3-0.6b.json"),
           "mistral-7b-v0.3-int8": spec.load_json(
               spec.HERE / "configs/mistral-7b-v0.3-int8.json")}

# -- the dense family as the harness had it, pinned ---------------------------

# (groups, first, last, sha256 of every group's (name, shape, is_norm))
LAYOUT = {
    "tiny": (4, "embed", "final",
             "967956dfea548c52ed0216afd54e02eb3eedc61c2679d1e68efa05bb749da41a"),
    "qwen3-0.6b": (30, "embed", "final",
                   "162134262cb48884ed1a95a9b808209c1d72b898808cdea787a38afcdf5f9da0"),
    "mistral-7b-v0.3-int8": (35, "embed", "head",
                             "01f7b2114d143eafad84c61cbf58deb6eb3f257cb0fc2550a6b4e786142e402c"),
}
TINY_LAYER_1 = [
    ("layers.1.input_layernorm.weight", (64,), True),
    ("layers.1.post_attention_layernorm.weight", (64,), True),
    ("layers.1.self_attn.q_norm.weight", (16,), True),
    ("layers.1.self_attn.k_norm.weight", (16,), True),
    ("layers.1.self_attn.q_proj.weight", (64, 64), False),
    ("layers.1.self_attn.k_proj.weight", (32, 64), False),
    ("layers.1.self_attn.v_proj.weight", (32, 64), False),
    ("layers.1.self_attn.o_proj.weight", (64, 64), False),
    ("layers.1.mlp.gate_proj.weight", (128, 64), False),
    ("layers.1.mlp.up_proj.weight", (128, 64), False),
    ("layers.1.mlp.down_proj.weight", (64, 128), False),
]
# sha256 over each tensor's name and bytes, tiny config, seed SEED, std 0.02
GROUPS = {
    "float32": {
        "embed": "7283ee201a7a5638127bd27ed29999cb17f36cb06413b129ecabc93b7e169f28",
        "layer.0": "ad9421e1c4c0f9f26c874020cdbf1984ddb147e9d8331249d1de03b2cf5a8d99",
        "layer.1": "790c18657f8a448cb78c397c8a36307a33dc7115f767ca6240f0e6eb1b0b56bb",
        "final": "3117dca0300d1a7c2c5ec0a7269f5044b5c595ecf82b2525e50ff466853337d6",
    },
    "bfloat16": {
        "embed": "cdfa11e5d82f3777dd3b2ef99edb428e17cabacb6595c9609559dcbb947d2927",
        "layer.0": "b747a6e414e83955b127d6bc15756793c25472c971ae7297abdf0a2f81ef4d32",
        "layer.1": "5b255ef96f0a1d2030c77300cae977abef50098a3cd0649bdf11364f925c1949",
        "final": "6f384b5d82c56b27c828c2b43da25cf7e8fc0fa81caaee3c549660873915f892",
    },
}
SEQS = [([207, 21, 45, 60, 46, 205, 222, 149, 10, 24, 85, 110], 5),
        ([159, 122, 67, 40, 177, 188, 8, 29, 115], 3)]
# (config changes, weight dtype, reference quant) -> gaps on SEQS
GAPS = {
    "f32": ({}, torch.float32, None, [
        [0.6304061412811279, 0.8375452756881714, 0.9046614170074463,
         1.4595142602920532, 0.7723449468612671, 0.8884148001670837,
         0.967772901058197],
        [0.8321189284324646, 0.47813665866851807, 0.9971134066581726,
         0.8936247825622559, 0.9151921272277832, 0.9276069402694702]]),
    "bf16_int8_untied": ({"tie_word_embeddings": False, "qk_norm": False},
                         torch.bfloat16, "int8", [
        [0.3905830383300781, 0.6422078609466553, 0.5252147912979126,
         0.6105349063873291, 0.3024340569972992, 0.4430207312107086,
         0.40577682852745056],
        [0.36515331268310547, 0.36982226371765137, 0.23871789872646332,
         0.4682328999042511, 0.6127001643180847, 0.6435466408729553]]),
}
COUNTS = {
    "qwen3-0.6b": {
        "dims": {"h": 1024, "i": 3072, "nh": 16, "nkv": 8, "hd": 128,
                 "v": 151936, "layers": 28},
        "linears": [197, 595984384], "token_flops": 1421344768.0,
        "prompt_flops": 652155551744.0,
        "paged_decode.bf16": [283049984.0, 141763216.0],
        "paged_decode.int8": [283049984.0, 71277136.0],
        "weight_only_step": [76286001152.0, 698287616.0],
        "k1_roofline.prefill.ttft": 5.112460099502671,
        "k4_roofline.tok_s": 2.0782118208957514,
        "k8_roofline.decode.tok_s": 9.018482626865664,
        "k8_roofline.prefill.tok_s": 11.18899199999999,
        "k1_roofline.gen": 193.36054447761893},
    "mistral-7b-v0.3-int8": {
        "dims": {"h": 4096, "i": 14336, "nh": 32, "nkv": 8, "hd": 128,
                 "v": 32768, "layers": 32},
        "linears": [225, 7113539584], "token_flops": 14751367168.0,
        "prompt_flops": 7379961774080.0,
        "paged_decode.bf16": [646971392.0, 162277248.0],
        "paged_decode.int8": [646971392.0, 81721728.0],
        "weight_only_step": [910533066752.0, 7459438592.0],
        "k1_roofline.prefill.ttft": 6.468827064676851,
        "k4_roofline.tok_s": 2.390749611940562,
        "k8_roofline.decode.tok_s": 106.57376286567155,
        "k8_roofline.prefill.tok_s": 115.64768668656707,
        "k1_roofline.gen": 228.9547437214013},
}


def _layout_digest(cfg):
    fam = spec.family(cfg)
    items = [[g, [[n, list(s), bool(k)] for n, s, k in fam.shapes(cfg, g)]]
             for g in fam.groups(cfg)]
    return hashlib.sha256(json.dumps(items).encode()).hexdigest()


def _group_digest(cfg, group, dtype):
    h = hashlib.sha256()
    for name, t in W.make_group(cfg, SEED, group, "cpu", dtype, 0.02).items():
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(name.encode())
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def _slice_run():
    """A synthetic traced run (counters over the slice, one request with
    two decode tokens in it) and a trace of one decode replay (K4, K8) and
    one prefill replay (K1, K8)."""
    snaps = {"open": {}, "begin": {}, "end": {}, "close": {}}
    for k, v in {"prefill_attn_pairs": 200_000, "prefill_tokens": 240,
                 "prefill_ctx_tokens": 4_000, "prefill_calls": 2}.items():
        snaps["open"][k], snaps["begin"][k] = 7, 9
        snaps["end"][k], snaps["close"][k] = 9 + v, 99 + v
    run = {"counters": snaps, "t0": 0.0, "t1": 51.0, "slice": (20.0, 24.0),
           "pool": "bfloat16", "lanes": 4, "block_size": 16,
           "requests": [{"prompt": [0] * 300, "first": 20.5,
                         "times": [20.5, 21.0, 22.0, 30.0]}]}
    g = "cudaGraphLaunch"
    trace = {"kernels": [
        ("paged_decode_split_kernel", 1.0, 1.001, g, 1),
        ("int8_matmul_kernel_tc<1, 1>", 1.0, 1.002, g, 1),
        ("vyomai::flash_fwd_kernel_tc<128>", 1.0, 1.003, g, 3),
        ("int8_matmul_kernel_tc<1, 1>", 1.0, 1.004, g, 3)]}
    gen = {"calls": [(1.0, 2.0)], "batch": 16, "prompt_len": 128,
           "new_tokens": 64}
    return run, trace, gen


def _counts(cfg):
    mats = work.linears(cfg)
    run, trace, gen = _slice_run()
    mods, cell = spec.layer_metrics(), {"config": cfg}
    out = {"linears": [len(mats), sum(n * k for n, k in mats)],
           "token_flops": work.token_flops(cfg, 1000),
           "prompt_flops": work.prompt_flops(cfg, 100, 612),
           "paged_decode.bf16": list(work.paged_decode(cfg, 1234, "bfloat16",
                                                       16)),
           "paged_decode.int8": list(work.paged_decode(cfg, 1234, "int8",
                                                       16)),
           "weight_only_step": list(work.weight_only_step(cfg, 64, 8)),
           "k1_roofline.gen": mods["k1_roofline.gen"].read(gen, trace, cell)}
    for name in ("k1_roofline.prefill.ttft", "k4_roofline.tok_s",
                 "k8_roofline.decode.tok_s", "k8_roofline.prefill.tok_s"):
        out[name] = mods[name].read(run, trace, cell)
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_configs_without_a_family_key_are_dense(name):
    assert "family" not in CONFIGS[name]
    assert spec.family(CONFIGS[name]) is dense


@pytest.mark.parametrize("name", sorted(LAYOUT))
def test_dense_layout_is_the_parents(name):
    cfg = CONFIGS[name]
    gs = dense.groups(cfg)
    assert (len(gs), gs[0], gs[-1], _layout_digest(cfg)) == LAYOUT[name]


def test_dense_tiny_layer_is_the_parents():
    assert dense.shapes(tiny.CONFIG, "layer.1") == TINY_LAYER_1


@pytest.mark.parametrize("dtype", sorted(GROUPS))
def test_dense_weights_are_the_parents_bit_for_bit(dtype):
    assert {g: _group_digest(tiny.CONFIG, g, W.DTYPES[dtype])
            for g in dense.groups(tiny.CONFIG)} == GROUPS[dtype]


@pytest.mark.parametrize("label", sorted(GAPS))
def test_dense_reference_gives_the_parents_gaps(label):
    """The same gaps up to float32 rounding of the summation order, which
    the number of CPU threads may change."""
    changes, wdt, quant, want = GAPS[label]
    cfg = dict(tiny.CONFIG, **changes)
    seqs = [(np.array(t), n) for t, n in SEQS]
    got = spec.family(cfg).served_gaps(cfg, SEED, seqs, "cpu",
                                       weight_dtype=wdt, std=0.02,
                                       quant=quant)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_counts_are_the_parents(name):
    """``work.py``'s counts and the K1, K4 and K8 readers on a synthetic
    slice read what they read before the seam; every layer of a dense
    model holds KV."""
    cfg, want = CONFIGS[name], COUNTS[name]
    d = work.dims(cfg)
    assert d == dict(want["dims"], attn_layers=want["dims"]["layers"])
    got = _counts(cfg)
    assert set(got) == set(want) - {"dims"}
    for key, value in got.items():
        assert value == pytest.approx(want[key], rel=1e-12), key


# -- a toy family, defined here only ------------------------------------------

TOY = dict(tiny.CONFIG, name="toy", family="toy", num_hidden_layers=3,
           toy_attn_layers=1)


def _toy_groups(cfg):
    return ["embed"] + [f"layer.{i}" for i in range(
        cfg["num_hidden_layers"])] + ["final"]


def _toy_attn(cfg, i):
    return i < cfg["toy_attn_layers"]


def _toy_shapes(cfg, group):
    """The first ``toy_attn_layers`` layers mix over positions (a causal
    running mean through v and o); the others mix each position alone
    through ``mixer.in_proj`` and a gate the dense family has no
    counterpart of. Every layer ends in a SiLU MLP."""
    h, i, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    if group == "embed":
        return [("embed_tokens.weight", (v, h), False)]
    if group == "final":
        return [("norm.weight", (h,), True)]
    li = int(group.split(".")[1])
    p = f"layers.{li}."
    mix = ([(p + "attn.v_proj.weight", (h, h), False),
            (p + "attn.o_proj.weight", (h, h), False)] if _toy_attn(cfg, li)
           else [(p + "mixer.in_proj.weight", (h, h), False),
                 (p + "mixer.gate.weight", (h,), True)])
    return [(p + "norm.weight", (h,), True),
            (p + "mlp_norm.weight", (h,), True)] + mix + [
        (p + "mlp.up_proj.weight", (i, h), False),
        (p + "mlp.down_proj.weight", (h, i), False)]


def _toy_linears(cfg):
    h, i = cfg["hidden_size"], cfg["intermediate_size"]
    out = []
    for li in range(cfg["num_hidden_layers"]):
        out += [(h, h)] * (2 if _toy_attn(cfg, li) else 1)
        out += [(i, h), (h, i)]
    return out + [(cfg["vocab_size"], h)]


def _toy_layer(h, p, pre, cfg, attn):
    eps = cfg["rms_norm_eps"]
    x = C.rms(h, p[pre + "norm.weight"], eps)
    if attn:
        v = x @ p[pre + "attn.v_proj.weight"].T
        n = torch.arange(1, x.shape[0] + 1, dtype=x.dtype)[:, None]
        h = h + (v.cumsum(0) / n) @ p[pre + "attn.o_proj.weight"].T
    else:
        h = h + (x @ p[pre + "mixer.in_proj.weight"].T) \
            * p[pre + "mixer.gate.weight"]
    x = C.rms(h, p[pre + "mlp_norm.weight"], eps)
    up = torch.nn.functional.silu(x @ p[pre + "mlp.up_proj.weight"].T)
    return h + up @ p[pre + "mlp.down_proj.weight"].T


@torch.no_grad()
def _toy_served_gaps(cfg, seed, seqs, device, *, weight_dtype, std, quant,
                     head_rows=256):
    with C.float32_products():
        args = (device, weight_dtype, std, quant)
        toks = C.tokens(seqs, device)
        emb = C.group(cfg, seed, "embed", *args)["embed_tokens.weight"]
        hs = [emb[t] for t in toks]
        for li in range(cfg["num_hidden_layers"]):
            p = C.group(cfg, seed, f"layer.{li}", *args)
            hs = [_toy_layer(h, p, f"layers.{li}.", cfg, _toy_attn(cfg, li))
                  for h in hs]
        norm = C.group(cfg, seed, "final", *args)["norm.weight"]
        return C.head_gaps(seqs, toks, hs, norm, emb, cfg["rms_norm_eps"],
                           head_rows)


class _ToyModel(torch.nn.Module):
    """The toy's "port": a parameter at every path its shapes name, and a
    forward over them (the layer math is the toy reference's own)."""

    def __init__(self, cfg, device, dtype):
        super().__init__()
        self.cfg = cfg
        for group in _toy_groups(cfg):
            for name, shape, _ in _toy_shapes(cfg, group):
                *path, leaf = name.split(".")
                mod = self
                for part in path:
                    if not hasattr(mod, part):
                        mod.add_module(part, torch.nn.Module())
                    mod = getattr(mod, part)
                mod.register_parameter(leaf, torch.nn.Parameter(
                    torch.empty(shape, device=device, dtype=dtype)))

    @torch.no_grad()
    def forward(self, ids):
        cfg = self.cfg
        p = {n: w.float() for n, w in self.named_parameters()}
        h = p["embed_tokens.weight"][ids]
        for li in range(cfg["num_hidden_layers"]):
            h = _toy_layer(h, p, f"layers.{li}.", cfg, _toy_attn(cfg, li))
        x = C.rms(h, p["norm.weight"], cfg["rms_norm_eps"])
        return x @ p["embed_tokens.weight"].T


@pytest.fixture
def toy(monkeypatch):
    """``gpubench.families.toy``, put where the lookup finds a module."""
    mod = types.ModuleType("gpubench.families.toy")
    mod.port_model = _ToyModel
    mod.groups, mod.shapes = _toy_groups, _toy_shapes
    mod.served_gaps = _toy_served_gaps
    mod.linears = _toy_linears
    mod.attn_layers = lambda cfg: cfg["toy_attn_layers"]
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    return mod


def test_toy_weights_come_through_the_lookup(toy):
    a = W.make_group(TOY, SEED, "layer.2", "cpu", torch.float32, 0.02)
    assert [(n, tuple(t.shape)) for n, t in a.items()] == [
        (n, s) for n, s, _ in _toy_shapes(TOY, "layer.2")]
    assert "layers.2.mixer.gate.weight" in a
    assert not any("attn" in n for n in a)
    # one seeding for every family: the same group index and shapes give
    # the dense family's bytes
    t, d = (W.make_group(c, SEED, "embed", "cpu", torch.float32, 0.02)
            for c in (TOY, tiny.CONFIG))
    assert torch.equal(t["embed_tokens.weight"], d["embed_tokens.weight"])


def test_toy_model_and_reference_come_through_the_lookup(toy):
    model = program.build_model(TOY, SEED, "cpu")
    assert isinstance(model, _ToyModel)
    for group in _toy_groups(TOY):
        for name, t in W.make_group(TOY, SEED, group, "cpu", torch.float32,
                                    0.02).items():
            assert torch.equal(model.get_parameter(name), t), name
    ids = list(np.random.default_rng(9).integers(0, 256, 7))
    for _ in range(6):
        ids.append(int(model(torch.tensor(ids))[-1].argmax()))
    seqs = [(np.array(ids), 7)]
    served = spec.family(TOY).served_gaps(TOY, SEED, seqs, "cpu",
                                          weight_dtype=torch.float32,
                                          std=0.02, quant=None)
    assert served[0].shape == (6,) and served[0].max() <= 1e-6
    ids[-2] = (ids[-2] + 1) % 256
    altered = _toy_served_gaps(TOY, SEED, [(np.array(ids), 7)], "cpu",
                               weight_dtype=torch.float32, std=0.02,
                               quant=None)
    assert altered[0][-2] > 1e-4


def test_toy_counts_come_through_the_lookup(toy):
    """Attention's work is counted in the one layer that holds KV; each
    token's matmuls are the toy's own list."""
    one = dict(tiny.CONFIG, num_hidden_layers=1)
    d = work.dims(TOY)
    assert (d["layers"], d["attn_layers"]) == (3, 1)
    # layer 0: v, o 64x64, up, down 128x64; layers 1-2: in_proj, up, down;
    # head 256x64
    assert sum(n * k for n, k in work.linears(TOY)) == \
        (2 * 4096 + 2 * 8192) + 2 * (4096 + 2 * 8192) + 16384
    assert work.token_flops(TOY, 10) == 2 * 81920 + 4 * 1 * 4 * 16 * 10
    assert work.prompt_flops(TOY, 2, 7) == pytest.approx(
        sum(work.token_flops(TOY, p + 1) for p in range(2, 7)))
    assert work.paged_decode(TOY, 5, "int8", 4) == \
        work.paged_decode(one, 5, "int8", 4)
    f, b = work.weight_only_step(TOY, 2, 8)
    assert f == sum(4 * n * k for n, k in _toy_linears(TOY))
    run, trace, gen = _slice_run()
    mods = spec.layer_metrics()
    for name in ("k1_roofline.prefill.ttft", "k4_roofline.tok_s"):
        assert mods[name].read(run, trace, {"config": TOY}) == \
            pytest.approx(mods[name].read(run, trace, {"config": one}),
                          rel=1e-12)
    assert mods["k1_roofline.gen"].read(gen, trace, {"config": TOY}) == \
        pytest.approx(mods["k1_roofline.gen"].read(gen, trace,
                                                   {"config": one}))


def test_run_reaches_a_family_by_name(monkeypatch):
    """A whole tiny run of a configuration naming a family that no file of
    the harness names builds its model and checks against its reference
    through the lookup."""
    calls = []
    mod = types.ModuleType("gpubench.families.spy")
    for name in ("groups", "shapes", "linears", "attn_layers"):
        setattr(mod, name, getattr(dense, name))
    mod.port_model = lambda *a: calls.append("port_model") or \
        dense.port_model(*a)
    mod.served_gaps = lambda *a, **k: calls.append("served_gaps") or \
        dense.served_gaps(*a, **k)
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    monkeypatch.setattr(spec, "limits", lambda name: {
        "max_logit_gap": 1e-3, "mean_logit_gap": 1e-4})
    result, _, _ = R.run_cell(tiny.cell("chat", family="spy"), 5, 1.0, False,
                              device="cpu")
    assert calls == ["port_model", "served_gaps"]
    assert result["correct"] is True


@pytest.mark.parametrize("reach", [
    spec.family,
    lambda cfg: program.build_model(cfg, SEED, "cpu"),
    lambda cfg: W.make_group(cfg, SEED, "embed", "cpu"),
    work.dims])
def test_missing_family_names_the_file_it_looked_for(reach):
    cfg = dict(tiny.CONFIG, family="nonesuch")
    with pytest.raises(LookupError, match="gpubench/families/nonesuch.py"):
        reach(cfg)
