"""The traffic generator: a seed fixes the inputs, the mix fixes the sizes."""

import numpy as np
import pytest

from gpubench import spec, traffic as T
from gpubench.tests import tiny

SEED = 2 ** 31 + 12345


def _key(reqs):
    return [(r.prompt.tolist(), r.max_new, r.due, r.prefix) for r in reqs]


@pytest.mark.parametrize("mix", ["chat", "batch_offline", "batch_reasoning",
                                 "generate_static"])
def test_mix_regenerates_identically_from_a_seed(mix):
    m = spec.traffic(mix)
    a = T.requests(m, SEED, 32768, 30)
    b = T.requests(m, SEED, 32768, 30)
    assert _key(a) == _key(b)
    c = T.requests(m, SEED + 1, 32768, 30)
    assert _key(a) != _key(c)


@pytest.mark.parametrize("mix", ["chat", "batch_offline", "batch_reasoning"])
def test_seeds_share_the_multiset_of_sizes(mix):
    m = spec.traffic(mix)
    a = T.requests(m, 1, 32768, 30)
    b = T.requests(m, 2, 32768, 30)
    assert sorted((len(r.prompt), r.max_new) for r in a) == \
        sorted((len(r.prompt), r.max_new) for r in b)
    assert [r.max_new for r in a] != [r.max_new for r in b]


def test_open_loop_due_inside_the_window_at_the_rate():
    m = spec.traffic("chat")
    reqs = T.requests(m, SEED, 151936, 30)
    due = np.array([r.due for r in reqs])
    assert len(reqs) == T.count(m, 30)
    assert due[0] == 0 and np.all(np.diff(due) > 0) and due[-1] < 30
    assert len(reqs) == int(np.ceil(m["arrivals"]["rate_per_s"] * 30))


def test_lengths_stay_in_their_clips():
    m = spec.traffic("chat")
    reqs = T.requests(m, SEED, 151936, 30)
    pre = m["shared_prefix"]["length"]
    for r in reqs:
        assert 16 <= r.max_new <= 512
        assert pre["min"] + 16 <= len(r.prompt) <= pre["max"] + 1024
    assert T.longest(m) == 1536 + 1024 + 512


def test_shared_prefixes_are_shared_and_zipf_skewed():
    m = spec.traffic("chat")
    reqs = T.requests(m, SEED, 151936, 30)
    by = {}
    for r in reqs:
        by.setdefault(r.prefix, []).append(r)
    assert min(by) >= 0
    counts = sorted((len(v) for v in by.values()), reverse=True)
    assert counts[0] > 3 * counts[len(counts) // 2]
    for k, rs in by.items():
        n = min(len(x.prompt) for x in rs)
        heads = {tuple(x.prompt[:min(n, 512)]) for x in rs}
        assert len(heads) == 1


def test_gamma_arrivals_are_burstier_than_poisson():
    g = T.rng(7)
    pois = T.gaps(g, {"process": "poisson", "rate_per_s": 10}, 20000)
    gam = T.gaps(g, {"process": "gamma", "rate_per_s": 10, "cv": 3}, 20000)
    cv = lambda x: x.std() / x.mean()
    assert abs(cv(pois) - 1) < 0.05 and abs(cv(gam) - 3) < 0.3
    assert abs(gam.mean() - 0.1) < 0.01


def test_any_whole_seed_is_taken():
    m = tiny.MIXES["backlog"]
    for seed in (0, -5, 2 ** 31 + 1, 2 ** 70):
        assert len(T.requests(m, seed, 256, 1)) == m["requests"]


def test_calls_mix_gives_batches_of_fixed_prompts():
    m = spec.traffic("generate_static")
    reqs = T.requests(m, SEED, 151936, 30)
    assert len(reqs) == m["calls"] * m["batch"]
    assert {len(r.prompt) for r in reqs} == {m["prompt_len"]}
    assert {r.max_new for r in reqs} == {m["new_tokens"]}
