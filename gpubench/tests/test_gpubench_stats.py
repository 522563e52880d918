"""Percentiles and rates over every request and the whole window, on
hand-made timelines."""

import pytest

from gpubench import spec, stats


def _req(due, times, max_new=None):
    return {"due": due, "first": times[0] if times else None,
            "last": times[-1] if times else None, "n": len(times),
            "times": times, "tokens": [0] * len(times),
            "max_new": max_new or len(times),
            "done": times[-1] if times else None}


def _run(reqs, t0=0.0, t1=10.0, setup=5.0):
    return {"requests": reqs, "t0": t0, "t1": t1, "setup_s": setup}


def test_ttft_counts_from_due_not_from_submit():
    reqs = [_req(float(i), [i + 0.1 * (i + 1)]) for i in range(20)]
    for r in reqs:
        r["submit"] = r["first"] - 0.01      # late submission is hidden
    m = spec.e2e_metrics()["ttft_p95_ms"]
    ttft = [0.1 * (i + 1) for i in range(20)]
    assert m.read(_run(reqs)) == pytest.approx(
        stats.percentile(ttft, 95) * 1e3)
    assert m.read(_run(reqs)) == pytest.approx(1905.0)


def test_tpot_over_requests_with_two_tokens_or_more():
    reqs = [_req(0.0, [1.0, 1.5, 2.0]),     # 0.5 s a token
            _req(0.0, [1.0, 1.1]),          # 0.1
            _req(0.0, [3.0])]               # one token: left out
    v = spec.e2e_metrics()["tpot_p95_ms"].read(_run(reqs))
    assert v == pytest.approx((0.1 + 0.95 * 0.4) * 1e3)


def test_rate_counts_tokens_inside_the_window_only():
    reqs = [_req(0.0, [0.5, 1.0, 9.9, 10.5]), _req(0.0, [-1.0, 2.0])]
    v = spec.e2e_metrics()["output_tok_s"].read(_run(reqs, 0.0, 10.0))
    assert v == pytest.approx(4 / 10.0)


def test_percentile_is_over_all_values():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 95) == pytest.approx(95.05)
    assert stats.percentile([], 95) is None


def test_setup_s_is_the_runs():
    assert spec.e2e_metrics()["setup_s"].read(_run([], setup=12.5)) == 12.5
