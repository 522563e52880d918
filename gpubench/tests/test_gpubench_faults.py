"""The check of ``correct`` fails a run whose timed path is broken
underneath: a run at a tiny size on the CPU, past the harness's look for a
card, with a served token altered where it is produced, or an answer cut
short."""

import pytest

from gpubench import run as R, spec
from gpubench.tests import tiny

LIMIT = {"max_logit_gap": 1e-3, "mean_logit_gap": 1e-4}  # tiny fp32: ~1e-6


@pytest.fixture(autouse=True)
def tiny_limit(monkeypatch):
    monkeypatch.setattr(spec, "limits", lambda name: LIMIT)


def _run(mix, seed=11, seconds=1.5):
    result, checks, _ = R.run_cell(tiny.cell(mix), seed, seconds, False,
                                   device="cpu")
    return result, checks


@pytest.mark.parametrize("mix", ["chat", "backlog", "calls"])
def test_sound_run_is_correct(mix):
    result, checks = _run(mix)
    assert result["correct"], checks
    assert checks["max_logit_gap"]["value"] <= LIMIT["max_logit_gap"]


@pytest.mark.parametrize("mix", ["chat", "backlog"])
def test_altered_token_in_the_engine_fails(mix, monkeypatch):
    from vyomai_tpu_torch.serving.engine import ContinuousBatchEngine
    orig = ContinuousBatchEngine._append_token

    def altered(self, state, tok):
        if len(state.tokens) - state.prompt_len == 2:
            tok = (tok + 1) % self.cfg.vocab_size
        return orig(self, state, tok)
    monkeypatch.setattr(ContinuousBatchEngine, "_append_token", altered)
    result, checks = _run(mix)
    assert not result["correct"]
    assert checks["max_logit_gap"]["value"] > LIMIT["max_logit_gap"]


def test_altered_token_in_generate_fails(monkeypatch):
    from gpubench.entries import generate
    orig = generate.Entry._call

    def altered(self, ids):
        out = orig(self, ids)
        out[-1, -1] = (out[-1, -1] + 1) % self.cfg["vocab_size"]
        return out
    monkeypatch.setattr(generate.Entry, "_call", altered)
    result, checks = _run("calls")
    assert not result["correct"]


def test_altered_late_token_fails_the_late_mean(monkeypatch):
    """A cell whose limits name the late mean reads its requests whole
    and compares the mean gap of their last tokens: a token altered at
    the end of every request fails it."""
    from vyomai_tpu_torch.serving.engine import ContinuousBatchEngine
    late = dict(LIMIT, late_mean_logit_gap=1e-4)
    monkeypatch.setattr(spec, "limits", lambda name: late)
    result, checks = _run("backlog")
    assert result["correct"], checks
    assert checks["late_mean_logit_gap"]["value"] <= 1e-4
    orig = ContinuousBatchEngine._append_token

    def altered(self, state, tok):
        if len(state.tokens) - state.prompt_len == state.max_new - 1:
            tok = (tok + 1) % self.cfg.vocab_size
        return orig(self, state, tok)
    monkeypatch.setattr(ContinuousBatchEngine, "_append_token", altered)
    result, checks = _run("backlog")
    assert not result["correct"]
    assert checks["late_mean_logit_gap"]["value"] > 1e-4


def test_answer_cut_short_fails(monkeypatch):
    from vyomai_tpu_torch.serving.engine import ContinuousBatchEngine
    orig = ContinuousBatchEngine.submit

    def short(self, prompt, *, max_new_tokens=None):
        return orig(self, prompt, max_new_tokens=max(1, max_new_tokens - 1))
    monkeypatch.setattr(ContinuousBatchEngine, "submit", short)
    result, checks = _run("chat")
    assert not result["correct"] and checks["wrong_length"]["value"] > 0
