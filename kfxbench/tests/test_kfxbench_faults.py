"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell can have; the same run unbroken comes out
correct. The harness's look for a card is skipped: the cells run at a
tiny size on the CPU (``conftest.tiny_context``), with the cells' own
limits."""

from __future__ import annotations

import pytest

from conftest import bench, tiny_context
from kfxbench import run as harness


def _line(ctx):
    rec = harness.drive(bench(), ctx)
    return harness.result_line(rec, ctx, "cpu")


def test_sound_training_run_is_correct():
    line = _line(tiny_context("coder1.3b-train-s4k", seed=2 ** 31 + 5))
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"


def test_training_step_that_returns_its_state_unchanged(monkeypatch):
    from kubeflow_tpu_torch.parallel import lm_train

    monkeypatch.setattr(lm_train.AdamW, "step", lambda self: None)
    line = _line(tiny_context("coder1.3b-train-s4k", seed=7))
    assert not line["correct"]
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_training_on_half_the_batch(monkeypatch):
    from kubeflow_tpu_torch.parallel import lm_train

    whole = lm_train.LMTrainLoop._loss_fn

    def half(self, tokens):
        return whole(self, tokens[: tokens.shape[0] // 2])

    monkeypatch.setattr(lm_train.LMTrainLoop, "_loss_fn", half)
    line = _line(tiny_context("coder1.3b-train-s4k", seed=8))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("workload", ["dsllm7b-serve-chat",
                                      "dsllm7b-serve-sessions"])
def test_sound_serving_run_is_correct(workload):
    line = _line(tiny_context(workload, seed=2 ** 32 + 9))
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("workload", ["dsllm7b-serve-chat",
                                      "dsllm7b-serve-sessions"])
def test_served_token_altered_where_it_is_produced(workload, monkeypatch):
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    collect = DecodeEngine._chunk_collect

    def altered(self, packed):
        toks, emits = collect(self, packed)
        toks[0] = (toks[0] + 1) % self.cfg.vocab_size
        return toks, emits

    monkeypatch.setattr(DecodeEngine, "_chunk_collect", altered)
    line = _line(tiny_context(workload, seed=10))
    assert not line["correct"], line["checks"]
