"""The control at a tiny size: the reference in float8 products, put in
the program's place, fails a number of each cell that the program passes.
The readings that set the limits were taken on the card at the cells'
own sizes with ``control.py`` (PERF.md gives them)."""

from __future__ import annotations

import pytest

from conftest import tiny_context
from kfxbench import control
from kfxbench.core import compare


def _fails(numbers, limits):
    return [n for n, v in numbers.items() if v > limits[n]]


def test_training_control_fails_and_program_passes():
    ctx = tiny_context("coder1.3b-train-s4k", seed=2 ** 31 + 77)
    got = control.train_readings(ctx, control=True)
    assert not _fails(got["program"], ctx.limits), got
    assert _fails(got["fp8"], ctx.limits), got
    assert _fails(got["half_batch"], ctx.limits), got


@pytest.mark.parametrize("workload", ["dsllm7b-serve-chat",
                                      "dsllm7b-serve-sessions"])
def test_serving_control_fails_and_program_passes(workload):
    ctx = tiny_context(workload, seed=2 ** 31 + 78, seconds=5.0)
    # Some hundreds of served tokens, as on the card.
    ctx.traffic["output"] = dict(median=48, sigma=0.5, min=24, max=96)
    got = control.serve_readings(ctx, control=True)
    assert got["notes"]["checked_tokens"] >= 100
    assert not _fails(got["program"], ctx.limits), got
    assert _fails(got["fp8"], ctx.limits), got
    assert compare.passed(compare.checks(got["program"], ctx.limits))
