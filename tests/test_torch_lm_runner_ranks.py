"""The port's LM runner across processes on gloo/CPU: the reference's
TestLMRunnerE2E cases at 4 ranks (tp2 + fsdp + sp with a crash at step 8
and the resume from step 5's checkpoint; the pipeline plan declared
through KFX_PARALLELISM), the rows fed by data coordinate (tp peers feed
the same rows, so tp2 at 2 ranks trains the world-1 losses), and dp2
with --collective-overlap on (the collective_allreduce line, the
train.collective span, and the losses of the same run with overlap
off: the buckets reduced during the backward sum what the buckets
reduced after it sum)."""

import json
import os
import re
import sys

import pytest

from kubeflow_tpu_torch.parallel.spmd_check import run_ranks
from kubeflow_tpu_torch.runners import lm_runner

TINY = ["--preset=tiny", "--dataset=lm-tiny", "--seq-len=32",
        "--batch-size=16", "--device", "cpu"]
RUNNER = [sys.executable, "-m", "kubeflow_tpu_torch.runners.lm_runner"]
RTOL = 2e-3
# One intra-op thread a rank: the ranks share this machine's cores.
ONE = {"OMP_NUM_THREADS": "1"}


def _losses(out):
    return [float(x) for x in re.findall(r"^step=\d+ loss=(\S+)", out, re.M)]


def _world1(argv, capsys):
    assert lm_runner.main(TINY + argv) == 0
    return capsys.readouterr().out


def test_runner_full_stack_with_crash_resume(tmp_path):
    argv = RUNNER + TINY + ["--steps=12", "--log-every=4",
                            "--checkpoint-every=5", "--tp=2", "--fsdp",
                            "--sp"]
    env = {"KFX_CHECKPOINT_DIR": str(tmp_path / "ckpt"), **ONE}
    outs = run_ranks(argv + ["--fail-at-step=8"], 4, env=env, check=False,
                     cwd=str(tmp_path))
    assert [rc for rc, _, _ in outs] == [17] * 4, outs
    assert "plan=pp1/dp2/tp2/fsdp/sp" in outs[0][1]
    outs = run_ranks(argv, 4, env=env, cwd=str(tmp_path))
    for _, out, _ in outs:
        assert "resumed_from_checkpoint step=5" in out
        assert "train_done steps=12" in out
    # Every rank reports the global loss.
    assert len({tuple(_losses(o)) for _, o, _ in outs}) == 1


def test_runner_pipeline(tmp_path):
    """Pipeline declared through the operator's KFX_PARALLELISM (no CLI
    mesh flags): pp2 x tp2 at 4 ranks, 4 microbatches."""
    env = {"KFX_PARALLELISM":
           '{"pipeline": 2, "tensor": 2, "microbatches": 4}', **ONE}
    outs = run_ranks(RUNNER + TINY + ["--steps=6", "--log-every=3",
                                      "--no-checkpoint"], 4, env=env,
                     cwd=str(tmp_path))
    assert "plan=pp2/dp1/tp2" in outs[0][1]
    assert all("train_done steps=6" in o for _, o, _ in outs)


def test_runner_feeds_rows_by_data_coordinate(tmp_path, capsys):
    """tp peers feed the same rows: tp2 at 2 ranks (dp 1) consumes the
    world-1 batches and trains the world-1 losses (fed by rank, rank 1
    would take another half of the rows and the losses would differ)."""
    argv = ["--steps=4", "--log-every=1", "--no-checkpoint"]
    want = _world1(argv, capsys)
    outs = run_ranks(RUNNER + TINY + argv + ["--tp=2"], 2, env=ONE,
                     cwd=str(tmp_path))
    assert "plan=pp1/dp1/tp2" in outs[0][1]
    for _, out, _ in outs:
        got = _losses(out)
        assert len(got) == 3
        assert got == pytest.approx(_losses(want), rel=RTOL)
        final = float(re.search(r"^loss=(\S+)$", out, re.M).group(1))
        assert final == pytest.approx(float(re.search(
            r"^loss=(\S+)$", want, re.M).group(1)), rel=RTOL)


def test_runner_dp2_collective_overlap(tmp_path):
    argv = RUNNER + TINY + ["--steps=4", "--log-every=1", "--no-checkpoint"]
    work = tmp_path / "work"
    outs = run_ranks(argv + ["--collective-overlap", "on"], 2,
                     env={"KFX_WORKDIR": str(work), **ONE},
                     cwd=str(tmp_path))
    out = outs[0][1]
    assert "plan=pp1/dp2/tp1" in out
    m = re.search(r"^collective_allreduce axis=data ways=2 grad_bytes=(\d+) "
                  r"est_seconds_per_step=(\S+)$", out, re.M)
    assert m and int(m.group(1)) == 4 * int(re.search(
        r"model_params=(\d+)", out).group(1))
    off = run_ranks(argv + ["--collective-overlap", "off"], 2, env=ONE,
                    cwd=str(tmp_path))[0][1]
    assert _losses(out) == pytest.approx(_losses(off), rel=RTOL)
    assert len(_losses(out)) == 3
    spans = [json.loads(line) for f in os.listdir(work / "spans")
             for line in open(work / "spans" / f)]
    names = {s["name"] for s in spans}
    assert {"train.collective", "train.window", "xla.compile"} <= names
    coll = [s for s in spans if s["name"] == "train.collective"]
    assert all(s["attrs"]["axis"] == "data" and s["attrs"]["ways"] == "2"
               for s in coll)
