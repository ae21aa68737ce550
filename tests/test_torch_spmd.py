"""The port's cross-process SPMD check (kubeflow_tpu_torch/parallel/
spmd_check.py) on its four variants at 2 processes over gloo on the CPU:
each variant's per-step losses across the ranks within RTOL (2e-3) of
the same loop's world-1 run on the same global batch."""

import sys

import pytest

from kubeflow_tpu_torch.parallel import spmd_check


@pytest.mark.parametrize("variant", spmd_check.VARIANTS)
def test_variant_matches_world1(variant, tmp_path):
    got = spmd_check.check(variant, str(tmp_path), n_processes=2,
                           device="cpu")
    assert len(got["multi"]) == spmd_check.CHECK_STEPS
    assert all(0 < x < 10 for x in got["multi"]), got


def test_variant_plans_cross_the_ranks():
    """At 2 ranks every variant puts its own axis across them."""
    from kubeflow_tpu_torch.parallel.mesh import _factor

    for variant, axis in (("tp_fsdp", 3), ("cp", 2), ("ep", 1), ("pp", 0)):
        kw, _ = spmd_check.variant_plan(variant, 2)
        plan = _factor(2, kw.get("tp"), kw.get("pp"), kw.get("cp"))
        assert plan[axis] == 2, (variant, plan)
    assert spmd_check.variant_plan("ep", 2)[1] == {"n_experts": 2}


def test_a_failing_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="rc=3"):
        spmd_check.run_ranks([sys.executable, "-c", "import sys; sys.exit(3)"],
                             2, timeout=60)
    outs = spmd_check.run_ranks(
        [sys.executable, "-c", "import os; print(os.environ['KFX_PROCESS_ID'])"],
        2, timeout=60)
    assert [o.strip() for _, o, _ in outs] == ["0", "1"]
