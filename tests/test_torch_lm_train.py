"""The port's LM train loop and runner (kubeflow_tpu_torch/parallel/
lm_train.py, runners/lm_runner.py) against the reference's LMTrainLoop on
the same init and the same data batches."""

import re
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import optax  # noqa: E402
import torch  # noqa: E402

from kubeflow_tpu.data import lm as ref_data  # noqa: E402
from kubeflow_tpu.models.transformer import TransformerConfig  # noqa: E402
from kubeflow_tpu.parallel.lm_train import (  # noqa: E402
    LMHyperParams as RefHP, LMTrainLoop as RefLoop)
from kubeflow_tpu.parallel.mesh import make_mesh  # noqa: E402
from kubeflow_tpu_torch.data import lm as port_data  # noqa: E402
from kubeflow_tpu_torch.models import transformer as port_tf  # noqa: E402
from kubeflow_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax, params_to_jax)
from kubeflow_tpu_torch.parallel import lm_train as port  # noqa: E402
from kubeflow_tpu_torch.runners import lm_runner  # noqa: E402

SMALL = dict(vocab_size=512, d_model=128, n_heads=2, head_dim=64,
             n_layers=2, d_ff=256, max_seq_len=128)
STEPS = 3


@pytest.mark.parametrize("name", ["lm-tiny", "lm-small"])
def test_data_batches_bit_identical(name):
    a = ref_data.get_lm_dataset(name, seed=3, seq_len=64)
    b = port_data.get_lm_dataset(name, seed=3, seq_len=64)
    for x, y in zip(a.batches(4, steps=2), b.batches(4, steps=2)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.eval_batch(2), b.eval_batch(2))
    assert a.entropy_floor() == b.entropy_floor()


@pytest.mark.parametrize("count", [0, 1, 2, 5, 9, 10, 11, 50, 99, 100, 150])
@pytest.mark.parametrize("warmup,total", [(1, 3), (10, 100), (0, 20),
                                          (30, 10)])
def test_lr_schedule_matches_optax(count, warmup, total):
    decay = max(total, warmup + 1)
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, decay)
    # optax evaluates the cosine in f32: agree to f32 rounding of the peak.
    assert port.warmup_cosine_lr(count, 3e-4, warmup, decay) == \
        pytest.approx(float(sched(count)), rel=1e-5, abs=3e-4 * 1e-6)


def test_three_steps_match_reference():
    """3 optimizer steps (warmup 1, so the first update has lr 0) from the
    same init on the same batches: per-step loss rel <= 1e-4, final params
    abs <= 1e-4."""
    ds = ref_data.LMDataset(vocab_size=SMALL["vocab_size"],
                            seq_len=SMALL["max_seq_len"], seed=0)
    batches = list(ds.batches(4, steps=STEPS))
    hp_kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=STEPS,
                 seed=0)

    import jax.numpy as jnp

    mesh, plan = make_mesh(1)
    ref_loop = RefLoop(TransformerConfig(**SMALL, dtype=jnp.float32), mesh,
                       plan, RefHP(**hp_kw))
    state = ref_loop.init_state()
    init = jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))
    ref_losses = []
    for tokens in batches:
        state, loss, _ = ref_loop.train_step(state, tokens)
        ref_losses.append(loss)
    ref_final = jax.tree_util.tree_map(np.asarray,
                                       jax.device_get(state.params))

    loop = port.LMTrainLoop(
        port_tf.TransformerConfig(**SMALL, dtype="float32"),
        port.LMHyperParams(**hp_kw), device="cpu")
    loop.init_state(params_from_jax(init))
    losses = [loop.train_step(tokens)[0] for tokens in batches]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4, atol=0)
    assert loop.opt.count == STEPS and loop.step == STEPS

    ours = dict(jax.tree_util.tree_leaves_with_path(
        params_to_jax(loop.model.state_dict())))
    for path, want in jax.tree_util.tree_leaves_with_path(ref_final):
        np.testing.assert_allclose(ours[path], want, atol=1e-4, rtol=0,
                                   err_msg=str(path))
    # The params moved (steps 2 and 3 have lr > 0).
    moved = max(float(np.max(np.abs(ours[p] - w)))
                for p, w in jax.tree_util.tree_leaves_with_path(init))
    assert moved > 1e-4


def test_first_update_uses_lr_zero():
    loop = port.LMTrainLoop(
        port_tf.TransformerConfig(**SMALL, dtype="float32"),
        port.LMHyperParams(learning_rate=1e-2, warmup_steps=2), device="cpu")
    model = loop.init_state()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tokens = next(port_data.LMDataset(512, 128).batches(2))
    loop.train_step(tokens)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    assert float(loop.opt.mu[0].abs().max()) > 0  # moments did update


def test_evaluate_and_train_many():
    loop = port.LMTrainLoop(
        port_tf.TransformerConfig(**SMALL, dtype="float32"), device="cpu")
    loop.init_state()
    ds = port_data.LMDataset(512, 128)
    loss, acc = loop.train_many(list(ds.batches(2, steps=2)))
    assert np.isfinite(loss) and 0.0 <= acc <= 1.0 and loop.step == 2
    assert loop.last_step_seconds is None  # the first call is not timed
    loop.train_many(list(ds.batches(2, steps=2)))
    assert loop.last_step_seconds > 0
    assert loop.last_mfu is None  # no device peak on the CPU
    m = loop.evaluate(ds.eval_batch(2))
    assert set(m) == {"loss", "accuracy"} and np.isfinite(m["loss"])
    with pytest.raises(ValueError, match="at least one batch"):
        loop.train_many([])


def test_runner_stdout_contract(capsys):
    rc = lm_runner.main(["--preset", "tiny", "--steps", "2",
                         "--batch-size", "2", "--device", "cpu",
                         "--log-every", "1"])
    out = capsys.readouterr().out
    assert rc == 0
    assert re.search(r"^runner_start model=transformer-tiny dataset=lm-tiny "
                     r"rank=0 world=1 devices=1 .*seq_len=256", out, re.M)
    assert re.search(r"^model_params=\d+$", out, re.M)
    # Step 1 pays warm-up and is not timed; step 2 is.
    assert re.search(r"^step=2 loss=\S+ accuracy=\S+ step_time=\S+ "
                     r"tokens_per_s=\d+$", out, re.M)
    assert not re.search(r"^step=1 ", out, re.M)
    assert re.search(r"^train_done steps=2 wall_seconds=\S+$", out, re.M)
    for key in ("loss", "accuracy", "entropy_floor"):
        assert re.search(rf"^{key}=[0-9.]+$", out, re.M), key


def test_runner_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        lm_runner.main(["--preset", "tiny", "--steps", "1",
                        "--batch-size", "2"])


# Refused by earlier slices; now each takes the reference's path at one
# device: a plan that needs more devices fails the factorisation with the
# reference's ValueError (exit 1), --sp and --fsdp train (no-ops at one
# device). --collective-overlap on is the exception: the reference sets
# its TPU XLA flags and XLA:CPU aborts on them; the port trains.
FLAG_CASES = [
    (["--tp", "2"], {}), (["--pp", "2"], {}), (["--cp", "2"], {}),
    (["--sp"], {}), (["--fsdp"], {}),
    ([], {"KFX_PARALLELISM": '{"pipeline": 2}'}),
    (["--collective-overlap", "on"], {}),
    ([], {"KFX_PARALLELISM": '{"context": 2}'}),
    ([], {"KFX_PARALLELISM": '{"tensor": 2}'}),
    # The reference's own error exits (2), before and after the mesh.
    (["--sp", "--pp", "2"], {}), (["--cp", "2", "--sp"], {}),
    ([], {"KFX_PARALLELISM": '{"data": 2}'}),
]
FLAG_BASE = ["--preset", "tiny", "--steps", "1", "--batch-size", "2",
             "--seq-len", "64"]


def _case_id(case):
    argv, env = case
    return "_".join(argv + list(env.values())) or "default"


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The reference runner on one XLA:CPU device for every case, the
    processes side by side: (exit code, stdout, stderr) by case id."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = {}
    for argv, extra in FLAG_CASES:
        env = {k: v for k, v in os.environ.items()
               if k != "KFX_PARALLELISM"}
        env.update(JAX_PLATFORMS="cpu", PYTHONPATH=repo,
                   XLA_FLAGS="--xla_force_host_platform_device_count=1",
                   **extra)
        procs[_case_id((argv, extra))] = subprocess.Popen(
            [sys.executable, "-m", "kubeflow_tpu.runners.lm_runner",
             *FLAG_BASE, *argv], env=env, cwd=str(tmp_path_factory.mktemp(
                 "ref")), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    out = {}
    for key, p in procs.items():
        o, e = p.communicate(timeout=300)
        out[key] = (p.returncode, o, e)
    return out


@pytest.mark.parametrize("argv,env", FLAG_CASES,
                         ids=[_case_id(c) for c in FLAG_CASES])
def test_runner_flags_match_reference_at_one_device(argv, env, monkeypatch,
                                                   capsys, reference_runs):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        rc = lm_runner.main(["--device", "cpu", *FLAG_BASE, *argv])
    except ValueError as e:   # uncaught in a process: exit 1, traceback
        rc = 1
        print(f"ValueError: {e}", file=sys.stderr)
    out, err = capsys.readouterr()
    err_line = (err.strip().splitlines() or [""])[-1]
    ref_rc, ref_out, ref_err = reference_runs[_case_id((argv, env))]
    if argv == ["--collective-overlap", "on"]:
        assert ref_rc != 0 and "Unknown flags in XLA_FLAGS" in ref_err
        assert rc == 0 and "train_done" in out
        return
    assert rc == ref_rc, ref_err
    if rc:
        assert err_line == ref_err.strip().splitlines()[-1]
        assert ("does not divide" in err_line) == (rc == 1)
    else:
        plan = re.search(r" (plan=\S+) ", ref_out).group(1)
        assert f" {plan} " in out and "train_done" in out


@pytest.mark.parametrize("argv,plan", [
    (["--experts", "4"], "pp1/dp1/tp1/ep4"),
    (["--remat", "--remat-policy", "save_flash_full"], "pp1/dp1/tp1"),
])
def test_runner_accepts_ported_flags(argv, plan, capsys):
    """Refused by earlier slices, ported since: the runner trains with
    them, and the runner_start plan carries the reference's /ep suffix."""
    rc = lm_runner.main(["--preset", "tiny", "--steps", "1",
                         "--batch-size", "1", "--device", "cpu",
                         "--seq-len", "64", *argv])
    out = capsys.readouterr().out
    assert rc == 0 and "train_done" in out
    assert f" plan={plan} " in out


@pytest.mark.parametrize("overlap", ["auto", "off"])
def test_runner_accepts_overlap_noops(overlap, capsys):
    rc = lm_runner.main(["--preset", "tiny", "--steps", "1",
                         "--batch-size", "1", "--device", "cpu",
                         "--seq-len", "64", "--collective-overlap", overlap])
    assert rc == 0 and "train_done" in capsys.readouterr().out
