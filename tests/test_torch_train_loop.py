"""The port's classifier TrainLoop, Checkpointer and JAXJob runner against
the JAX package, plus the LM runner's checkpoint resume.

Tolerances: after two steps on the same weights and batches (f32 compute)
the loss agrees to 1e-5 relative, each param's change from its start to
2% of the learning rate plus 1e-7 (one Adam step moves a param by about
lr, and a gradient near zero can move the two frameworks' steps apart by
its rounding), BatchNorm running stats to 1e-5; eval loss/accuracy to
1e-5. Inside the port, K fused steps equal K single steps exactly, and a
resumed run ends with the uninterrupted run's params exactly."""

import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from kubeflow_tpu.models import resnet as rres  # noqa: E402
from kubeflow_tpu.training import TrainLoop as RefTrainLoop  # noqa: E402
from kubeflow_tpu_torch.data import get_dataset  # noqa: E402
from kubeflow_tpu_torch.models import ResNet, get_model  # noqa: E402
from kubeflow_tpu_torch.models import resnet as pres  # noqa: E402
from kubeflow_tpu_torch.models.convert import (  # noqa: E402
    classifier_params_from_jax)
from kubeflow_tpu_torch.training import Checkpointer, TrainLoop  # noqa: E402
from kubeflow_tpu_torch.training.checkpoint import (  # noqa: E402
    QUARANTINE_PREFIX, corrupt_step_dir)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (8, 8, 3)
LR = 1e-3


def _models():
    """A one-block Bottleneck ResNet (BatchNorm, a projection) at test
    width, f32."""
    ref = rres.ResNet(stage_sizes=[1], block_cls=rres.BottleneckBlock,
                      num_filters=4, dtype=jnp.float32)
    port = ResNet(SHAPE, [1], pres.BottleneckBlock, num_filters=4,
                  dtype=torch.float32)
    return ref, port


def _batches(n=2, b=16, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 1, (b,) + SHAPE).astype(np.float32),
             rng.integers(0, 10, b).astype(np.int32)) for _ in range(n)]


def _port_state_from(loop, ref_state):
    state = loop.init_state(SHAPE)
    sd = classifier_params_from_jax(
        "resnet50", jax.device_get(ref_state.params),
        jax.device_get(ref_state.batch_stats))
    state.model.load_state_dict(sd)
    return state


@pytest.mark.parametrize("opt", ["adam", "adamw", "sgd", "lamb"])
def test_steps_match_reference(opt):
    ref_model, port_model = _models()
    wd = 1e-2 if opt == "lamb" else 0.0
    ref_loop = RefTrainLoop(ref_model, learning_rate=LR, optimizer=opt,
                            weight_decay=wd)
    ref_state = ref_loop.init_state(SHAPE)
    loop = TrainLoop(port_model, learning_rate=LR, optimizer=opt,
                     weight_decay=wd, device="cpu")
    state = _port_state_from(loop, ref_state)
    p0 = {k: v.detach().clone() for k, v in state.params.items()}
    for images, labels in _batches():
        ref_state, ref_loss, ref_acc = ref_loop.train_step(
            ref_state, images, labels)
        state, loss, acc = loop.train_step(state, images, labels)
        assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
        assert acc == pytest.approx(ref_acc, abs=1e-6)
    assert state.step == int(ref_state.step) == 2
    want = classifier_params_from_jax(
        "resnet50", jax.device_get(ref_state.params),
        jax.device_get(ref_state.batch_stats))
    for name, p in state.params.items():
        d_port = p.detach() - p0[name]
        d_ref = want[name] - p0[name]
        assert float((d_port - d_ref).abs().max()) <= 0.02 * LR + 1e-7, name
    for name, t in state.batch_stats.items():
        assert float((t - want[name]).abs().max()) <= 1e-5, name
    assert state.optimizer.param_groups[0]["lr"] == LR


def test_train_steps_equals_single_steps():
    ds = get_dataset("mnist")
    batches = list(ds.batches(16, steps=3))
    loop = TrainLoop(get_model("mlp", hidden=(32,)), device="cpu")
    one = loop.init_state(ds.shape)
    for images, labels in batches:
        one, loss1, acc1 = loop.train_step(one, images, labels)
    fused = loop.init_state(ds.shape)
    fused, loss3, acc3 = loop.train_steps(
        fused, np.stack([b[0] for b in batches]),
        np.stack([b[1] for b in batches]))
    assert (loss1, acc1, one.step) == (loss3, acc3, fused.step) == (
        loss1, acc1, 3)
    for a, b in zip(one.params.values(), fused.params.values()):
        assert torch.equal(a, b)
    # Device-drawn batches: seeded by the absolute step, so steps 2..3
    # after steps 0..1 equal steps 0..3 in one call.
    fn = ds.device_batch_fn()
    a = loop.init_state(ds.shape)
    a, la, _ = loop.train_steps_device(a, fn, 8, 0, 4)
    b = loop.init_state(ds.shape)
    b, _, _ = loop.train_steps_device(b, fn, 8, 0, 2)
    b, lb, _ = loop.train_steps_device(b, fn, 8, 2, 2)
    assert la == lb and all(torch.equal(x, y) for x, y in zip(
        a.params.values(), b.params.values()))
    from kubeflow_tpu.training import TrainMetrics as RefMetrics
    from kubeflow_tpu_torch.training import TrainMetrics

    assert TrainMetrics(3, loss3, acc3, 0.1).line() == \
        RefMetrics(3, loss3, acc3, 0.1).line()
    # The step timing reaches the port's registry, labelled by model.
    from kubeflow_tpu_torch.obs.metrics import default_registry

    reg = default_registry()
    assert reg.histogram("kfx_train_step_seconds").count(model="MLP") >= 4
    assert 'model="MLP"' in reg.render()


def test_evaluate_matches_reference():
    ref_model, port_model = _models()
    ref_loop = RefTrainLoop(ref_model)
    ref_state = ref_loop.init_state(SHAPE)
    loop = TrainLoop(port_model, device="cpu")
    state = _port_state_from(loop, ref_state)
    rng = np.random.default_rng(4)
    images = rng.uniform(0, 1, (40,) + SHAPE).astype(np.float32)
    labels = rng.integers(0, 10, 40).astype(np.int32)
    want = ref_loop.evaluate(ref_state, images, labels, batch_size=16)
    got = loop.evaluate(state, images, labels, batch_size=16)
    assert got["count"] == want["count"] == 32   # full batches only
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert got["accuracy"] == pytest.approx(want["accuracy"], abs=1e-6)


# -- checkpoints (tests/test_training.py TestCheckpoint, but chaos) -------

def _mlp_loop(lr=1e-3):
    return TrainLoop(get_model("mlp", hidden=(32,)), learning_rate=lr,
                     device="cpu")


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a.values(), b.values()))


def test_checkpoint_round_trip(tmp_path):
    ds = get_dataset("mnist")
    loop = _mlp_loop()
    state = loop.init_state(ds.shape)
    for images, labels in ds.batches(32, steps=3):
        state, *_ = loop.train_step(state, images, labels)
    ckpt = Checkpointer(str(tmp_path / "ck"), save_every=1)
    ckpt.maybe_save(3, state, force=True)
    ckpt.wait()
    assert ckpt.latest_step() == 3
    assert not ckpt.maybe_save(3, state, force=True)   # already durable
    restored = ckpt.restore_latest(loop.init_state(ds.shape))
    assert restored.step == 3 and _same(restored.params, state.params)
    # The optimizer's moments came back too: one more step agrees.
    images, labels = next(ds.batches(32, steps=1, epoch_seed=1))
    _, l1, _ = loop.train_step(state, images, labels)
    _, l2, _ = loop.train_step(restored, images, labels)
    assert l1 == l2 and _same(restored.params, state.params)
    # A plain tree round-trips too, onto the target's devices.
    ckpt.maybe_save(4, {"w": torch.arange(3.0), "n": 7}, force=True)
    got = ckpt.restore_latest({"w": torch.zeros(3), "n": 0})
    assert torch.equal(got["w"], torch.arange(3.0)) and got["n"] == 7
    ckpt.close()


def test_resume_reapplies_cli_hyperparams(tmp_path):
    ds = get_dataset("mnist")
    state = _mlp_loop(1e-3).init_state(ds.shape)
    ckpt = Checkpointer(str(tmp_path / "ck"), save_every=1)
    ckpt.maybe_save(1, state, force=True)
    ckpt.wait()
    loop2 = _mlp_loop(5e-4)
    restored = ckpt.restore_latest(loop2.init_state(ds.shape))
    assert restored.optimizer.param_groups[0]["lr"] == pytest.approx(1e-3)
    resumed = loop2.reapply_hyperparams(restored)
    assert resumed.optimizer.param_groups[0]["lr"] == pytest.approx(5e-4)
    ckpt.close()


def test_incompatible_structure_falls_back_to_fresh(tmp_path, capfd):
    ckpt = Checkpointer(str(tmp_path / "ck"), save_every=1)
    ckpt.maybe_save(1, {"old_layout": torch.zeros(2)}, force=True)
    ckpt.wait()
    out = ckpt.restore_latest({"new_layout": {"nested": torch.zeros(3)}})
    assert out is None
    assert "checkpoint_restore_incompatible" in capfd.readouterr().out
    # Another optimizer's state is another structure, as in optax.
    ds = get_dataset("mnist")
    ckpt.maybe_save(2, _mlp_loop().init_state(ds.shape), force=True)
    sgd = TrainLoop(get_model("mlp", hidden=(32,)), optimizer="sgd",
                    device="cpu")
    assert ckpt.restore_latest(sgd.init_state(ds.shape)) is None
    ckpt.close()


def test_corrupt_latest_falls_back_to_older_retained_step(tmp_path, capfd):
    ds = get_dataset("mnist")
    loop = _mlp_loop()
    state = loop.init_state(ds.shape)
    ckpt = Checkpointer(str(tmp_path / "ck"), save_every=1, keep=2)
    it = ds.batches(32, steps=2)
    state, *_ = loop.train_step(state, *next(it))
    ckpt.maybe_save(1, state, force=True)
    good = {k: v.detach().clone() for k, v in state.params.items()}
    state, *_ = loop.train_step(state, *next(it))
    ckpt.maybe_save(2, state, force=True)
    ckpt.wait()
    assert corrupt_step_dir(str(tmp_path / "ck"), 2) > 0

    restored = ckpt.restore_latest(loop.init_state(ds.shape))
    assert restored is not None and restored.step == 1
    assert _same(restored.params, good)
    out = capfd.readouterr().out
    assert "checkpoint_unreadable step=2" in out
    assert "checkpoint_quarantined step=2" in out
    assert (tmp_path / "ck" / f"{QUARANTINE_PREFIX}2").is_dir()
    assert not (tmp_path / "ck" / "2").exists()
    assert ckpt.latest_step() == 1
    ckpt.maybe_save(3, state, force=True)
    ckpt.wait()
    assert ckpt.all_steps() == [1, 3]
    # With every retained step unreadable, restore raises instead of
    # starting over (the rotation would then delete good steps).
    corrupt_step_dir(str(tmp_path / "ck"), 1)
    corrupt_step_dir(str(tmp_path / "ck"), 3)
    with pytest.raises(RuntimeError, match="refusing to restart"):
        ckpt.restore_latest(loop.init_state(ds.shape))
    ckpt.close()


def test_keep_rotation_and_unported_knobs(tmp_path, monkeypatch):
    ckpt = Checkpointer(str(tmp_path / "ck"), save_every=2, keep=2,
                        async_save=False)
    for step in range(1, 8):
        ckpt.maybe_save(step, {"x": torch.full((2,), float(step))})
    assert ckpt.all_steps() == [4, 6]
    # A KFX_CHAOS plan reaches the Checkpointer: its save point fires on
    # the first save (corrupting it after the commit).
    from kubeflow_tpu_torch import chaos

    chaos.reset()
    monkeypatch.setenv("KFX_CHAOS", "checkpoint.save:mode=corrupt,count=1")
    try:
        ck2 = Checkpointer(str(tmp_path / "ck2"), async_save=False)
        ck2.maybe_save(1, {"x": torch.ones(4)}, force=True)
        assert chaos.injected_counts() == {"checkpoint.save": 1}
        with pytest.raises(RuntimeError, match="refusing to restart"):
            ck2.restore_latest({"x": torch.zeros(4)})
    finally:
        monkeypatch.delenv("KFX_CHAOS")
        chaos.reset()
    monkeypatch.setenv("KFX_NUM_PROCESSES", "2")
    with pytest.raises(NotImplementedError, match="Queue A 6"):
        _mlp_loop()


# -- the runners end to end on the CPU -------------------------------------

def _run(module, argv, tmp_path, ckpt=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("KFX_CHECKPOINT_DIR", "KFX_CHAOS")}
    env["PYTHONPATH"] = REPO
    if ckpt:
        env["KFX_CHECKPOINT_DIR"] = str(ckpt)
    return subprocess.run([sys.executable, "-m", module] + argv, env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=str(tmp_path))


def _load_params(export_dir):
    from kubeflow_tpu_torch.serving import _msgpack

    return jax.tree.leaves(_msgpack.load(
        os.path.join(export_dir, "params.msgpack")))


def test_jax_runner_crash_resume_matches_uninterrupted(tmp_path):
    """Crash at step 5 (checkpoint every 2) then resume: the resumed
    run's export equals an uninterrupted run's, and both serve."""
    from kubeflow_tpu_torch.runners import jax_runner

    argv = ["--model", "mlp", "--dataset", "mnist", "--steps", "8",
            "--batch-size", "32", "--log-every", "2", "--checkpoint-every",
            "2", "--scan-steps", "2", "--eval-samples", "512",
            "--device", "cpu"]
    whole = str(tmp_path / "whole")
    assert jax_runner.main(argv + ["--export-dir", whole]) == 0
    module = "kubeflow_tpu_torch.runners.jax_runner"
    ck = tmp_path / "ck"
    crashed = _run(module, argv + ["--fail-at-step", "5"], tmp_path, ck)
    assert crashed.returncode == 17, crashed.stderr
    assert "fault_injection_crash step=5" in crashed.stdout
    resumed_dir = str(tmp_path / "resumed")
    resumed = _run(module, argv + ["--export-dir", resumed_dir], tmp_path,
                   ck)
    assert resumed.returncode == 0, resumed.stderr
    out = resumed.stdout
    assert "resumed_from_checkpoint step=4" in out
    assert "train_done steps=8" in out and "exported_model dir=" in out
    assert "step=8 loss=" in out and "examples_per_sec=" in out
    for a, b in zip(_load_params(whole), _load_params(resumed_dir)):
        assert np.array_equal(a, b)


def test_lm_runner_crash_resume(tmp_path):
    module = "kubeflow_tpu_torch.runners.lm_runner"
    argv = ["--preset", "tiny", "--seq-len", "64", "--steps", "4",
            "--batch-size", "2", "--log-every", "1", "--checkpoint-every",
            "2", "--device", "cpu"]
    whole = _run(module, argv, tmp_path)
    assert whole.returncode == 0, whole.stderr
    ck = tmp_path / "ck"
    crashed = _run(module, argv + ["--fail-at-step", "3"], tmp_path, ck)
    assert crashed.returncode == 17 and "fault_injection_crash step=3" in \
        crashed.stdout
    resumed = _run(module, argv, tmp_path, ck)
    assert resumed.returncode == 0, resumed.stderr
    assert "resumed_from_checkpoint step=2" in resumed.stdout
    assert "train_done steps=4" in resumed.stdout
    # The resumed run continues the uninterrupted run's trajectory: the
    # same params, AdamW state and data at step 2, so the same step-4 loss.
    last = [ln for ln in whole.stdout.splitlines()
            if ln.startswith("step=4 ")]
    got = [ln for ln in resumed.stdout.splitlines()
           if ln.startswith("step=4 ")]
    assert last and got and last[0].split()[1] == got[0].split()[1]
    assert sorted(os.listdir(ck)) == ["2", "4"]
