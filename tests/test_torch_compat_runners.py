"""The port's Kubeflow compat workers (kubeflow_tpu_torch/runners:
torch_runner, tf_runner, mpi_launcher + mpi_jax_runner), its copies of
utils/net.py and runtime/lifetime.py, and data parallelism across
processes on the classifier path, against the reference
(tests/test_compat_runners.py, tests/test_lifetime.py).

Data parallelism: two processes on gloo and the CPU run the port's
TrainLoop on resnet18 at 32x32 in f32, 3 SGD steps of a global batch of 8
(4 rows a rank); SGD, because Adam's update is blind to the gradient's
scale (a sum in place of the mean over ranks would pass) and turns the
rounding of near-zero gradients into steps of the learning rate. Their
params and BatchNorm running statistics equal a
single process on the same global batches within 1e-5 (the two differ only
in summation order), and that single process equals the JAX TrainLoop on
the same batches from the same weights (carried across by
models/convert.py) to tests/test_torch_classifier.py's f32 tolerance: the
losses to 1e-4 relative, the running statistics to 1e-5 and each param to
1e-4 of the largest value in its tensor, plus 1e-7 for tensors that stay
near zero (the BatchNorm biases before a zero-initialised residual scale
move by ~1e-7, so they hold rounding only). The reference's own
multi-process step is, by construction, its single-process step on the
global array, so the single JAX process is the oracle for both.

The tf_runner cases are marked slow, as the reference's are: TensorFlow's
start-up is what is slow. The rest are torch-only subprocess runs of
about 10 s each."""

import json
import os
import re
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from kubeflow_tpu.runners import mpi_launcher as ref_shim  # noqa: E402
from kubeflow_tpu_torch.runners import mpi_launcher as port_shim  # noqa: E402

PY = sys.executable
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (32, 32, 3)
LR = 0.05
OPT = "sgd"


def _env(extra=None):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("KFX_", "OMPI_", "MASTER_", "TF_CONFIG"))
           and k not in ("RANK", "WORLD_SIZE")}
    env["PYTHONPATH"] = REPO
    env.update(extra or {})
    return env


def _run(argv, extra_env=None, timeout=300, cwd=None):
    return subprocess.run(argv, env=_env(extra_env), capture_output=True,
                          text=True, timeout=timeout, cwd=cwd or REPO)


def _rank_lines(out, prefix):
    """Lines starting with ``prefix`` with the per-rank timing fields
    dropped (step_time, examples_per_sec, wall_seconds)."""
    return sorted(re.sub(r" (step_time|examples_per_sec|wall_seconds)=\S+",
                         "", ln) for ln in out.splitlines()
                  if ln.startswith(prefix))


# -- the shim, the ports and the parent watch --------------------------------

@pytest.mark.parametrize("argv", [
    ["-np", "4", "python", "train.py", "--lr", "0.1"],
    ["-n", "2", "-x", "FOO=bar", "--allow-run-as-root", "python", "t.py"],
    ["--np", "3", "-mca", "btl", "tcp", "-bind-to", "none", "-q", "cmd"],
    ["-x", "HOME", "--hostfile", "/tmp/h", "--oversubscribe", "./a.out",
     "-np", "9"],
    ["--unknown-flag", "-c", "5", "--tag-output", "x"],
    ["-np", "2"],
    [],
])
def test_parse_argv_equals_reference(argv):
    assert port_shim.parse_argv(argv) == ref_shim.parse_argv(argv)


def test_hostfile_slots_equals_reference(tmp_path, monkeypatch):
    hf = tmp_path / "hostfile"
    hf.write_text("# comment\nworker-0 slots=2\nworker-1\n\nworker-2 "
                  "slots=3 max_slots=4\n")
    monkeypatch.setenv("KFX_HOSTFILE", str(hf))
    assert port_shim._hostfile_slots() == ref_shim._hostfile_slots() == 6
    monkeypatch.setenv("KFX_HOSTFILE", str(tmp_path / "missing"))
    assert port_shim._hostfile_slots() == ref_shim._hostfile_slots() == 0


def test_free_ports_are_distinct_and_bindable():
    import socket

    from kubeflow_tpu_torch.utils.net import free_port, free_ports

    ports = free_ports(8) + [free_port()]
    assert len(set(ports)) == 9
    for p in ports:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.bind(("127.0.0.1", p))


def test_parent_watch_pipe_eof_kills_child():
    """tests/test_lifetime.py's case on the port's copy: a child holding
    the keepalive read end dies when the write end closes."""
    r, w = os.pipe()
    os.set_inheritable(r, True)
    child = subprocess.Popen(
        [PY, "-c", textwrap.dedent(f"""
            import sys, time
            sys.path.insert(0, {REPO!r})
            from kubeflow_tpu_torch.runtime.lifetime import (
                install_parent_watch)
            assert install_parent_watch()
            print("armed", flush=True)
            time.sleep(120)
        """)],
        env={**os.environ, "KFX_PARENT_FD": str(r)},
        pass_fds=(r,), start_new_session=True, stdout=subprocess.PIPE,
        text=True)
    try:
        os.close(r)
        assert child.stdout.readline().strip() == "armed"
        os.close(w)
        assert child.wait(timeout=5) != 0   # SIGKILLed its own group
    finally:
        if child.poll() is None:
            os.killpg(os.getpgid(child.pid), signal.SIGKILL)


def test_parent_watch_ppid_fallback_installs():
    out = subprocess.run(
        [PY, "-c", textwrap.dedent(f"""
            import os, sys
            sys.path.insert(0, {REPO!r})
            os.environ.pop("KFX_PARENT_FD", None)
            from kubeflow_tpu_torch.runtime.lifetime import (
                install_parent_watch)
            print(install_parent_watch())
        """)],
        capture_output=True, text=True, timeout=30)
    assert out.stdout.strip() == "True", out.stderr


# -- data parallelism on the classifier path ---------------------------------

_DP_WORKER = """
import os, sys
import numpy as np, torch
sys.path.insert(0, {repo!r})
from kubeflow_tpu_torch.data import get_dataset
from kubeflow_tpu_torch.models import get_model
from kubeflow_tpu_torch.runners.jax_runner import initialize_distributed
from kubeflow_tpu_torch.training import TrainLoop

initialize_distributed(torch.device("cpu"))
rank = int(os.environ["KFX_PROCESS_ID"])
world = int(os.environ["KFX_NUM_PROCESSES"])
# Each rank draws its own init (seed = rank); the loop broadcasts rank 0's.
loop = TrainLoop(get_model("resnet18", input_shape=(32, 32, 3),
                           dtype=torch.float32),
                 learning_rate={lr!r}, optimizer={opt!r}, device="cpu",
                 seed=rank)
state = loop.init_state((32, 32, 3))
init = {{k: v.clone() for k, v in state.model.state_dict().items()}}
state.model.load_state_dict(torch.load({init!r}))
data = np.load({batches!r})
per = data["x"].shape[1] // world
rows = slice(rank * per, (rank + 1) * per)
losses = []
for x, y in zip(data["x"], data["y"]):
    state, loss, acc = loop.train_step(state, x[rows], y[rows])
    losses.append((loss, acc))
# The device pipeline: every rank draws the global batch from the same
# seed and trains on its rows.
dev_loop = TrainLoop(get_model("resnet18", input_shape=(32, 32, 3),
                               dtype=torch.float32),
                     learning_rate={lr!r}, optimizer={opt!r}, device="cpu")
dev = dev_loop.init_state((32, 32, 3))
dev.model.load_state_dict(torch.load({init!r}))
dev, dev_loss, dev_acc = dev_loop.train_steps_device(
    dev, get_dataset("cifar10", split="train").device_batch_fn(),
    batch_size=8, start_step=0, n_steps=3)
torch.save({{"init": init, "state": state.model.state_dict(),
            "losses": losses, "device": dev.model.state_dict(),
            "device_loss": (dev_loss, dev_acc)}}, {out!r} + str(rank))
"""


def _dp_batches(n=3, b=8, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.uniform(0, 1, (n, b) + SHAPE).astype(np.float32),
            "y": rng.integers(0, 10, (n, b)).astype(np.int32)}


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """(JAX TrainLoop, one port process, two port processes) after 3
    steps from the same weights on the same global batches; plus one and
    two port processes after 3 steps of the device pipeline."""
    from kubeflow_tpu.models import resnet as rres
    from kubeflow_tpu.training import TrainLoop as RefTrainLoop
    from kubeflow_tpu_torch.data import get_dataset
    from kubeflow_tpu_torch.models import get_model
    from kubeflow_tpu_torch.models.convert import (
        classifier_params_from_jax)
    from kubeflow_tpu_torch.training import TrainLoop
    from kubeflow_tpu_torch.utils.net import free_port

    tmp = tmp_path_factory.mktemp("dp")
    data = _dp_batches()
    np.savez(tmp / "batches.npz", **data)
    ref_loop = RefTrainLoop(rres.ResNet18(num_classes=10, dtype=jnp.float32),
                            learning_rate=LR, optimizer=OPT)
    ref = ref_loop.init_state(SHAPE)
    init = classifier_params_from_jax("resnet18", jax.device_get(ref.params),
                                      jax.device_get(ref.batch_stats))
    torch.save(init, tmp / "init.pt")
    ref_losses = []
    for x, y in zip(data["x"], data["y"]):
        ref, loss, acc = ref_loop.train_step(ref, x, y)
        ref_losses.append((loss, acc))
    ref_sd = classifier_params_from_jax("resnet18",
                                        jax.device_get(ref.params),
                                        jax.device_get(ref.batch_stats))

    loop = TrainLoop(get_model("resnet18", input_shape=SHAPE,
                               dtype=torch.float32),
                     learning_rate=LR, optimizer=OPT, device="cpu")
    one = loop.init_state(SHAPE)
    seed0 = {k: v.clone() for k, v in one.model.state_dict().items()}
    one.model.load_state_dict(init)
    one_losses = []
    for x, y in zip(data["x"], data["y"]):
        one, loss, acc = loop.train_step(one, x, y)
        one_losses.append((loss, acc))
    dev = loop.init_state(SHAPE)
    dev.model.load_state_dict(init)
    dev, dev_loss, dev_acc = loop.train_steps_device(
        dev, get_dataset("cifar10", split="train").device_batch_fn(),
        batch_size=8, start_step=0, n_steps=3)

    script = _DP_WORKER.format(repo=REPO, lr=LR, opt=OPT, init=str(tmp / "init.pt"),
                               batches=str(tmp / "batches.npz"),
                               out=str(tmp / "out"))
    coord = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [PY, "-c", script], env=_env({
            "KFX_NUM_PROCESSES": "2", "KFX_PROCESS_ID": str(r),
            "KFX_COORDINATOR_ADDRESS": coord, "OMP_NUM_THREADS": "2"}),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)
    assert all("process_group backend=gloo" in o for o in outs), outs
    two = [torch.load(tmp / f"out{r}") for r in range(2)]
    return {"ref": (ref_sd, ref_losses), "seed0": seed0,
            "one": (one.model.state_dict(), one_losses), "two": two,
            "one_device": (dev.model.state_dict(), (dev_loss, dev_acc))}


def _max_abs(a, b):
    return float((a.float() - b.float()).abs().max())


def test_dp_ranks_start_from_rank0_weights(dp_runs):
    """init_state at world 2: rank 1 (seed 1) holds rank 0's seed-0
    weights, which are a single process's seed-0 init."""
    a, b = (t["init"] for t in dp_runs["two"])
    for k, v in dp_runs["seed0"].items():
        assert torch.equal(a[k], v) and torch.equal(b[k], v), k


def test_dp_two_ranks_equal_one_process(dp_runs):
    one_sd, one_losses = dp_runs["one"]
    r0, r1 = dp_runs["two"]
    # Every rank holds the same state and reports the global batch's
    # loss and accuracy.
    for k in one_sd:
        assert torch.equal(r0["state"][k], r1["state"][k]), k
    assert r0["losses"] == r1["losses"]
    errs = {k: _max_abs(r0["state"][k], v) for k, v in one_sd.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-5, (worst, errs[worst])
    assert any(k.endswith(".mean") for k in errs)   # BN running stats
    for (l2, a2), (l1, a1) in zip(r0["losses"], one_losses):
        assert abs(l2 - l1) <= 1e-5 * abs(l1) and a2 == pytest.approx(a1)


def test_dp_device_pipeline_two_ranks_equal_one_process(dp_runs):
    """train_steps_device at world 2 trains each rank on its rows of the
    global draw: the run equals one process on the same stream."""
    one_sd, (l1, a1) = dp_runs["one_device"]
    r0, r1 = dp_runs["two"]
    for k in one_sd:
        assert torch.equal(r0["device"][k], r1["device"][k]), k
    assert r0["device_loss"] == r1["device_loss"]
    errs = {k: _max_abs(r0["device"][k], v) for k, v in one_sd.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-5, (worst, errs[worst])
    l2, a2 = r0["device_loss"]
    assert abs(l2 - l1) <= 1e-5 * abs(l1) and a2 == pytest.approx(a1)


def test_dp_one_process_equals_jax_train_loop(dp_runs):
    ref_sd, ref_losses = dp_runs["ref"]
    one_sd, one_losses = dp_runs["one"]
    for (l1, a1), (lr, ar) in zip(one_losses, ref_losses):
        assert abs(l1 - lr) <= 1e-4 * abs(lr) and a1 == pytest.approx(ar)
    for k, want in ref_sd.items():
        if k.endswith((".mean", ".var")):
            assert _max_abs(one_sd[k], want) <= 1e-5, k
        else:
            scale = float(want.abs().max())
            assert _max_abs(one_sd[k], want) <= 1e-4 * scale + 1e-7, k


# -- the workers end to end on the CPU ----------------------------------------

def test_torch_runner_two_ranks_gloo():
    """tests/test_compat_runners.py's PyTorchJob case on the port: DDP
    keeps the params equal, so both ranks' final eval lines agree."""
    from kubeflow_tpu_torch.utils.net import free_port

    port = str(free_port())
    procs = [subprocess.Popen(
        [PY, "-m", "kubeflow_tpu_torch.runners.torch_runner",
         "--dataset=mnist", "--steps=10", "--batch-size=64", "--log-every=5",
         "--eval-samples=256", "--device", "cpu"],
        env=_env({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port,
                  "WORLD_SIZE": "2", "RANK": str(rank)}),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO) for rank in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)
    assert "rank=0 world=2 backend=gloo" in outs[0]
    assert "rank=1 world=2 backend=gloo" in outs[1]
    assert "train_done steps=10" in outs[0]
    finals = [_rank_lines(o, ("loss=", "accuracy=")) for o in outs]
    assert finals[0] == finals[1] and len(finals[0]) == 2, finals


def _shim(extra_argv, extra_env=None):
    return _run([PY, "-m", "kubeflow_tpu_torch.runners.mpi_launcher", "-np",
                 "2", PY, "-m", "kubeflow_tpu_torch.runners.mpi_jax_runner",
                 "--device", "cpu", "--model=mlp", "--dataset=mnist",
                 "--batch-size=64", *extra_argv], extra_env)


def test_mpi_jax_runner_two_ranks_via_shim():
    """The MPIJob pair: two ranks data-parallel over gloo, every step=
    line (but its timing) and the final eval printed alike by both."""
    out = _shim(["--steps=6", "--log-every=3", "--no-checkpoint"])
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.count("world=2") == 4   # process_group, runner_start
    assert out.stdout.count("backend=gloo") == 2
    assert out.stdout.count("train_done steps=6") == 2
    steps = _rank_lines(out.stdout, "step=")
    assert steps[0::2] == steps[1::2] and len(steps) == 4, steps
    finals = _rank_lines(out.stdout, ("loss=", "accuracy="))
    assert finals[0::2] == finals[1::2] and len(finals) == 4, finals


def test_mpi_jax_runner_needs_a_coordinator_above_one_rank():
    out = _run([PY, "-m", "kubeflow_tpu_torch.runners.mpi_jax_runner",
                "--device", "cpu"], {"OMPI_COMM_WORLD_SIZE": "2",
                                     "OMPI_COMM_WORLD_RANK": "0"})
    assert out.returncode == 2 and "KFX_COORDINATOR_ADDRESS" in out.stderr


def test_two_rank_crash_resumes_from_rank0_save(tmp_path):
    """A world-2 run checkpointing every 2 steps crashes at step 3 (exit
    17 through the shim); the rerun resumes both ranks from rank 0's
    step-2 save and ends where an uninterrupted run ends."""
    ck = {"KFX_CHECKPOINT_DIR": str(tmp_path / "ck")}
    argv = ["--steps=6", "--log-every=2", "--checkpoint-every=2",
            "--eval-samples=256"]
    crash = _shim(argv + ["--fail-at-step=3"], ck)
    assert crash.returncode == 17, crash.stdout + crash.stderr
    assert crash.stdout.count("fault_injection_crash step=3") == 2
    assert sorted(os.listdir(tmp_path / "ck")) == ["2"]
    again = _shim(argv, ck)
    assert again.returncode == 0, again.stdout + again.stderr
    assert again.stdout.count("resumed_from_checkpoint step=2") == 2
    clean = _shim(argv, {"KFX_CHECKPOINT_DIR": str(tmp_path / "ck2")})
    assert clean.returncode == 0, clean.stdout + clean.stderr
    tail = [ln for ln in _rank_lines(clean.stdout, "step=")
            if not ln.startswith("step=2 ")]
    assert _rank_lines(again.stdout, "step=") == tail
    assert _rank_lines(again.stdout, ("loss=", "accuracy=")) == \
        _rank_lines(clean.stdout, ("loss=", "accuracy="))
    assert sorted(os.listdir(tmp_path / "ck")) == ["4", "6"]


def test_two_rank_resume_quarantines_a_torn_save(tmp_path):
    """The checkpoint chaos point at world 2 behaves as at world 1: rank
    0's second save is torn after it commits, the crash follows, and on
    the rerun rank 0 quarantines it and both ranks resume from step 2."""
    env = {"KFX_CHECKPOINT_DIR": str(tmp_path / "ck"),
           "KFX_CHAOS": f"seed=7;state={tmp_path / 'chaos.json'};"
                        "checkpoint.save:mode=corrupt,after=1,count=1"}
    argv = ["--steps=6", "--log-every=2", "--checkpoint-every=2",
            "--eval-samples=256"]
    crash = _shim(argv + ["--fail-at-step=5"], env)
    assert crash.returncode == 17, crash.stdout + crash.stderr
    assert crash.stdout.count("chaos_corrupt_checkpoint step=4") == 1
    again = _shim(argv, env)
    assert again.returncode == 0, again.stdout + again.stderr
    assert again.stdout.count("checkpoint_quarantined step=4") == 1
    assert again.stdout.count("resumed_from_checkpoint step=2") == 2
    assert again.stdout.count("train_done steps=6") == 2


@pytest.mark.slow
class TestTFRunner:
    """The TFJob worker (TensorFlow on the host, as in the reference)."""

    def test_tf_runner_single_worker(self):
        pytest.importorskip("tensorflow")
        out = _run([PY, "-m", "kubeflow_tpu_torch.runners.tf_runner",
                    "--dataset=mnist", "--steps=10", "--batch-size=64",
                    "--log-every=5", "--eval-samples=256"])
        assert out.returncode == 0, out.stdout + out.stderr
        assert "framework=tf" in out.stdout
        assert "train_done steps=10" in out.stdout
        assert "accuracy=" in out.stdout

    def test_tf_runner_two_worker_mwms(self):
        """MultiWorkerMirroredStrategy: grads all-reduce, so workers print
        identical synchronized losses."""
        pytest.importorskip("tensorflow")
        from kubeflow_tpu_torch.utils.net import free_ports

        cluster = {"worker": [f"127.0.0.1:{p}" for p in free_ports(2)]}
        procs = [subprocess.Popen(
            [PY, "-m", "kubeflow_tpu_torch.runners.tf_runner",
             "--dataset=mnist", "--steps=6", "--batch-size=64",
             "--log-every=3", "--eval-samples=128"],
            env=_env({"TF_CONFIG": json.dumps(
                {"cluster": cluster,
                 "task": {"type": "worker", "index": i}}),
                "CUDA_VISIBLE_DEVICES": "-1"}),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=REPO) for i in range(2)]
        outs = [p.communicate(timeout=300)[0] for p in procs]
        assert all(p.returncode == 0 for p in procs), "\n".join(outs)
        steps = [_rank_lines(o, "step=") for o in outs]
        assert steps[0] == steps[1] and steps[0]
