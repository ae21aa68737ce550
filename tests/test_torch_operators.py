"""The port's training operators (kubeflow_tpu_torch/operators), ported from
tests/test_operators.py: reconcile jobs end-to-end onto real local process
gangs that run the port's runners.

Mirrors the reference test strategy (SURVEY.md §4): the rendezvous
*contract* is asserted at the env level (what each worker receives), and
job lifecycle is integration-tested against the in-memory store with real
(tiny) subprocesses instead of a fake clientset.
"""

import json
import os
import sys
import time

import pytest

from kubeflow_tpu_torch.api import training as T
from kubeflow_tpu_torch.api.base import from_manifest
from kubeflow_tpu_torch.controlplane import ControlPlane
from kubeflow_tpu_torch.operators.training import (
    JAXJobController,
    MPIJobController,
    PyTorchJobController,
    TFJobController,
)
from kubeflow_tpu_torch.runtime import rendezvous as rdv

PY = sys.executable


def _job(kind, name, replicas_field, replica_map, run_policy=None, ns="default"):
    spec = {replicas_field: replica_map}
    if run_policy:
        spec["runPolicy"] = run_policy
    return from_manifest({
        "apiVersion": "kubeflow.org/v1", "kind": kind,
        "metadata": {"name": name, "namespace": ns}, "spec": spec})


def _tmpl(args_py, env=None):
    """Pod template running `python -c <args_py>`."""
    c = {"name": "main", "command": [PY, "-c", args_py]}
    if env:
        c["env"] = [{"name": k, "value": v} for k, v in env.items()]
    return {"spec": {"containers": [c]}}


def _wait(pred, timeout=60.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture()
def cp(tmp_path, monkeypatch):
    # The port's runners take every core for torch's intra-op threads;
    # under xdist that oversubscribes the host (workers inherit this).
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    plane = ControlPlane(home=str(tmp_path / "kfx"), worker_platform="cpu")
    with plane:
        yield plane


ENV_DUMP = ("import json,os;"
            "print(json.dumps({k:v for k,v in os.environ.items()}))")


class TestEnvContracts:
    """Unit-level: what env does each kind inject? (SURVEY.md §4 key insight:
    the reference tests multi-worker logic at the env-injection level.)"""

    def _specs(self, ctrl_cls, job, tmp_path):
        cp_ = ControlPlane(home=str(tmp_path / "h"), worker_platform="cpu")
        ctrl = next(c for c in cp_.manager.controllers.values()
                    if isinstance(c, ctrl_cls))
        specs, hook = ctrl.build_specs(job, str(tmp_path / "wd"))
        cp_.stop()
        return specs, hook

    def test_jaxjob_env(self, tmp_path):
        job = _job("JAXJob", "j", "jaxReplicaSpecs",
                   {"Worker": {"replicas": 3, "template": _tmpl("pass")}})
        specs, hook = self._specs(JAXJobController, job, tmp_path)
        assert [s.id for s in specs] == ["worker-0", "worker-1", "worker-2"]
        for rank, s in enumerate(specs):
            assert s.env[rdv.ENV_NUM_PROCESSES] == "3"
            assert s.env[rdv.ENV_PROCESS_ID] == str(rank)
            # The port pins KFX_DEVICE where the reference pins
            # JAX_PLATFORMS (+ its CPU collectives knob).
            assert s.env[rdv.ENV_DEVICE] == "cpu"
            assert "JAX_PLATFORMS" not in s.env
            assert "JAX_CPU_COLLECTIVES_IMPLEMENTATION" not in s.env
        # Coordinator is allocated per attempt, distinct across attempts.
        a0 = hook(0)["*"][rdv.ENV_COORDINATOR]
        a1 = hook(1)["*"][rdv.ENV_COORDINATOR]
        assert a0.startswith("127.0.0.1:") and a0 != a1

    def test_tfjob_tf_config(self, tmp_path):
        job = _job("TFJob", "t", "tfReplicaSpecs", {
            "Chief": {"replicas": 1, "template": _tmpl("pass")},
            "Worker": {"replicas": 2, "template": _tmpl("pass")},
            "PS": {"replicas": 1, "template": _tmpl("pass")},
        })
        specs, hook = self._specs(TFJobController, job, tmp_path)
        # TF_CONFIG is injected per attempt (launch-time ports), keyed by
        # replica id — not baked into the spec env at build time.
        env0 = hook(0)
        cfg = json.loads(env0["worker-1"]["TF_CONFIG"])
        assert set(cfg["cluster"]) == {"chief", "worker", "ps"}
        assert len(cfg["cluster"]["worker"]) == 2
        assert cfg["task"] == {"type": "worker", "index": 1}
        # every member sees the identical cluster spec
        assert all(json.loads(e["TF_CONFIG"])["cluster"] == cfg["cluster"]
                   for e in env0.values())
        assert set(env0) == {s.id for s in specs}
        # chief is rank 0 (first member) for gang success semantics
        assert specs[0].id == "chief-0"
        # a restart rendezvouses on fresh ports
        cfg1 = json.loads(hook(1)["worker-1"]["TF_CONFIG"])
        assert cfg1["cluster"] != cfg["cluster"]

    def test_tfjob_parallel_jobs_bindable_ports(self, cp):
        """Port-race regression: several TFJobs launching at once must all
        hand their members ports they can actually bind (allocation
        happens at launch, collisions would crash the TF server and be
        retried with fresh ports)."""
        script = (
            "import json, os, socket\n"
            "cfg = json.loads(os.environ['TF_CONFIG'])\n"
            "t = cfg['task']\n"
            "addr = cfg['cluster'][t['type']][t['index']]\n"
            "host, port = addr.rsplit(':', 1)\n"
            "s = socket.socket()\n"
            "s.bind((host, int(port)))  # my advertised port must be free\n"
            "s.listen(1)\n"
            "import time; time.sleep(1.0)\n"
            "s.close()\n")
        names = [f"tfp-{i}" for i in range(4)]
        for n in names:
            cp.apply([_job("TFJob", n, "tfReplicaSpecs", {
                "Chief": {"replicas": 1, "template": _tmpl(script)},
                "Worker": {"replicas": 2, "template": _tmpl(script)},
            })])
        for n in names:
            final = cp.wait_for_job("TFJob", n, timeout=120)
            assert final.has_condition(T.JOB_SUCCEEDED), \
                cp.job_logs("TFJob", n)

    def test_pytorchjob_env(self, tmp_path):
        job = _job("PyTorchJob", "p", "pytorchReplicaSpecs", {
            "Master": {"replicas": 1, "template": _tmpl("pass")},
            "Worker": {"replicas": 2, "template": _tmpl("pass")},
        })
        specs, hook = self._specs(PyTorchJobController, job, tmp_path)
        assert specs[0].id == "master-0" and specs[0].env["RANK"] == "0"
        assert {s.env["RANK"] for s in specs} == {"0", "1", "2"}
        assert all(s.env["WORLD_SIZE"] == "3" for s in specs)
        assert all(s.env["MASTER_ADDR"] == "127.0.0.1" for s in specs)
        assert hook(0)["*"]["MASTER_PORT"].isdigit()

    def test_mpijob_hostfile_and_launcher_rewrite(self, tmp_path):
        job = _job("MPIJob", "m", "mpiReplicaSpecs", {
            "Launcher": {"replicas": 1, "template": _tmpl("pass")},
            "Worker": {"replicas": 2, "template": _tmpl("pass")},
        })
        job.spec["slotsPerWorker"] = 2
        wd = tmp_path / "wd"
        wd.mkdir()
        cp_ = ControlPlane(home=str(tmp_path / "h"), worker_platform="cpu")
        ctrl = next(c for c in cp_.manager.controllers.values()
                    if isinstance(c, MPIJobController))
        specs, _ = ctrl.build_specs(job, str(wd))
        cp_.stop()
        hosts = (wd / "hostfile").read_text()
        assert hosts == "worker-0 slots=2\nworker-1 slots=2\n"
        launcher = specs[0]
        assert launcher.id == "launcher-0"
        assert launcher.env["KFX_MPI_WORLD_SIZE"] == "4"
        workers = [s for s in specs if s.replica_type == "Worker"]
        assert [w.env["OMPI_COMM_WORLD_RANK"] for w in workers] == ["0", "2"]

    def test_mpirun_is_routed_through_shim(self):
        argv = MPIJobController._launcher_argv(
            ["mpirun", "-np", "4", "python", "train.py"])
        assert argv[:3] == [sys.executable, "-m",
                            "kubeflow_tpu_torch.runners.mpi_launcher"]
        assert argv[3:] == ["-np", "4", "python", "train.py"]


class TestJobLifecycle:
    def test_jaxjob_succeeds(self, cp):
        job = _job("JAXJob", "ok", "jaxReplicaSpecs", {"Worker": {
            "replicas": 2,
            "template": _tmpl("import os; print('rank', os.environ['KFX_PROCESS_ID'])")}})
        cp.apply([job])
        final = cp.wait_for_job("JAXJob", "ok", timeout=90)
        assert final.has_condition(T.JOB_SUCCEEDED)
        assert not final.has_condition(T.JOB_RUNNING)
        assert final.status["replicaStatuses"]["worker"]["succeeded"] == 2
        assert "completionTime" in final.status
        log = cp.job_logs("JAXJob", "ok")
        assert "rank 0" in log

    def test_failure_with_backoff_and_restart_count(self, cp):
        job = _job("JAXJob", "bad", "jaxReplicaSpecs",
                   {"Worker": {"replicas": 1, "restartPolicy": "OnFailure",
                               "template": _tmpl("raise SystemExit(3)")}},
                   run_policy={"backoffLimit": 2})
        cp.apply([job])
        final = cp.wait_for_job("JAXJob", "bad", timeout=90)
        assert final.has_condition(T.JOB_FAILED)
        assert final.status["restartCount"] == 2
        assert final.status["replicaStatuses"]["worker"]["failed"] == 1

    def test_restart_policy_never(self, cp):
        job = _job("JAXJob", "never", "jaxReplicaSpecs",
                   {"Worker": {"replicas": 1, "restartPolicy": "Never",
                               "template": _tmpl("raise SystemExit(3)")}})
        cp.apply([job])
        final = cp.wait_for_job("JAXJob", "never", timeout=90)
        assert final.has_condition(T.JOB_FAILED)
        assert final.status.get("restartCount", 0) == 0

    def test_chief_success_tears_down_ps(self, cp):
        """TFJob: PS never exits; chief exit 0 + cleanPodPolicy=Running must
        still complete the job (reference tf-operator semantics)."""
        job = _job("TFJob", "tf", "tfReplicaSpecs", {
            "Chief": {"replicas": 1, "template": _tmpl("print('chief done')")},
            "PS": {"replicas": 1, "template": _tmpl(
                "import time\nwhile True: time.sleep(1)")},
        }, run_policy={"cleanPodPolicy": "Running"})
        cp.apply([job])
        final = cp.wait_for_job("TFJob", "tf", timeout=90)
        assert final.has_condition(T.JOB_SUCCEEDED)

    def test_delete_kills_gang(self, cp):
        job = _job("JAXJob", "del", "jaxReplicaSpecs", {"Worker": {
            "replicas": 1,
            "template": _tmpl("import time\nwhile True: time.sleep(1)")}})
        cp.apply([job])
        cp.wait_for_condition("JAXJob", "del", T.JOB_RUNNING, timeout=90)
        gang = cp.gangs.get("jaxjob/default/del")
        assert gang is not None
        pid = next(iter(gang.status().replicas.values())).pid
        cp.store.delete("JAXJob", "del")
        _wait(lambda: not _alive(pid), what="process death")

    def test_suspend_and_resume(self, cp):
        job = _job("JAXJob", "susp", "jaxReplicaSpecs", {"Worker": {
            "replicas": 1,
            "template": _tmpl("import time; time.sleep(0.3)")}},
            run_policy={"suspend": True})
        cp.apply([job])
        cp.wait_for_condition("JAXJob", "susp", T.JOB_SUSPENDED, timeout=90)
        assert cp.gangs.get("jaxjob/default/susp") is None
        # Resume: clear the flag via apply.
        fresh = cp.store.get("JAXJob", "susp")
        fresh.spec["runPolicy"]["suspend"] = False
        cp.store.update(fresh)
        final = cp.wait_for_job("JAXJob", "susp", timeout=90)
        assert final.has_condition(T.JOB_SUCCEEDED)

    def test_ttl_garbage_collection(self, cp):
        job = _job("JAXJob", "ttl", "jaxReplicaSpecs",
                   {"Worker": {"replicas": 1, "template": _tmpl("pass")}},
                   run_policy={"ttlSecondsAfterFinished": 1})
        cp.apply([job])
        cp.wait_for_job("JAXJob", "ttl", timeout=90)
        _wait(lambda: cp.store.try_get("JAXJob", "ttl") is None,
              timeout=30, what="ttl deletion")

    def test_active_deadline(self, cp):
        job = _job("JAXJob", "dl", "jaxReplicaSpecs", {"Worker": {
            "replicas": 1, "restartPolicy": "Never",
            "template": _tmpl("import time\nwhile True: time.sleep(1)")}},
            run_policy={"activeDeadlineSeconds": 1})
        cp.apply([job])
        final = cp.wait_for_job("JAXJob", "dl", timeout=90)
        assert final.has_condition(T.JOB_FAILED)
        failed = next(c for c in final.conditions if c.type == "Failed")
        assert failed.reason in ("GangFailed",)

    def test_mpijob_launcher_shim_runs_ranks(self, cp):
        """`mpirun -np 2 python -c ...` through the shim: both ranks run and
        the job succeeds when the launcher exits 0."""
        rank_prog = ("import os; print('mpirank',"
                     " os.environ['OMPI_COMM_WORLD_RANK'])")
        job = _job("MPIJob", "mpi", "mpiReplicaSpecs", {
            "Launcher": {"replicas": 1, "template": {"spec": {"containers": [{
                "name": "l",
                "command": ["mpirun", "-np", "2", PY, "-c", rank_prog]}]}}},
            "Worker": {"replicas": 2, "template": _tmpl(
                "import time\nwhile True: time.sleep(1)")},
        })
        cp.apply([job])
        final = cp.wait_for_job("MPIJob", "mpi", timeout=90)
        assert final.has_condition(T.JOB_SUCCEEDED)
        log = cp.job_logs("MPIJob", "mpi")
        assert "mpirank 0" in log and "mpirank 1" in log


def _alive(pid):
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False


class TestKfxCLI:
    def test_run_get_describe_logs(self, tmp_path, capsys):
        from kubeflow_tpu_torch.cli import main as kfx_main

        manifest = tmp_path / "job.yaml"
        manifest.write_text(f"""
apiVersion: kubeflow.org/v1
kind: JAXJob
metadata:
  name: cli-job
spec:
  jaxReplicaSpecs:
    Worker:
      replicas: 1
      template:
        spec:
          containers:
          - name: main
            command: ["{PY}", "-c", "print('hello from job')"]
""")
        home = str(tmp_path / "home")
        rc = kfx_main(["--home", home, "run", "-f", str(manifest)])
        out = capsys.readouterr().out
        assert rc == 0
        assert "jaxjob/cli-job created" in out
        assert "hello from job" in out
        assert "jaxjob/cli-job succeeded" in out

        # State persisted via the journal: get/describe work in a new process.
        rc = kfx_main(["--home", home, "get", "jaxjobs"])
        out = capsys.readouterr().out
        assert rc == 0 and "cli-job" in out and "Succeeded" in out

        rc = kfx_main(["--home", home, "describe", "jaxjob", "cli-job"])
        out = capsys.readouterr().out
        assert rc == 0 and "kind: JAXJob" in out

        rc = kfx_main(["--home", home, "logs", "jaxjob", "cli-job"])
        out = capsys.readouterr().out
        assert rc == 0 and "hello from job" in out

        rc = kfx_main(["--home", home, "delete", "jaxjob", "cli-job"])
        out = capsys.readouterr().out
        assert rc == 0 and "deleted" in out


class TestDistributedE2E:
    def test_two_worker_jaxjob_trains_mnist(self, cp):
        """The north-star slice (SURVEY.md §7 step 4): a 2-worker JAXJob
        where workers rendezvous via jax.distributed, train data-parallel,
        and the job completes via the reconcile loop."""
        job = _job("JAXJob", "mnist-e2e", "jaxReplicaSpecs", {"Worker": {
            "replicas": 2,
            "template": {"spec": {"containers": [{
                "name": "jax",
                "command": [PY, "-m", "kubeflow_tpu_torch.runners.jax_runner",
                            "--model=mlp", "--dataset=mnist", "--steps=8",
                            "--batch-size=64", "--log-every=4",
                            "--no-checkpoint"],
            }]}}}})
        cp.apply([job])
        final = cp.wait_for_job("JAXJob", "mnist-e2e", timeout=180)
        assert final.has_condition(T.JOB_SUCCEEDED), \
            cp.job_logs("JAXJob", "mnist-e2e")
        log = cp.job_logs("JAXJob", "mnist-e2e")
        assert "world=2" in log
        assert "train_done steps=8" in log

    def test_parameter_server_tfjob_trains_mnist(self, cp):
        """The TensorFlow runner stays on the host (the card's machine has
        no TensorFlow). Live ParameterServerStrategy TFJob (the reference
        tf-operator's original flagship mode, SURVEY.md §2.1/§2.3): the
        chief drives a ClusterCoordinator, two workers execute scheduled
        steps, and the PS task serves every model/optimizer variable. ps
        and worker servers never exit; chief success + cleanPodPolicy=
        Running reaps them and completes the job."""
        pytest.importorskip("tensorflow")
        runner = [PY, "-m", "kubeflow_tpu_torch.runners.tf_runner",
                  "--dataset=mnist", "--steps=60", "--batch-size=128",
                  "--log-every=20", "--eval-samples=512"]
        tmpl = {"spec": {"containers": [{"name": "tf", "command": runner}]}}
        job = _job("TFJob", "ps-e2e", "tfReplicaSpecs", {
            "Chief": {"replicas": 1, "template": tmpl},
            "Worker": {"replicas": 2, "template": tmpl},
            "PS": {"replicas": 1, "template": tmpl},
        }, run_policy={"cleanPodPolicy": "Running"})
        cp.apply([job])
        final = cp.wait_for_job("TFJob", "ps-e2e", timeout=300)
        log = cp.job_logs("TFJob", "ps-e2e")  # chief replica
        assert final.has_condition(T.JOB_SUCCEEDED), log
        assert "mode=ps role=chief:0" in log
        assert "mode=ps role=ps:0 server=started" in cp.job_logs(
            "TFJob", "ps-e2e", replica="ps-0")
        assert "mode=ps role=worker:1 server=started" in cp.job_logs(
            "TFJob", "ps-e2e", replica="worker-1")
        # Every variable (6 model params + 12 Adam slots) genuinely lives
        # on the PS server.
        assert "variables_total=18 variables_on_ps=18" in log
        assert "/job:ps" in log
        assert "train_done steps=60" in log
        # Converging, not just running: eval accuracy well above the 0.1
        # chance floor after 60 steps.
        evals = [ln for ln in log.splitlines() if ln.startswith("accuracy=")]
        assert evals, log
        assert float(evals[-1].split("=")[1]) > 0.4, evals


# -- the port's own decisions (operators/training.py docstring) --------------

class TestPortDevicePin:
    """KFX_DEVICE replaces the reference's JAX_PLATFORMS pin, and no gang
    width moves a job off the card."""

    def _ctrl(self, ctrl_cls, tmp_path, platform):
        cp_ = ControlPlane(home=str(tmp_path / "h"),
                           worker_platform=platform)
        ctrl = next(c for c in cp_.manager.controllers.values()
                    if isinstance(c, ctrl_cls))
        cp_.stop()
        return ctrl

    @pytest.mark.parametrize("platform,env,want", [
        (None, None, "cuda"), (None, "cpu", "cpu"), ("cpu", None, "cpu"),
        ("cuda", "cpu", "cuda")])
    def test_pin_for_every_gang_width(self, tmp_path, monkeypatch,
                                      platform, env, want):
        """The reference forces cpu on any multi-replica gang
        (training.py:104-107, :358-367); the port pins the plane's
        choice, else KFX_WORKER_PLATFORM, else cuda, at any width."""
        if env is None:
            monkeypatch.delenv("KFX_WORKER_PLATFORM", raising=False)
        else:
            monkeypatch.setenv("KFX_WORKER_PLATFORM", env)
        for replicas in (1, 3):
            job = _job("JAXJob", "j", "jaxReplicaSpecs", {"Worker": {
                "replicas": replicas, "template": _tmpl("pass")}})
            ctrl = self._ctrl(JAXJobController, tmp_path, platform)
            specs, _ = ctrl.build_specs(job, str(tmp_path / "wd"))
            assert {s.env[rdv.ENV_DEVICE] for s in specs} == {want}
        job = _job("PyTorchJob", "p", "pytorchReplicaSpecs", {
            "Master": {"replicas": 1, "template": _tmpl("pass")},
            "Worker": {"replicas": 2, "template": _tmpl("pass")}})
        specs, _ = self._ctrl(PyTorchJobController, tmp_path,
                              platform).build_specs(job, str(tmp_path))
        assert {s.env[rdv.ENV_DEVICE] for s in specs} == {want}
        job = _job("MPIJob", "m", "mpiReplicaSpecs", {
            "Launcher": {"replicas": 1, "template": _tmpl("pass")},
            "Worker": {"replicas": 2, "template": _tmpl("pass")}})
        wd = tmp_path / "mpi"
        wd.mkdir(exist_ok=True)
        specs, _ = self._ctrl(MPIJobController, tmp_path,
                              platform).build_specs(job, str(wd))
        # The launcher carries the pin; the shim's ranks inherit it.
        assert specs[0].env[rdv.ENV_DEVICE] == want
        job = _job("TFJob", "t", "tfReplicaSpecs", {
            "Worker": {"replicas": 2, "template": _tmpl("pass")}})
        specs, _ = self._ctrl(TFJobController, tmp_path,
                              platform).build_specs(job, str(tmp_path))
        assert all(rdv.ENV_DEVICE not in s.env for s in specs)

    def test_manifest_env_and_argv_win(self, tmp_path):
        job = _job("JAXJob", "j", "jaxReplicaSpecs", {"Worker": {
            "replicas": 1, "template": _tmpl("pass", env={
                "KFX_DEVICE": "cpu"})}})
        ctrl = self._ctrl(JAXJobController, tmp_path, "cuda")
        specs, _ = ctrl.build_specs(job, str(tmp_path / "wd"))
        assert specs[0].env[rdv.ENV_DEVICE] == "cpu"

    def test_runner_reads_the_pin_and_argv_wins(self, monkeypatch):
        from kubeflow_tpu_torch.runners import jax_runner, lm_runner
        from kubeflow_tpu_torch.runners import torch_runner
        from kubeflow_tpu_torch import device

        assert device.ENV_DEVICE == rdv.ENV_DEVICE
        for mod in (jax_runner, lm_runner, torch_runner):
            monkeypatch.setenv("KFX_DEVICE", "cpu")
            assert mod.parse_args([]).device == "cpu"
            assert mod.parse_args(["--device", "cuda"]).device == "cuda"
            monkeypatch.delenv("KFX_DEVICE")
            assert mod.parse_args([]).device == "cuda"
        monkeypatch.setenv("KFX_DEVICE", "tpu")
        with pytest.raises(ValueError, match="KFX_DEVICE='tpu'"):
            jax_runner.parse_args([])

    def test_cuda_worker_without_a_card_fails_the_job(self, tmp_path,
                                                       monkeypatch):
        """The plane asks for cuda by default; where there is no card the
        worker's resolve_device raises and the JOB fails: the choice of
        device never falls back to the CPU."""
        import torch

        monkeypatch.delenv("KFX_WORKER_PLATFORM", raising=False)
        job = _job("JAXJob", "nocard", "jaxReplicaSpecs", {"Worker": {
            "replicas": 2, "restartPolicy": "Never",
            "template": {"spec": {"containers": [{
                "name": "w", "command": [
                    PY, "-m", "kubeflow_tpu_torch.runners.jax_runner",
                    "--model=mlp", "--dataset=mnist", "--steps=2",
                    "--batch-size=8", "--log-every=1", "--eval-samples=16",
                    "--no-checkpoint"]}]}}}})
        with ControlPlane(home=str(tmp_path / "kfx")) as plane:
            plane.apply([job])
            final = plane.wait_for_job("JAXJob", "nocard", timeout=120)
            log = plane.job_logs("JAXJob", "nocard")
        if torch.cuda.is_available():
            assert final.has_condition(T.JOB_SUCCEEDED), log
            assert "platform=cuda" in log
        else:
            assert final.has_condition(T.JOB_FAILED), log
            assert "torch.cuda.is_available() is false" in log


class TestRanksPerReplica:
    """A JAXJob replica whose spec.parallelism spans k chips runs as k
    ranks of one gang (the reference: one process over k virtual
    devices)."""

    def test_lm_example_plan_is_eight_ranks(self, tmp_path):
        from kubeflow_tpu_torch.api.manifest import load_manifest_file

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        [job] = load_manifest_file(
            os.path.join(repo, "examples", "torch", "lm-jaxjob.yaml"))
        assert job.chip_count() == 8
        cp_ = ControlPlane(home=str(tmp_path / "h"), worker_platform="cpu")
        ctrl = next(c for c in cp_.manager.controllers.values()
                    if isinstance(c, JAXJobController))
        specs, hook = ctrl.build_specs(job, str(tmp_path / "wd"))
        cp_.stop()
        assert [s.id for s in specs] == ["worker-0"] + [
            f"worker-0.{m}" for m in range(1, 8)]
        assert [s.env[rdv.ENV_PROCESS_ID] for s in specs] == [
            str(r) for r in range(8)]
        assert {s.env[rdv.ENV_NUM_PROCESSES] for s in specs} == {"8"}
        assert {s.env[rdv.ENV_REPLICA_INDEX] for s in specs} == {"0"}
        assert {s.env["KFX_PARALLELISM"] for s in specs} == {json.dumps(
            {"tensor": 2, "data": 4, "fsdp": True, "sp": True})}
        assert {tuple(s.argv) for s in specs} == {tuple(
            job.replica_specs()["Worker"].argv())}
        # One coordinator for the whole gang, fresh per attempt.
        assert set(hook(0)) == {"*"}

    def test_two_chip_worker_trains_as_two_ranks(self, cp):
        """An LM JAXJob declaring tensor: 2 with one Worker: two ranks of
        the port's lm_runner meet over gloo, print the reference's plan
        and the same losses, and the job reads one succeeded replica."""
        job = _job("JAXJob", "lm-tp2", "jaxReplicaSpecs", {"Worker": {
            "replicas": 1, "restartPolicy": "Never",
            "template": {"spec": {"containers": [{
                "name": "lm", "env": [{"name": "OMP_NUM_THREADS",
                                       "value": "1"}],
                "command": [PY, "-m", "kubeflow_tpu_torch.runners.lm_runner",
                            "--preset=tiny", "--seq-len=32", "--steps=2",
                            "--batch-size=4", "--log-every=1",
                            "--no-checkpoint"]}]}}}})
        job.spec["parallelism"] = {"tensor": 2}
        cp.apply([job])
        final = cp.wait_for_job("JAXJob", "lm-tp2", timeout=180)
        logs = [cp.job_logs("JAXJob", "lm-tp2"),
                cp.job_logs("JAXJob", "lm-tp2", replica="worker-0.1")]
        assert final.has_condition(T.JOB_SUCCEEDED), logs
        assert final.status["replicaStatuses"] == {
            "worker": {"active": 0, "succeeded": 1, "failed": 0}}
        for r, log in enumerate(logs):
            assert f"process_group backend=gloo rank={r} world=2" in log
            assert "plan=pp1/dp1/tp2" in log
        steps = [[ln.split(" step_time=")[0] for ln in log.splitlines()
                  if ln.startswith("step=")] for log in logs]
        assert steps[0] and steps[0] == steps[1]


class TestKfxCLIPort:
    """The port's CLI: the reference's verbs' surface, with the verbs and
    kinds of later slices refused by name."""

    @pytest.mark.parametrize("verb", ["init", "generate", "server",
                                      "profile"])
    def test_kfctl_server_and_profile_verbs_run(self, tmp_path, capsys,
                                                monkeypatch, verb):
        """init, generate, server and profile run in the port (A 8.4 and
        A 8.6): init scaffolds a KfDef, generate renders it, `kfx server`
        starts, writes its marker and stops on SIGTERM with rc 0, and
        profile of a ghost job answers the reference's NotFound."""
        import signal
        import subprocess

        from kubeflow_tpu_torch.cli import main as kfx_main

        home = str(tmp_path / "home")
        monkeypatch.chdir(tmp_path)
        if verb == "server":
            repo = os.path.dirname(os.path.dirname(os.path.abspath(
                __file__)))
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith("KFX_")}
            proc = subprocess.Popen(
                [PY, "-m", "kubeflow_tpu_torch.cli", "--home", home,
                 "server", "--port", "0"], cwd=repo, env=env, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            marker = os.path.join(home, "server.json")
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and not os.path.exists(
                    marker):
                time.sleep(0.05)
            assert os.path.exists(marker)
            proc.send_signal(signal.SIGTERM)
            text, _ = proc.communicate(timeout=60)
            assert proc.returncode == 0, text
            assert "kfx apiserver + dashboard on http://127.0.0.1:" in text
            assert not os.path.exists(marker)
        else:
            if verb == "generate":
                assert kfx_main(["init", "plat"]) == 0
                capsys.readouterr()
            argv, rc, want = {
                "init": (["init", "plat"], 0, "wrote kfdef.yaml"),
                "generate": (["generate", "-f", "kfdef.yaml"], 0,
                             "00-profile-plat.yaml"),
                "profile": (["profile", "jaxjob", "ghost"], 1,
                            "JAXJob default/ghost not found")}[verb]
            assert kfx_main(["--home", home] + argv) == rc
            cap = capsys.readouterr()
            text = cap.out + cap.err
            assert want in text
        assert "is not ported yet" not in text

    @pytest.mark.parametrize("argv,rc,text", [
        (["trace", "jaxjob", "x"], 1, "not found"),
        (["top"], 0, "slice: capacity="),
        (["query", "kfx_gangs"], 1, "no samples in the window"),
        (["alerts"], 0, "replica-restart-rate"),
        (["slo"], 0, "no SLOs applied"),
        (["usage"], 1, "no tenant usage recorded")])
    def test_ported_verb_runs_on_a_passive_plane(self, tmp_path, capsys,
                                                 argv, rc, text):
        """trace, top, query, alerts, slo and usage run in local mode
        against the home's journal, on a passive plane (no scrape, no
        reconcile): on an empty home each answers as the reference's
        does."""
        from kubeflow_tpu_torch.cli import main as kfx_main

        home = str(tmp_path / "home")
        assert kfx_main(["--home", home] + argv) == rc
        cap = capsys.readouterr()
        assert text in cap.out + cap.err
        assert "is not ported yet" not in cap.err

    def test_torch_experiment_example_is_stored(self, tmp_path):
        """Experiment, Suggestion and Trial apply now (A 8.2 landed): the
        torch example is stored as written, its trials on the port's
        runner with no JAX platform env."""
        from kubeflow_tpu_torch.api.manifest import load_manifest_file

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        cp = ControlPlane(home=str(tmp_path / "home"), journal=True,
                          worker_platform="cpu")
        try:
            out = cp.apply(load_manifest_file(os.path.join(
                repo, "examples", "torch", "experiment-random-mnist.yaml")))
            assert [(o.KIND, verb) for o, verb in out] == [
                ("Experiment", "created")]
            exp = cp.store.get("Experiment", "mnist-random")
            assert exp.max_trial_count() == 6
            assert exp.parallel_trial_count() == 2
            (c,) = exp.trial_template()["trialSpec"]["spec"][
                "jaxReplicaSpecs"]["Worker"]["template"]["spec"]["containers"]
            assert c["command"][-1] == "kubeflow_tpu_torch.runners.jax_runner"
            assert "env" not in c
        finally:
            cp.stop()

    def test_run_experiment_example_on_the_cpu(self, tmp_path, capsys,
                                                monkeypatch):
        """BASELINE.json #4 through `kfx run`, its six trials pinned to
        the CPU: the Experiment succeeds with 6 of 6 trials, prints its
        best trial, and the best is the largest final accuracy."""
        import re

        from kubeflow_tpu_torch.cli import main as kfx_main
        from kubeflow_tpu_torch.core.store import ResourceStore

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        monkeypatch.setenv("KFX_WORKER_PLATFORM", "cpu")
        monkeypatch.setenv("OMP_NUM_THREADS", "1")
        home = str(tmp_path / "home")
        rc = kfx_main(["--home", home, "run", "--timeout", "300", "-f",
                       os.path.join(repo, "examples", "torch",
                                    "experiment-random-mnist.yaml")])
        out = capsys.readouterr().out
        assert rc == 0, out
        assert "experiment/mnist-random succeeded" in out
        best_line = next(ln for ln in out.splitlines()
                         if ln.startswith("best trial: "))
        store = ResourceStore(os.path.join(home, "state.db"))
        try:
            exp = store.get("Experiment", "mnist-random")
            assert exp.status["trialsSucceeded"] == 6, exp.status
            assert store.get("Suggestion", "mnist-random").spec[
                "requests"] == 6
            accs = {}
            for t in store.list("Trial"):
                log = open(os.path.join(
                    home, "gangs", f"jaxjob_default_{t.name}", "logs",
                    "worker-0.log")).read()
                assert re.search(r"runner_start .*platform=cpu", log), log
                accs[t.name] = float(re.findall(
                    r"^accuracy=([0-9.]+)$", log, re.M)[-1])
        finally:
            store.close()
        best = exp.status["currentOptimalTrial"]
        assert best["bestTrialName"] == max(accs, key=accs.get)
        assert best["bestTrialName"] in best_line

    def test_profile_and_kfdef_file_applies(self, tmp_path, capsys):
        """A Profile beside a KfDef in one file: `kfx apply` stores the
        Profile and what the KfDef renders (its namespace's Profile, then
        its application stamped with the namespace and commonLabels); the
        KfDef itself is never stored."""
        from kubeflow_tpu_torch.cli import main as kfx_main
        from kubeflow_tpu_torch.core.store import ResourceStore

        home = str(tmp_path / "home")
        mixed = tmp_path / "mixed.yaml"
        mixed.write_text(
            "apiVersion: kubeflow.org/v1\nkind: Profile\n"
            "metadata: {name: team-a}\n"
            "spec: {owner: {kind: User, name: a@example.com}}\n---\n"
            "apiVersion: kfdef.apps.kubeflow.org/v1\nkind: KfDef\n"
            "metadata: {name: p}\n"
            "spec:\n  namespace: team-b\n  commonLabels: {team: b}\n"
            "  applications:\n  - name: defaults\n    resource:\n"
            "      apiVersion: kubeflow.org/v1alpha1\n"
            "      kind: PodDefault\n      metadata: {name: env-b}\n"
            "      spec: {selector: {matchLabels: {team: b}},\n"
            "             env: [{name: TEAM, value: b}]}\n")
        rc = kfx_main(["--home", home, "apply", "-f", str(mixed)])
        out = capsys.readouterr().out
        assert rc == 0, out
        for line in ("profile/team-a created", "profile/team-b created",
                     "poddefault/env-b created"):
            assert line in out
        store = ResourceStore(os.path.join(home, "state.db"))
        try:
            kinds = sorted((o.KIND, o.namespace, o.name)
                           for o in store.list_all())
            assert kinds == [("PodDefault", "team-b", "env-b"),
                             ("Profile", "default", "team-a"),
                             ("Profile", "default", "team-b")], kinds
            assert store.get("Profile", "team-b").owner() == {
                "kind": "User", "name": "p@kfdef"}
            pd = store.get("PodDefault", "env-b", "team-b")
            assert pd.metadata.labels == {"team": "b"}
        finally:
            store.close()
