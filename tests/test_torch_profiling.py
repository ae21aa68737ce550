"""The port's profiling subsystem (kubeflow_tpu_torch/profiling.py) and `kfx
profile`.

The reference's TestProfilerServer (tests/test_profiling.py) runs against
the port through ``_torch_ported``. Its TestKfxProfile cases are written
out here for the port's trace format, ``*.pt.trace.json.gz`` where the
reference's jax.profiler writes ``*.xplane.pb``, and stay ``slow`` as they
are there. Beside them, tier-1: a capture over the test process while its
main thread runs ``torch.mm`` (the listener is another thread, so this
holds only if the capture records every thread), the ``KFX_PROFILE=0``
opt-out writing no port file, one capture at a time, and a window that
holds no op answered as an error that `kfx profile` exits 1 on.
"""

import glob
import os
import subprocess
import sys
import threading
import time

import pytest

pytest.importorskip("jax")

from _torch_ported import ported  # noqa: E402

from kubeflow_tpu_torch import profiling  # noqa: E402
from kubeflow_tpu_torch.api.base import from_manifest  # noqa: E402
from kubeflow_tpu_torch.controlplane import ControlPlane  # noqa: E402

_ref_tests = ported("test_profiling.py")
PY = sys.executable
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestProfilerServer(_ref_tests.TestProfilerServer):
    pass


def _long_job(name):
    return from_manifest({
        "apiVersion": "kubeflow.org/v1", "kind": "JAXJob",
        "metadata": {"name": name, "namespace": "default"},
        "spec": {"jaxReplicaSpecs": {"Worker": {
            "replicas": 1,
            "template": {"spec": {"containers": [{
                "name": "jax",
                "command": [PY, "-m", "kubeflow_tpu_torch.runners.jax_runner",
                            "--model=mlp", "--dataset=mnist",
                            "--steps=100000", "--batch-size=64",
                            "--log-every=500", "--no-checkpoint"],
            }]}}}}}})


def _wait_port(cp, key, timeout=120):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        gang = cp.gangs.get(key)
        if gang is not None:
            port = profiling.replica_port(gang.workdir, "worker-0")
            if port is not None:
                return port
        time.sleep(0.5)
    return None


def _names(path):
    return [e.get("name", "") for e in profiling.load_trace(path)[
        "traceEvents"] if e.get("cat") == "cpu_op"]


@pytest.mark.slow
class TestKfxProfile:
    def test_capture_from_running_jaxjob(self, tmp_path, capsys):
        """Apply a long-running JAXJob, `kfx profile` it mid-training, and
        assert a trace of its ops lands on disk."""
        from kubeflow_tpu_torch.cli import KfxCLI

        with ControlPlane(home=str(tmp_path / "kfx"),
                          worker_platform="cpu") as cp:
            cp.apply([_long_job("prof-job")])
            cli = KfxCLI(cp)
            port = _wait_port(cp, "jaxjob/default/prof-job")
            assert port is not None, "worker never advertised profiler port"
            time.sleep(5.0)  # let training get past start-up into the loop

            logdir = str(tmp_path / "trace")
            rc = cli.profile("JAXJob", "prof-job", "default", "",
                             duration_ms=1500, logdir=logdir)
            out = capsys.readouterr().out
            assert rc == 0, out
            dumps = [line for line in out.splitlines()
                     if line.endswith(profiling.TRACE_SUFFIX)]
            assert dumps and os.path.exists(dumps[0])
            assert os.path.getsize(dumps[0]) > 0
            assert any(n.startswith("aten::") for n in _names(dumps[0]))

            cp.store.delete("JAXJob", "prof-job")

    def test_profile_not_running(self, tmp_path, capsys):
        from kubeflow_tpu_torch.cli import KfxCLI
        from kubeflow_tpu_torch.core.store import NotFound

        with ControlPlane(home=str(tmp_path / "kfx"),
                          worker_platform="cpu") as cp:
            with pytest.raises(NotFound):
                KfxCLI(cp).profile("JAXJob", "ghost", "default", "",
                                   duration_ms=100, logdir=str(tmp_path))
            cp.apply([_long_job("idle")])
            # applied but pick a replica that never existed
            rc = KfxCLI(cp).profile("JAXJob", "idle", "default",
                                    "worker-7", duration_ms=100,
                                    logdir=str(tmp_path))
            assert rc == 1
            assert "profiler port" in capsys.readouterr().err
            cp.store.delete("JAXJob", "idle")

    def test_profile_cross_process(self, tmp_path):
        """A PASSIVE second control plane on the same home (what a second
        `kfx profile` invocation opens) can trace a job owned by the
        first process — and must not spawn duplicate gangs."""
        from kubeflow_tpu_torch.cli import KfxCLI

        home = str(tmp_path / "kfx")
        with ControlPlane(home=home, journal=True,
                          worker_platform="cpu") as owner:
            owner.apply([_long_job("xproc")])
            assert _wait_port(owner, "jaxjob/default/xproc") is not None
            time.sleep(5.0)

            with ControlPlane(home=home, journal=True, passive=True,
                              worker_platform="cpu") as viewer:
                assert viewer.gangs.get("jaxjob/default/xproc") is None
                rc = KfxCLI(viewer).profile(
                    "JAXJob", "xproc", "default", "", duration_ms=1500,
                    logdir=str(tmp_path / "xtrace"))
                assert rc == 0
                # passive plane never reconciled -> no duplicate gang
                assert viewer.gangs.get("jaxjob/default/xproc") is None
            assert glob.glob(str(tmp_path / "xtrace" / "plugins" /
                                 "profile" / "*" /
                                 f"*{profiling.TRACE_SUFFIX}"))
            owner.store.delete("JAXJob", "xproc")


class TestTraceServer:
    def test_capture_records_the_main_threads_ops(self, tmp_path,
                                                  monkeypatch):
        """The listener thread runs the profiler while this (main) thread
        multiplies: the trace must hold its aten::mm ops, in the
        TensorBoard layout, with the window in its kfxCapture header."""
        import torch

        monkeypatch.delenv(profiling.ENV_PROFILE, raising=False)
        monkeypatch.delenv("KFX_WORKDIR", raising=False)
        port = profiling.maybe_start_profiler_server()
        assert port is not None
        done, res = threading.Event(), {}

        def capture():
            try:
                res["paths"] = profiling.capture_trace(
                    f"localhost:{port}", str(tmp_path / "logdir"), 300)
            except Exception as e:  # reported by the assertion below
                res["error"] = e
            finally:
                done.set()

        th = threading.Thread(target=capture)
        th.start()
        a = torch.randn(32, 32)
        while not done.is_set():
            a = torch.mm(a, a).tanh()
        th.join(timeout=60)
        assert not th.is_alive() and "error" not in res, res
        [path] = res["paths"]
        assert glob.glob(str(tmp_path / "logdir" / "plugins" / "profile" /
                             "*" / "worker-0.pt.trace.json.gz")) == [path]
        trace = profiling.load_trace(path)
        head = trace["kfxCapture"]
        assert head["duration_ms"] == 300 and head["pid"] == os.getpid()
        assert head["end"] - head["start"] >= 0.3
        mm = [e for e in trace["traceEvents"] if e.get("name") == "aten::mm"]
        assert mm and {e["tid"] for e in mm} == {threading.get_native_id()}

    def test_opt_out_advertises_no_port(self, tmp_path, monkeypatch):
        monkeypatch.setenv("KFX_WORKDIR", str(tmp_path))
        monkeypatch.setenv("KFX_REPLICA_TYPE", "Worker")
        monkeypatch.setenv("KFX_REPLICA_INDEX", "3")
        monkeypatch.setenv(profiling.ENV_PROFILE, "0")
        assert profiling.maybe_start_profiler_server() is None
        assert not os.path.exists(os.path.join(tmp_path, "profiler"))
        monkeypatch.delenv(profiling.ENV_PROFILE)
        port = profiling.maybe_start_profiler_server()
        assert profiling.replica_port(str(tmp_path), "worker-3") == port

    def test_one_capture_at_a_time(self, tmp_path, monkeypatch):
        """While a capture runs, a second request is answered 409 and the
        client raises; the running one is not disturbed."""
        monkeypatch.delenv(profiling.ENV_PROFILE, raising=False)
        monkeypatch.delenv("KFX_WORKDIR", raising=False)
        port = profiling.maybe_start_profiler_server()
        server = profiling._SERVER
        assert server is not None and server.port == port
        assert server._busy.acquire(blocking=False)  # a capture "runs"
        try:
            with pytest.raises(RuntimeError, match="409.*already running"):
                profiling.capture_trace(f"localhost:{port}",
                                        str(tmp_path), 100)
        finally:
            server._busy.release()

    def test_idle_window_fails_and_profile_exits_1(self, tmp_path, capsys):
        """A worker that runs no op in the window: the capture is an
        error, and `kfx profile` prints it and exits 1 (no empty trace
        is written)."""
        from kubeflow_tpu_torch.cli import KfxCLI

        with ControlPlane(home=str(tmp_path / "kfx"),
                          worker_platform="cpu") as cp:
            job = _long_job("idle")
            job.spec["runPolicy"] = {"suspend": True}
            cp.apply([job])
            workdir = cp.gangs.workdir_for("jaxjob/default/idle")
            idle = subprocess.Popen(
                [PY, "-c", "import time; from kubeflow_tpu_torch import "
                 "profiling; profiling.maybe_start_profiler_server(); "
                 "time.sleep(120)"], cwd=REPO,
                env={**os.environ, "KFX_WORKDIR": workdir,
                     "KFX_REPLICA_TYPE": "worker", "KFX_REPLICA_INDEX": "0",
                     "KFX_PROFILE": "1"})
            try:
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline and profiling.replica_port(
                        workdir, "worker-0") is None:
                    time.sleep(0.1)
                logdir = str(tmp_path / "trace")
                rc = KfxCLI(cp).profile("JAXJob", "idle", "default", "",
                                        duration_ms=200, logdir=logdir)
            finally:
                idle.kill()
                idle.wait()
            err = capsys.readouterr().err
            assert rc == 1, err
            assert "held no CPU op" in err
            assert not glob.glob(os.path.join(logdir, "plugins", "profile",
                                              "*", "*"))
