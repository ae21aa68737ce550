"""The control plane's chaos points in the port (kubeflow_tpu_torch), ported
from tests/test_chaos.py: store faults (store.read/store.write), workqueue
requeue storms, gang spawn failure and supervisor member kill, and the
plane's chaos listener (events + kfx_chaos_injected_total), the
apiserver's 503 with Retry-After on a storage fault, plus the seeded smoke
of a JAXJob whose runner crashes on a corrupted latest checkpoint."""

import json
import os
import sys
import time
import urllib.error
import urllib.request

import pytest

from kubeflow_tpu_torch import chaos

PY = sys.executable
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_chaos():
    chaos.reset()
    yield
    chaos.reset()


class TestStoreFaults:
    def test_read_fault_raises_store_fault(self):
        from kubeflow_tpu_torch.core.store import ResourceStore, StoreFault

        chaos.install(chaos.parse_spec("store.read:count=1"))
        store = ResourceStore()
        with pytest.raises(StoreFault):
            store.get("JAXJob", "x")
        # Budget spent: the store is healthy again (NotFound, not fault).
        with pytest.raises(KeyError):
            store.get("JAXJob", "x")

    def test_write_fault_raises_store_fault(self):
        """store.write fires on create, update and delete (the reference's
        :183/:201/:251 points) before the store changes."""
        from kubeflow_tpu_torch.api.base import from_manifest
        from kubeflow_tpu_torch.core.store import ResourceStore, StoreFault

        job = from_manifest({
            "apiVersion": "kubeflow.org/v1", "kind": "JAXJob",
            "metadata": {"name": "w"}, "spec": {"jaxReplicaSpecs": {
                "Worker": {"replicas": 1, "template": {"spec": {
                    "containers": [{"name": "m", "command": ["true"]}]}}}}}})
        store = ResourceStore()
        chaos.install(chaos.parse_spec("store.write:count=1"))
        with pytest.raises(StoreFault):
            store.create(job)
        assert store.list_all() == []
        stored = store.create(job)
        chaos.install(chaos.parse_spec("store.write:count=2"))
        stored.metadata.labels["x"] = "y"
        with pytest.raises(StoreFault):
            store.update(stored)
        with pytest.raises(StoreFault):
            store.delete("JAXJob", "w")
        assert store.get("JAXJob", "w").metadata.labels == {}
        assert chaos.injected_counts() == {"store.write": 3}

    def test_apiserver_answers_503_with_retry_after(self, tmp_path):
        from kubeflow_tpu_torch.apiserver import ApiServer
        from kubeflow_tpu_torch.controlplane import ControlPlane

        plane = ControlPlane(home=str(tmp_path / "home"))
        server = ApiServer(plane, port=0)
        server.start()
        try:
            chaos.install(chaos.parse_spec("store.read:count=1"))
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(
                    f"{server.url}/apis/jaxjob", timeout=10)
            assert e.value.code == 503
            assert e.value.headers.get("Retry-After") == "1"
            body = json.loads(e.value.read())
            assert "storage temporarily unavailable" in body["error"]
            # The retry the header promised actually works.
            with urllib.request.urlopen(
                    f"{server.url}/apis/jaxjob", timeout=10) as r:
                assert r.status == 200
        finally:
            server.stop()
            plane.stop()

    def test_store_fault_lands_in_events_and_metrics(self, tmp_path):
        from kubeflow_tpu_torch.controlplane import ControlPlane
        from kubeflow_tpu_torch.core.store import StoreFault
        from kubeflow_tpu_torch.obs import trace as obs_trace

        plane = ControlPlane(home=str(tmp_path / "home"))
        try:
            chaos.install(chaos.parse_spec("store.read:count=1"))
            # Inject inside an open span: the recorded Chaos event must
            # carry BOTH the trace and that span's ID, so the injection
            # lands at the right node of the `kfx trace` waterfall.
            with pytest.raises(StoreFault):
                with obs_trace.span("unit.op", trace_id="aced0123") as sp:
                    plane.store.get("JAXJob", "x")
            evs = plane.store.events_for("Chaos", "store.read")
            assert evs and evs[0].reason == "ChaosInjected"
            assert evs[0].trace_id == "aced0123"
            assert evs[0].span_id == sp.span_id
            assert evs[0].to_dict()["spanId"] == sp.span_id
            text = plane.metrics.render()
            assert 'kfx_chaos_injected_total{point="store.read"} 1' in text
        finally:
            plane.stop()


class TestControllerResilience:
    def test_worker_threads_survive_store_faults(self, tmp_path):
        """A store fault during reconcile (or the pre-reconcile trace
        lookup) must cost a rate-limited requeue, never the worker
        thread — a dead worker strands its key in `processing` and
        silently stops reconciliation for that kind forever."""
        from kubeflow_tpu_torch.controlplane import ControlPlane

        with ControlPlane(home=str(tmp_path / "home")) as cp:
            ctrl = cp.manager.controllers["JAXJob"]
            chaos.install(chaos.parse_spec("store.read:count=8"))
            ctrl.queue.add("default/ghost")
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                s = ctrl.queue.stats()
                if chaos.injected_counts().get("store.read", 0) >= 8 \
                        and s["processing"] == 0 and len(ctrl.queue) == 0:
                    break
                time.sleep(0.05)
            chaos.install(None)
            s = ctrl.queue.stats()
            assert s["processing"] == 0, s  # key not stranded
            # The worker is still alive: a healthy key gets processed.
            ctrl.queue.add("default/ghost2")
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                s = ctrl.queue.stats()
                if s["depth"] == 0 and s["processing"] == 0 and \
                        len(ctrl.queue) == 0:
                    break
                time.sleep(0.05)
            assert s["processing"] == 0 and s["depth"] == 0, s


class TestWorkqueueStorm:
    def test_requeue_storm_is_deduplicated(self):
        from kubeflow_tpu_torch.core.workqueue import RateLimitingQueue

        chaos.install(chaos.parse_spec("workqueue.requeue:count=20"))
        q = RateLimitingQueue()
        # Every add also storms (p=1) until the 20-injection budget is
        # spent: 20 spurious extra deliveries of the same key.
        for _ in range(25):
            q.add("ns/a")
        assert q.counters()["requeues"] >= 20
        # De-dup must absorb the storm: bounded deliveries, then empty.
        seen = 0
        while True:
            key = q.get(timeout=0.2)
            if key is None:
                break
            assert key == "ns/a"
            seen += 1
            q.done(key)
        assert 1 <= seen <= 21  # never amplified past one per delivery
        assert len(q) == 0
        assert q.stats()["depth"] == 0


class TestGangChaos:
    def test_spawn_fault_is_all_or_nothing(self, tmp_path):
        from kubeflow_tpu_torch.runtime import gang as G

        chaos.install(chaos.parse_spec("gang.spawn:count=1,match=worker-1"))
        g = G.Gang(
            "spawnfail",
            [G.ProcessSpec("Worker", i, [PY, "-c", "pass"])
             for i in range(2)],
            str(tmp_path), restart_policy="Never")
        g.start()
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            if g.status().phase == G.FAILED:
                break
            time.sleep(0.05)
        st = g.status()
        g.delete()
        assert st.phase == G.FAILED
        assert st.reason == "SpawnFailed"
        # worker-0 spawned first, then worker-1's injected spawn failure
        # must have torn it down: no member may survive a half-start.
        assert all(r.state == G.FAILED for r in st.replicas.values())

    def test_injected_kill_restarts_whole_gang(self, tmp_path):
        from kubeflow_tpu_torch.runtime import gang as G

        chaos.install(chaos.parse_spec("gang.kill:count=1,delay=0.2"))
        g = G.Gang(
            "killme",
            [G.ProcessSpec("Worker", i,
                           [PY, "-c", "import time; time.sleep(1.0)"])
             for i in range(2)],
            str(tmp_path), restart_policy="OnFailure", backoff_limit=3)
        g.start()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if g.status().phase in (G.SUCCEEDED, G.FAILED):
                break
            time.sleep(0.05)
        st = g.status()
        g.delete()
        assert st.phase == G.SUCCEEDED, (st.phase, st.reason, st.message)
        assert st.restart_count == 1
        assert chaos.injected_counts().get("gang.kill") == 1


class TestChaosSmoke:
    """The fast seeded smoke (tier-1): one injected worker crash ON a
    corrupted latest checkpoint; the gang restart must resume from the
    older retained step and still finish the job."""

    def test_jaxjob_survives_crash_on_corrupt_checkpoint(self, tmp_path,
                                                         monkeypatch):
        # One intra-op thread for the runner (the gang env inherits it):
        # torch takes every core otherwise, which oversubscribes xdist.
        monkeypatch.setenv("OMP_NUM_THREADS", "1")
        from kubeflow_tpu_torch.api import training as T
        from kubeflow_tpu_torch.api.base import from_manifest
        from kubeflow_tpu_torch.controlplane import ControlPlane

        state = str(tmp_path / "chaos.json")
        spec = (f"seed=7;state={state};"
                "runner.crash:after=1,count=1;"
                "checkpoint.save:mode=corrupt,after=1,count=1")
        job = from_manifest({
            "apiVersion": "kubeflow.org/v1", "kind": "JAXJob",
            "metadata": {"name": "smoke", "namespace": "default"},
            "spec": {"jaxReplicaSpecs": {"Worker": {
                "replicas": 1, "restartPolicy": "OnFailure",
                "template": {"spec": {"containers": [{
                    "name": "main",
                    "command": [PY, "-m",
                                "kubeflow_tpu_torch.runners.jax_runner",
                                "--model=mlp", "--dataset=mnist",
                                "--steps=40", "--batch-size=64",
                                "--log-every=10", "--checkpoint-every=10",
                                "--keep-checkpoints=2"],
                    "env": [{"name": "KFX_CHAOS", "value": spec},
                            {"name": "PYTHONPATH", "value": REPO_ROOT}],
                }]}},
            }}, "runPolicy": {"backoffLimit": 3}}})
        with ControlPlane(home=str(tmp_path / "home"),
                          worker_platform="cpu") as cp:
            cp.apply([job])
            final = cp.wait_for_job("JAXJob", "smoke", timeout=180)
            log = cp.job_logs("JAXJob", "smoke")
        assert final.has_condition(T.JOB_SUCCEEDED), log[-2000:]
        assert final.status["restartCount"] == 1
        # The deterministic story: save 20 corrupted, crash at 20,
        # restart quarantines it and resumes from 10 — never step 0.
        assert "chaos_corrupt_checkpoint step=20" in log
        assert "chaos_crash step=20" in log
        assert "checkpoint_quarantined step=20" in log
        assert "resumed_from_checkpoint step=10" in log
        assert "train_done steps=40" in log

    def test_gang_kill_visible_in_plane_metrics_and_events(self, tmp_path):
        """Operator-side injection: a supervisor-killed member restarts
        the gang, and the injection is readable on the plane's /metrics
        and event log — a chaos run reads like any other job."""
        from kubeflow_tpu_torch.api import training as T
        from kubeflow_tpu_torch.api.base import from_manifest
        from kubeflow_tpu_torch.controlplane import ControlPlane

        chaos.install(chaos.parse_spec("gang.kill:count=1,delay=0.2"))
        job = from_manifest({
            "apiVersion": "kubeflow.org/v1", "kind": "JAXJob",
            "metadata": {"name": "killed", "namespace": "default"},
            "spec": {"jaxReplicaSpecs": {"Worker": {
                "replicas": 1, "restartPolicy": "OnFailure",
                "template": {"spec": {"containers": [{
                    "name": "main",
                    "command": [PY, "-c", "import time; time.sleep(1.0)"],
                }]}},
            }}, "runPolicy": {"backoffLimit": 3}}})
        with ControlPlane(home=str(tmp_path / "home"),
                          worker_platform="cpu") as cp:
            cp.apply([job])
            final = cp.wait_for_job("JAXJob", "killed", timeout=60)
            text = cp.metrics.render()
            evs = cp.store.events_for("Chaos", "gang.kill")
        assert final.has_condition(T.JOB_SUCCEEDED)
        assert final.status["restartCount"] == 1
        assert 'kfx_chaos_injected_total{point="gang.kill"} 1' in text
        assert evs and evs[0].reason == "ChaosInjected"
