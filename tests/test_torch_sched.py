"""The port's cluster gang scheduler (kubeflow_tpu_torch/sched), ported from
tests/test_sched.py: capacity accounting, queue
ordering (priority + FIFO + fair share), backfill with its starvation
guard, preemption victim selection and storm guard, the sched.preempt
chaos point, the `kfx queue` CLI view, and the tier-1 e2e — serial
all-or-nothing gang scheduling plus preempt/checkpoint-resume; and the
reference's TestHPOCapacity itself, through ``_torch_ported``."""

import os
import re
import sys
import time

import pytest

from _torch_ported import ported
from kubeflow_tpu_torch import chaos
from kubeflow_tpu_torch.api.base import from_manifest
from kubeflow_tpu_torch.core.store import ResourceStore
from kubeflow_tpu_torch.sched import (
    PREEMPTED_ANNOTATION,
    Scheduler,
    job_priority,
    slice_capacity,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PY = sys.executable
_ref = ported("test_sched.py")


def _job(name, replicas=1, prio=0, ns="default", command=None,
         annotations=None):
    meta = {"name": name, "namespace": ns}
    if annotations:
        meta["annotations"] = annotations
    spec = {"jaxReplicaSpecs": {"Worker": {
        "replicas": replicas, "restartPolicy": "OnFailure",
        "template": {"spec": {"containers": [{
            "name": "main",
            "command": command or [PY, "-c", "import time; time.sleep(30)"],
        }]}}}}}
    if prio:
        spec["runPolicy"] = {"schedulingPolicy": {"priority": prio}}
    return from_manifest({"apiVersion": "kubeflow.org/v1", "kind": "JAXJob",
                          "metadata": meta, "spec": spec})


def _profile(name, quota):
    return from_manifest({
        "apiVersion": "kubeflow.org/v1", "kind": "Profile",
        "metadata": {"name": name},
        "spec": {"owner": {"kind": "User", "name": "a@b.c"},
                 "resourceQuotaSpec": {"hard": quota}}})


def _wait(pred, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


class TestCapacityModel:
    def test_discovery_order(self, monkeypatch):
        monkeypatch.setenv("KFX_SLICE_CHIPS", "13")
        assert slice_capacity() == 13
        monkeypatch.delenv("KFX_SLICE_CHIPS")
        monkeypatch.setenv(
            "XLA_FLAGS", "--xla_force_host_platform_device_count=6")
        assert slice_capacity() == 6
        monkeypatch.delenv("XLA_FLAGS")
        assert slice_capacity() >= 1

    def test_priority_sources(self):
        assert job_priority(_job("a")) == 0
        assert job_priority(_job("b", prio=7)) == 7
        assert job_priority(_job(
            "c", annotations={"kubeflow.org/priority": "3"})) == 3

    def test_malformed_priority_rejected_at_apply(self):
        from kubeflow_tpu_torch.api.base import ValidationError

        job = _job("bad")
        job.spec["runPolicy"] = {
            "schedulingPolicy": {"priority": "urgent-please"}}
        with pytest.raises(ValidationError, match="priority"):
            job.validate()
        # `priority: true` is a YAML typo, not priority 1.
        job.spec["runPolicy"] = {"schedulingPolicy": {"priority": True}}
        with pytest.raises(ValidationError, match="priority"):
            job.validate()
        # A bad value already in the store degrades to 0 at runtime
        # instead of crash-looping every reconcile.
        assert job.run_policy().priority == 0
        assert job_priority(job) == 0

    def test_capacity_accounting_and_event_driven_wake(self):
        store = ResourceStore()
        sched = Scheduler(store, capacity=4)
        assert sched.try_admit(_job("j1", replicas=2))[0]
        assert sched.try_admit(_job("j2", replicas=2))[0]
        wakes = []
        sched.register_waker("JAXJob", wakes.append)
        ok, reason, msg = sched.try_admit(_job("j3", replicas=1))
        assert not ok and reason == "WaitingForCapacity" and "0 free" in msg
        snap = sched.snapshot()
        assert (snap["capacity"], snap["reserved"], snap["free"]) == (4, 4, 0)
        assert [r["name"] for r in snap["queue"]] == ["j3"]
        # Freeing chips admits the queued job and wakes its controller.
        sched.release("JAXJob", "j1", "default")
        assert wakes == ["default/j3"]
        assert sched.try_admit(_job("j3", replicas=1))[0]
        assert sched.snapshot()["reserved"] == 3

    def test_all_or_nothing_never_partial(self):
        sched = Scheduler(ResourceStore(), capacity=3)
        assert sched.try_admit(_job("hold", replicas=2))[0]
        # A 2-chip gang does NOT get the 1 free chip.
        assert not sched.try_admit(_job("wide", replicas=2))[0]
        assert sched.snapshot()["reserved"] == 2

    def test_unschedulable_job_reported_and_skipped(self):
        sched = Scheduler(ResourceStore(), capacity=2)
        ok, reason, msg = sched.try_admit(_job("huge", replicas=3, prio=9))
        assert not ok and reason == "Unschedulable" and "3 chips" in msg
        # It neither blocks smaller jobs nor triggers preemption.
        assert sched.try_admit(_job("small", replicas=1))[0]


class TestQueueOrdering:
    def test_priority_then_fifo(self):
        sched = Scheduler(ResourceStore(), capacity=1)
        # hold shares b5's priority so nothing outranks the running job
        # (this test is about queue ordering, not preemption).
        assert sched.try_admit(_job("hold", prio=5))[0]
        assert not sched.try_admit(_job("a0"))[0]
        assert not sched.try_admit(_job("b5", prio=5))[0]
        assert not sched.try_admit(_job("c0"))[0]
        order = [r["name"] for r in sched.snapshot()["queue"]]
        assert order == ["b5", "a0", "c0"]
        wakes = []
        sched.register_waker("JAXJob", wakes.append)
        sched.release("JAXJob", "hold", "default")
        assert wakes == ["default/b5"]  # highest priority first
        sched.release("JAXJob", "b5", "default")
        assert wakes == ["default/b5", "default/a0"]  # then FIFO
        sched.release("JAXJob", "a0", "default")
        assert wakes[-1] == "default/c0"

    def test_fair_share_tiebreak_across_namespaces(self):
        sched = Scheduler(ResourceStore(), capacity=4)
        assert sched.try_admit(_job("a-hold", replicas=2, ns="team-a"))[0]
        assert sched.try_admit(_job("x-hold", replicas=2, ns="team-x"))[0]
        # a2 queued BEFORE b1, same priority — but team-a already holds
        # 2 chips and team-b none, so fair share hands the slot to b1.
        assert not sched.try_admit(_job("a2", replicas=2, ns="team-a"))[0]
        assert not sched.try_admit(_job("b1", replicas=2, ns="team-b"))[0]
        sched.release("JAXJob", "x-hold", "team-x")
        assert sched.try_admit(_job("b1", replicas=2, ns="team-b"))[0]
        assert not sched.try_admit(_job("a2", replicas=2, ns="team-a"))[0]

    def test_backfill_small_job_passes_blocked_head(self):
        sched = Scheduler(ResourceStore(), capacity=4)
        assert sched.try_admit(_job("hold", replicas=3))[0]
        assert not sched.try_admit(_job("wide", replicas=4))[0]
        # wide is head-of-queue but cannot fit; the 1-chip job backfills.
        assert sched.try_admit(_job("small", replicas=1))[0]
        assert [r["name"] for r in sched.snapshot()["queue"]] == ["wide"]
        # Head admits once everything frees.
        sched.release("JAXJob", "hold", "default")
        sched.release("JAXJob", "small", "default")
        assert sched.try_admit(_job("wide", replicas=4))[0]

    def test_backfill_starvation_guard(self):
        sched = Scheduler(ResourceStore(), capacity=2)
        sched.BACKFILL_STARVATION_LIMIT = 2
        sched.PREEMPTION_COOLDOWN_S = 3600
        assert sched.try_admit(_job("hold", replicas=1))[0]
        assert not sched.try_admit(_job("wide", replicas=2))[0]
        assert sched.try_admit(_job("s1", replicas=1))[0]   # passed_over=1
        sched.release("JAXJob", "s1", "default")
        assert sched.try_admit(_job("s2", replicas=1))[0]   # passed_over=2
        sched.release("JAXJob", "s2", "default")
        # Guard trips: no more backfill past the starved head.
        ok, reason, _ = sched.try_admit(_job("s3", replicas=1))
        assert not ok and reason == "WaitingForCapacity"

    def test_quota_is_enforced_by_scheduler(self):
        store = ResourceStore()
        store.create(_profile("team-q", {"count/jobs": 1}))
        sched = Scheduler(store, capacity=8)
        assert sched.try_admit(_job("q1", ns="team-q"))[0]
        ok, reason, msg = sched.try_admit(_job("q2", ns="team-q"))
        assert not ok and reason == "QuotaExceeded" and "count/jobs" in msg
        # Quota in one namespace never starves another.
        assert sched.try_admit(_job("other", ns="team-z"))[0]
        sched.release("JAXJob", "q1", "team-q")
        assert sched.try_admit(_job("q2", ns="team-q"))[0]


class TestPreemption:
    def _sched(self, store, capacity):
        sched = Scheduler(store, capacity=capacity)
        sched.PREEMPTION_COOLDOWN_S = 0.0
        return sched

    def test_victim_selection_lowest_priority_youngest_first(self):
        store = ResourceStore()
        for name, prio in (("low-a", 1), ("low-b", 1), ("mid", 2)):
            store.create(_job(name, prio=prio))
        sched = self._sched(store, capacity=3)
        for name, prio in (("low-a", 1), ("low-b", 1), ("mid", 2)):
            assert sched.try_admit(_job(name, prio=prio))[0]
        # high needs 1 chip: the equal-lowest-priority pool tie-breaks
        # youngest-first (least work lost) -> low-b, never mid.
        assert not sched.try_admit(_job("high", prio=9))[0]
        assert store.get("JAXJob", "low-b").run_policy().suspend
        assert not store.get("JAXJob", "low-a").run_policy().suspend
        assert not store.get("JAXJob", "mid").run_policy().suspend
        assert store.get("JAXJob", "low-b").metadata.annotations[
            PREEMPTED_ANNOTATION] == "jaxjob/default/high"

    def test_suspend_frees_chips_and_victim_requeues_for_resume(self):
        store = ResourceStore()
        store.create(_job("low", prio=1))
        sched = self._sched(store, capacity=1)
        assert sched.try_admit(_job("low", prio=1))[0]
        wakes = []
        sched.register_waker("JAXJob", wakes.append)
        assert not sched.try_admit(_job("high", prio=9))[0]
        low = store.get("JAXJob", "low")
        assert low.run_policy().suspend
        # The training operator reports the gang teardown; the chips
        # free and the preemptor is woken.
        assert sched.on_suspended(low) is True   # stays queued for resume
        assert wakes == ["default/high"]
        assert sched.try_admit(_job("high", prio=9))[0]
        # Preemptor finishes -> the victim auto-resumes: suspend cleared
        # in the store, annotation gone, chips reserved again.
        sched.release("JAXJob", "high", "default")
        low = store.get("JAXJob", "low")
        assert not low.run_policy().suspend
        assert PREEMPTED_ANNOTATION not in low.metadata.annotations
        assert sched.snapshot()["reserved"] == 1
        assert wakes[-1] == "default/low"

    def test_user_suspend_leaves_scheduler(self):
        store = ResourceStore()
        sched = self._sched(store, capacity=1)
        job = _job("mine")
        store.create(job)
        assert sched.try_admit(job)[0]
        # User sets suspend (no preempted annotation): entry dropped.
        assert sched.on_suspended(job) is False
        assert sched.snapshot()["reserved"] == 0

    def test_storm_guard_cooldown_and_victim_cap(self):
        store = ResourceStore()
        names = [f"low{i}" for i in range(4)]
        for n in names:
            store.create(_job(n, prio=1))
        sched = Scheduler(store, capacity=4)
        sched.PREEMPTION_COOLDOWN_S = 3600.0  # one cycle only
        for n in names:
            assert sched.try_admit(_job(n, prio=1))[0]
        assert not sched.try_admit(_job("high", replicas=4, prio=9))[0]
        suspended = [n for n in names
                     if store.get("JAXJob", n).run_policy().suspend]
        # MAX_VICTIMS_PER_CYCLE caps the cycle; the cooldown paces the
        # next one (which never comes inside this test's window).
        assert len(suspended) == sched.MAX_VICTIMS_PER_CYCLE == 2
        assert not sched.try_admit(_job("high", replicas=4, prio=9))[0]
        assert len([n for n in names
                    if store.get("JAXJob", n).run_policy().suspend]) == 2
        # Cooldown elapsed: the remaining victims go in the next cycle.
        sched._last_preempt = float("-inf")
        assert not sched.try_admit(_job("high", replicas=4, prio=9))[0]
        assert len([n for n in names
                    if store.get("JAXJob", n).run_policy().suspend]) == 4

    def test_no_pointless_preemption(self):
        store = ResourceStore()
        store.create(_job("low", prio=1))
        sched = self._sched(store, capacity=2)
        assert sched.try_admit(_job("low", prio=1))[0]
        assert sched.try_admit(_job("peer", prio=9))[0]
        # high needs 2 chips; evicting every lower-priority job frees
        # only 1 -> nobody is killed for an unfillable request.
        assert not sched.try_admit(_job("high", replicas=2, prio=9))[0]
        assert not store.get("JAXJob", "low").run_policy().suspend

    def test_sched_preempt_chaos_point_aborts_cycle(self):
        store = ResourceStore()
        store.create(_job("low", prio=1))
        sched = self._sched(store, capacity=1)
        assert sched.try_admit(_job("low", prio=1))[0]
        chaos.reset()
        chaos.install(chaos.parse_spec("sched.preempt:count=1"))
        try:
            assert not sched.try_admit(_job("high", prio=9))[0]
            # Injection aborted the cycle: the victim survived.
            assert not store.get("JAXJob", "low").run_policy().suspend
            assert chaos.injected_counts().get("sched.preempt") == 1
            # Budget exhausted (count=1): the next cycle lands.
            sched._last_preempt = 0.0
            assert not sched.try_admit(_job("high", prio=9))[0]
            assert store.get("JAXJob", "low").run_policy().suspend
            assert chaos.injected_counts().get("sched.preempt") == 1
        finally:
            chaos.reset()


def test_render_beside_an_admission_does_not_deadlock():
    """The plane's scraper renders the registry, whose collector takes
    the scheduler's lock (``Scheduler.collect``), while an admission holds
    that lock and records into the registry (``_admit_locked``). A render
    that held the instruments' lock across its collectors deadlocked the
    two (seen on the card: every gang supervisor stalled behind a
    reconcile thread). Here an admission holds the scheduler's lock while
    a render waits on it, then records: both finish."""
    import threading

    from kubeflow_tpu_torch.obs.metrics import MetricsRegistry

    reg = MetricsRegistry()
    sched = Scheduler(ResourceStore(), capacity=2, metrics=reg)
    reg.add_collector(sched.collect)
    holding, release = threading.Event(), threading.Event()

    def admission():
        with sched._lock:
            holding.set()
            release.wait(10)
            reg.counter("kfx_sched_admitted_total").inc(1, namespace="a")

    a = threading.Thread(target=admission, daemon=True)
    a.start()
    assert holding.wait(10)
    out = []
    r = threading.Thread(target=lambda: out.append(reg.render()),
                         daemon=True)
    r.start()
    time.sleep(0.2)   # the render is in sched.collect, on the lock
    release.set()
    a.join(10)
    r.join(10)
    assert not a.is_alive() and not r.is_alive(), "render deadlocked"
    assert "kfx_sched_capacity_chips 2" in out[0]


class TestSchedulerInPlane:
    """Tier-1 e2e through the full control plane."""

    def test_serial_all_or_nothing_and_queue_cli(self, tmp_path,
                                                 monkeypatch, capsys):
        from kubeflow_tpu_torch.api import training as T
        from kubeflow_tpu_torch.cli import KfxCLI
        from kubeflow_tpu_torch.controlplane import ControlPlane

        monkeypatch.setenv("KFX_SLICE_CHIPS", "2")
        with ControlPlane(home=str(tmp_path / "home"),
                          worker_platform="cpu") as cp:
            assert cp.sched.capacity == 2
            sleeper = [PY, "-c", "import time; time.sleep(1.2)"]
            cp.apply([_job("first", replicas=2, command=sleeper),
                      _job("second", replicas=2, command=sleeper)])
            _wait(lambda: cp.store.get("JAXJob", "first")
                  .has_condition(T.JOB_RUNNING), what="first running")
            # Single-job capacity: the second gang is queued with ZERO
            # processes spawned — never half-started.
            _wait(lambda: cp.store.get("JAXJob", "second")
                  .has_condition(T.JOB_QUEUED), what="second queued")
            assert cp.gangs.get("jaxjob/default/second") is None
            # `kfx queue` renders capacity + the wait queue.
            assert KfxCLI(cp).queue() == 0
            out = capsys.readouterr().out
            assert "slice: capacity=2 chips  reserved=2  free=0  queued=1" \
                in out
            assert re.search(r"second\s+JAXJob\s+default\s+0\s+2\s+Queued",
                             out), out
            # Oldest-first: both finish, serially.
            f1 = cp.wait_for_job("JAXJob", "first", timeout=60)
            f2 = cp.wait_for_job("JAXJob", "second", timeout=60)
            assert f1.has_condition(T.JOB_SUCCEEDED)
            assert f2.has_condition(T.JOB_SUCCEEDED)
            assert f1.status["startTime"] <= f2.status["startTime"]
            # The queue wait landed in the histogram.
            assert cp.metrics.render().count("kfx_sched_queue_seconds") > 1

    def test_preempt_checkpoint_resume_e2e(self, tmp_path, monkeypatch):
        """The acceptance story: a priority-9 job preempts a priority-1
        job mid-training; the victim suspends (checkpoints already on
        disk), the preemptor runs, the victim resumes from its latest
        step and completes, all with the port's runner on the CPU. The
        kfx_sched_* families are live on the plane's registry and the
        sched.admit span sits between reconcile and gang.spawn in the
        plane's span log. /metrics through the port's ApiServer passes
        scrape_metrics.py with the kfx_sched_* families --require'd, as
        in the reference. The reference marks its copy slow (~99 s
        there); the port's runner takes ~25 s, so this one runs in
        tier-1."""
        import json

        from kubeflow_tpu_torch.api import training as T
        from kubeflow_tpu_torch.apiserver import ApiServer
        from kubeflow_tpu_torch.controlplane import ControlPlane
        from kubeflow_tpu_torch.obs.trace import SPANS_DIRNAME, trace_of

        sys.path.insert(0, os.path.join(REPO_ROOT, "scripts"))
        import scrape_metrics

        monkeypatch.setenv("KFX_SLICE_CHIPS", "1")
        # One intra-op thread for the runner (the gang env inherits it).
        monkeypatch.setenv("OMP_NUM_THREADS", "1")
        home = str(tmp_path / "home")
        low_cmd = [PY, "-m", "kubeflow_tpu_torch.runners.jax_runner",
                   "--model=mlp", "--dataset=mnist", "--steps=800",
                   "--batch-size=64", "--log-every=100",
                   "--checkpoint-every=100", "--keep-checkpoints=2"]
        hi_cmd = [PY, "-c", "import time; time.sleep(1.0); print('hi')"]
        with ControlPlane(home=home, worker_platform="cpu") as cp:
            low = _job("low", prio=1, command=low_cmd)
            low.spec["jaxReplicaSpecs"]["Worker"]["template"]["spec"][
                "containers"][0]["env"] = [
                    {"name": "PYTHONPATH", "value": REPO_ROOT}]
            cp.apply([low])

            def _log():
                try:
                    return cp.job_logs("JAXJob", "low")
                except (FileNotFoundError, KeyError):
                    return ""

            # Wait until at least two checkpoints are durable, then
            # preempt.
            _wait(lambda: "step=200" in _log(), timeout=180,
                  what="low past step 200")
            cp.apply([_job("high", prio=9, command=hi_cmd)])
            fh = cp.wait_for_job("JAXJob", "high", timeout=120)
            assert fh.has_condition(T.JOB_SUCCEEDED)
            # The victim was preempted, then auto-resumed from its
            # latest checkpoint — never from step 0.
            fl = cp.wait_for_job("JAXJob", "low", timeout=240)
            log = cp.job_logs("JAXJob", "low")
            assert fl.has_condition(T.JOB_SUCCEEDED), log[-2000:]
            reasons = [e.reason for e in
                       cp.store.events_for("JAXJob", "default/low")]
            assert "Preempted" in reasons and "SchedulerResumed" in reasons
            resumes = re.findall(r"resumed_from_checkpoint step=(\d+)", log)
            assert resumes and int(resumes[-1]) >= 100, log[-2000:]
            assert "train_done steps=800" in log

            text = cp.metrics.render()
            assert 'kfx_sched_preempted_total{namespace="default"} 1' \
                in text
            for family in ("kfx_sched_queue_seconds",
                           "kfx_sched_admitted_total",
                           "kfx_sched_capacity_chips"):
                assert f"# TYPE {family} " in text, family
            with ApiServer(cp, port=0) as srv:
                assert scrape_metrics.main(
                    [f"{srv.url}/metrics",
                     "--require", "kfx_sched_queue_seconds",
                     "--require", "kfx_sched_admitted_total",
                     "--require", "kfx_sched_preempted_total",
                     "--require", "kfx_sched_capacity_chips"]) == 0

            # Trace: high's admission -> reconcile -> sched.admit (+
            # gang.spawn under the same reconcile chain).
            trace_id = trace_of(cp.store.get("JAXJob", "high"))
            spans = []
            span_dir = os.path.join(home, SPANS_DIRNAME)
            for name in os.listdir(span_dir):
                with open(os.path.join(span_dir, name)) as f:
                    spans += [json.loads(ln) for ln in f if ln.strip()]
            spans = [sp for sp in spans if sp["trace"] == trace_id]
            by_id = {sp["span"]: sp for sp in spans}
            admits = [sp for sp in spans if sp["name"] == "sched.admit"]
            assert admits, {sp["name"] for sp in spans}
            [admission] = [sp for sp in spans if sp["name"] == "admission"]
            for sp in admits:
                parent = by_id[sp["parent"]]
                assert parent["name"] == "reconcile"
                assert parent["parent"] == admission["span"]
            assert any(sp["name"] == "gang.spawn" for sp in spans)


class TestParallelismGang:
    """A pipeline+tensor JAXJob declared via spec.parallelism is admitted
    through the scheduler as ONE gang reserving its full chip footprint
    (a 2x2x2 job takes all 8 chips of the slice), and the operator
    delivers the plan to the worker. The port's divergence: the one
    Worker replica runs as 8 ranks of that gang (KFX_NUM_PROCESSES=8),
    pinned to the plane's device, and reads as one replica in status."""

    def test_tensor_pipeline_job_reserves_full_footprint(
            self, tmp_path, monkeypatch):
        from kubeflow_tpu_torch.api import training as T
        from kubeflow_tpu_torch.api.base import from_manifest
        from kubeflow_tpu_torch.controlplane import ControlPlane

        monkeypatch.setenv("KFX_SLICE_CHIPS", "8")
        monkeypatch.delenv("KFX_WORKER_PLATFORM", raising=False)
        worker = [PY, "-c", (
            "import json, os, time\n"
            "p = json.loads(os.environ['KFX_PARALLELISM'])\n"
            "assert p == {'tensor': 2, 'pipeline': 2, 'data': 2}, p\n"
            "assert os.environ['KFX_NUM_PROCESSES'] == '8'\n"
            "assert os.environ['KFX_REPLICA_INDEX'] == '0'\n"
            "assert os.environ.get('KFX_DEVICE') == 'cuda'\n"
            "time.sleep(1.2)\n"
            "print('parallelism_env_ok rank=' + os.environ['KFX_PROCESS_ID'],"
            " flush=True)\n")]
        tp_job = from_manifest({
            "apiVersion": "kubeflow.org/v1", "kind": "JAXJob",
            "metadata": {"name": "tp-pp", "namespace": "default"},
            "spec": {
                "parallelism": {"tensor": 2, "pipeline": 2, "data": 2},
                "jaxReplicaSpecs": {"Worker": {
                    "replicas": 1, "restartPolicy": "Never",
                    "template": {"spec": {"containers": [
                        {"name": "main", "command": worker}]}}}}}})
        with ControlPlane(home=str(tmp_path / "home"),
                          worker_platform=None) as cp:
            assert cp.sched.capacity == 8
            cp.apply([tp_job, _job("tail", replicas=1, command=[
                PY, "-c", "print('tail done')"])])
            _wait(lambda: cp.store.get("JAXJob", "tp-pp")
                  .has_condition(T.JOB_RUNNING), what="tp-pp running")
            # The 2x2x2 footprint holds ALL 8 chips as one gang: the
            # 1-chip tail job queues behind it.
            row = [r for r in cp.sched.snapshot()["running"]
                   if r["name"] == "tp-pp"]
            assert row and row[0]["chips"] == 8, row
            assert len(cp.gangs.get("jaxjob/default/tp-pp").specs) == 8
            _wait(lambda: cp.store.get("JAXJob", "tail")
                  .has_condition(T.JOB_QUEUED), what="tail queued")
            f1 = cp.wait_for_job("JAXJob", "tp-pp", timeout=60)
            assert f1.has_condition(T.JOB_SUCCEEDED), f1.conditions
            assert f1.status["replicaStatuses"] == {
                "worker": {"active": 0, "succeeded": 1, "failed": 0}}
            assert "parallelism_env_ok rank=0" in cp.job_logs("JAXJob",
                                                              "tp-pp")
            for m in range(1, 8):
                assert f"parallelism_env_ok rank={m}" in cp.job_logs(
                    "JAXJob", "tp-pp", replica=f"worker-0.{m}")
            f2 = cp.wait_for_job("JAXJob", "tail", timeout=60)
            assert f2.has_condition(T.JOB_SUCCEEDED)
            assert f1.status["startTime"] <= f2.status["startTime"]


class TestHPOCapacity(_ref.TestHPOCapacity):
    """The reference's case through ``_torch_ported``: an Experiment's
    trials queue on a full slice instead of failing."""
