"""ControlPlane: the assembled platform — store + manager + operators; the
port's copy of ``kubeflow_tpu/controlplane.py``.

The reference equivalent is `kfctl apply` bringing up every controller
deployment on a cluster (SURVEY.md §3 CS5). Here the platform is a single
process hosting the reconcile loops, with gangs as local child processes.
The CLI (`kfx`) and the tests both embed one of these.

The port's plane holds the store, the manager, the gangs, the gang
scheduler, the four training controllers, the HPO controllers (with the
observation store behind the db-manager), the serving, pipeline,
Notebook, Profile and SLO controllers, ``PlatformAdmission`` in every
workload controller, the telemetry store with its central scraper and
the rule and SLO engines it drives, the metrics registry, the span sink
and the chaos listener: the reference's plane. ``apiserver.py`` serves it
over HTTP (`kfx server`); a KfDef never reaches it, since the CLI expands
one client-side (``kfctl.py``), as in the reference.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Tuple

from .api.base import Resource
from .api.manifest import load_manifest_file, load_manifests
from .api.training import TrainingJob
from .core.controller import Manager
from .core.store import ResourceStore
from .obs import trace as obs_trace
from .obs.metrics import MetricsRegistry
from .operators import training_controllers
from .runtime.gang import GangManager


def default_home() -> str:
    return os.environ.get("KFX_HOME") or os.path.join(
        os.path.expanduser("~"), ".kfx")


def resolve_home(home: Optional[str] = None) -> str:
    """Single normalization for a home path. Every participant in the
    single-owner protocol (flock, server marker, X-Kfx-Home comparison)
    must resolve identically or the guard silently splits."""
    return os.path.abspath(home or default_home())


class HomeBusy(RuntimeError):
    """Another live process owns this home's reconcile loops."""


class ControlPlane:
    """Hosts the store and every registered controller.

    ``journal=True`` persists resources to sqlite under the home dir so a
    restarted control plane resumes reconciliation (store recovery replays
    objects; unfinished jobs get fresh gangs — the reference gets the same
    from informer re-list on controller restart).
    """

    def __init__(self, home: Optional[str] = None, journal: bool = False,
                 worker_platform: Optional[str] = None,
                 passive: bool = False):
        # passive: load state but never start reconcile loops. Read-only
        # CLI verbs (get/logs/events/profile) use this so a second kfx
        # process on the same home cannot adopt Running jobs and spawn
        # duplicate gangs next to the process that owns them.
        self.passive = passive
        self.home = resolve_home(home)
        os.makedirs(self.home, exist_ok=True)
        # Exactly one process may run reconcile loops over a home: two
        # control planes on one sqlite would each adopt Running jobs and
        # spawn duplicate gangs. The kernel releases the flock on any
        # death, so a SIGKILLed owner never leaves a stale claim. Passive
        # (read-only) planes skip it.
        self._lock = None
        if not passive:
            import fcntl

            lock = open(os.path.join(self.home, "server.lock"), "w")
            try:
                fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                lock.close()
                raise HomeBusy(
                    f"{self.home} is owned by another live kfx process")
            self._lock = lock
        journal_path = os.path.join(self.home, "state.db") if journal else None
        self.store = ResourceStore(journal_path=journal_path)
        self.gangs = GangManager(os.path.join(self.home, "gangs"))
        self.manager = Manager(self.store)
        # This process's span log (obs.trace): admission + reconcile +
        # gang-spawn spans land in <home>/spans/plane-<pid>.jsonl, where
        # `kfx trace <job>` merges them with the replicas' logs.
        obs_trace.set_span_sink(
            os.path.join(self.home, obs_trace.SPANS_DIRNAME), "plane")
        # One registry per plane: reconcile histograms recorded live by
        # the controllers, plus pull-time collectors for state that
        # lives elsewhere (store counts, workqueue depths). Both
        # /metrics formats render from this single snapshot path.
        self.metrics = MetricsRegistry()
        self.metrics.add_collector(self._collect_platform_metrics)
        # Training-loop families (kfx_train_mfu, kfx_train_step_seconds,
        # kfx_train_examples_per_second) are recorded live into the
        # process-wide default registry by TrainLoop/LMTrainLoop; bridge
        # them so an in-process training run (benches, notebooks, tests)
        # is scrape-able off this plane's /metrics.
        from .obs.metrics import default_registry

        self.metrics.add_external(default_registry(), prefix="kfx_train_")
        # kfx_spans_recorded_total{component}: /metrics proof that span
        # tracing is flowing in this process.
        self.metrics.add_collector(obs_trace.collect)
        # Chaos observability: injections export on this plane's
        # /metrics (kfx_chaos_injected_total) and land in the event log
        # stamped with the active trace ID, so a chaos run reads like
        # any other job in `kfx events`.
        from . import chaos

        self.metrics.add_collector(chaos.collect)
        self._chaos_listener = self._record_chaos_event
        chaos.add_listener(self._chaos_listener)
        # The cluster gang scheduler (sched/): the single admission point
        # between the workload controllers and gang.spawn. Capacity is
        # discovered from the gang runtime; queue/preemption metrics land
        # in this plane's registry.
        from .sched import Scheduler

        self.sched = Scheduler(self.store,
                               capacity=self.gangs.slice_capacity(),
                               metrics=self.metrics)
        self.metrics.add_collector(self.sched.collect)
        # Telemetry plane (obs/tsdb.py + obs/rules.py): the bounded
        # time-series store every history consumer reads (autoscaler
        # SLO windows, operator status sampling, `kfx top --watch`,
        # /query, the alert rules), fed by ONE central scraper that
        # polls this registry plus every live serving replica's
        # /metrics on KFX_OBS_INTERVAL seconds. Alert transitions land
        # as kind=Alert store events.
        from .obs.rules import RuleEngine, load_rules
        from .obs.slo import SLOEngine
        from .obs.tsdb import TSDB, CentralScraper

        self.telemetry = TSDB()
        self.alerts = RuleEngine(self.telemetry, load_rules(),
                                 metrics=self.metrics,
                                 on_transition=self._record_alert_event)
        # SLO plane (obs/slo.py): per-cycle budget/burn evaluation runs
        # INSIDE the scrape cycle, after ingest and before the rule
        # pass, so the generated burn alerts judge this cycle's numbers.
        self.slos = SLOEngine(self.telemetry, self.metrics, self.store,
                              self.alerts)
        self.scraper = CentralScraper(
            self.telemetry, self.metrics,
            interval_s=float(os.environ.get("KFX_OBS_INTERVAL", "1.0")),
            targets=self._scrape_targets, rules=self.alerts,
            slo=self.slos)
        self._register_controllers(worker_platform)
        for ctrl in self.manager.controllers.values():
            ctrl.metrics = self.metrics
        self._started = False

    def _register_controllers(self, worker_platform: Optional[str]) -> None:
        for ctrl in training_controllers(self.store, self.gangs,
                                         worker_platform):
            self.manager.register(ctrl)
        from .hpo.collector import ObservationStore
        from .hpo.dbmanager import ObservationClient, make_db_server
        from .operators.hpo import hpo_controllers

        # Observations cross the db-manager gRPC boundary (Katib parity,
        # SURVEY.md §3 CS2 step 4): the sqlite store sits behind a real
        # gRPC service; the controllers hold only the client, so every
        # report/read goes over the wire even in the embedded plane.
        self._obs_store = ObservationStore(
            os.path.join(self.home, "observations.db"))
        self._obs_server = make_db_server(self._obs_store).start()
        self.observations = ObservationClient(
            f"127.0.0.1:{self._obs_server.port}")
        for ctrl in hpo_controllers(self.store, self.gangs,
                                    self.observations):
            self.manager.register(ctrl)
        from .operators.serving import serving_controllers

        for ctrl in serving_controllers(self.store, self.home,
                                        worker_platform):
            self.manager.register(ctrl)
        from .operators.pipelines import pipeline_controllers

        for ctrl in pipeline_controllers(self.store, self.home):
            self.manager.register(ctrl)
        from .operators.platform import (
            PlatformAdmission,
            platform_controllers,
        )

        for ctrl in platform_controllers(self.store, self.gangs):
            self.manager.register(ctrl)
        from .operators.slo import SLOController

        self.manager.register(SLOController(self.store, self.slos))
        # Wire quota + PodDefault admission into every workload controller.
        admission = PlatformAdmission(self.store, self.gangs)
        for ctrl in self.manager.controllers.values():
            if hasattr(ctrl, "admission"):
                ctrl.admission = admission
        # Route every training-job kind (incl. HPO trial gangs, which
        # are training jobs) through the gang scheduler, and let it wake
        # queued keys event-driven when capacity frees.
        for ctrl in self.manager.controllers.values():
            if hasattr(ctrl, "scheduler"):
                ctrl.scheduler = self.sched
                self.sched.register_waker(ctrl.KIND, ctrl.queue.add)
        # Controllers that consume metric HISTORY (the serving
        # operator's status sampling + rollout SLO windows) read the
        # central telemetry store — no controller polls /metrics
        # endpoints itself.
        for ctrl in self.manager.controllers.values():
            if hasattr(ctrl, "telemetry"):
                ctrl.telemetry = self.telemetry

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "ControlPlane":
        if not self.passive:
            self.manager.start()
            # The scraper only runs where the reconcile loops do: a
            # passive (read-only) plane must not duplicate the owner's
            # scrape traffic or evaluate alerts twice.
            self.scraper.start()
            self._started = True
        return self

    def stop(self) -> None:
        from . import chaos

        chaos.remove_listener(self._chaos_listener)
        if self._started:
            self.scraper.stop()
            self.manager.stop()
            self._started = False
        for ctrl in self.manager.controllers.values():
            shutdown = getattr(ctrl, "shutdown", None)
            if callable(shutdown):
                shutdown()
        self.gangs.shutdown()
        self.observations.close()   # client channel
        self._obs_server.stop()     # gRPC boundary
        self._obs_store.close()     # sqlite behind it
        self.store.close()
        if self._lock is not None:
            self._lock.close()
            self._lock = None

    def __enter__(self) -> "ControlPlane":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- observability -------------------------------------------------------
    def _scrape_targets(self):
        """Replica /metrics endpoints for the central scraper,
        discovered from the serving operator's live revision state
        (the same source the router's endpoint sets come from)."""
        out = []
        for ctrl in self.manager.controllers.values():
            fn = getattr(ctrl, "scrape_targets", None)
            if fn is not None:
                try:
                    out.extend(fn())
                except Exception:
                    pass  # discovery racing a teardown is fine
        return out

    def _record_chaos_event(self, point: str, rule, trace_id: str,
                            span_id: str = "") -> None:
        """Chaos-injection listener: every injection in this process
        becomes a store event (kind=Chaos, key=<point>) carrying the
        trace AND span active at injection time — so the injection
        lands at the right node of the `kfx trace` waterfall."""
        self.store.record_raw_event(
            "Chaos", point, "Warning", "ChaosInjected",
            f"fault injected at {point} (mode={rule.mode or 'error'})",
            trace_id=trace_id, span_id=span_id)

    def _record_alert_event(self, rule, reason: str, value, message: str
                            ) -> None:
        """Alert-transition listener: every pending/firing/resolved
        transition becomes a kind=Alert store event (key=<rule name>),
        so alert history reads like any other platform history."""
        etype = "Normal" if reason == "AlertResolved" else "Warning"
        self.store.record_raw_event("Alert", rule.name, etype, reason,
                                    message)

    def _collect_platform_metrics(self, reg: MetricsRegistry) -> None:
        """Pull-time collector: project live platform state into the
        registry (SURVEY.md §5.5 Prometheus-metrics role) — per-kind
        resource counts, per-controller workqueue gauges/counters, live
        gang count, event-log size."""
        from .api.base import registered_kinds

        g = reg.gauge("kfx_resources", "Number of stored resources by kind.")
        g.clear()
        for kind in registered_kinds():
            n = len(self.store.list(kind))
            if n:
                g.set(n, kind=kind)
        stat_gauges = {
            stat: reg.gauge(f"kfx_workqueue_{stat}",
                            f"Workqueue {stat} by controller.")
            for stat in ("depth", "delayed", "processing", "retrying")}
        adds = reg.counter("kfx_workqueue_adds_total",
                           "Keys added to the workqueue by controller.")
        requeues = reg.counter(
            "kfx_workqueue_requeues_total",
            "Rate-limited (failure) requeues by controller.")
        for kind, ctrl in self.manager.controllers.items():
            stats = ctrl.queue.stats()
            for stat, gauge in stat_gauges.items():
                gauge.set(stats.get(stat, 0), controller=kind)
            counters = ctrl.queue.counters()
            adds.set_total(counters["adds"], controller=kind)
            requeues.set_total(counters["requeues"], controller=kind)
        reg.gauge("kfx_gangs", "Live process gangs.").set(self.gangs.count())
        reg.counter("kfx_events_total",
                    "Events recorded since startup.").set_total(
                        self.store.event_count())

    # -- user-facing operations (the kubectl verbs) -------------------------
    def apply(self, resources: List[Resource],
              trace_id: Optional[str] = None) -> List[Tuple[Resource, str]]:
        # Admission mints ONE trace ID per submission (or adopts the
        # caller's, e.g. the apiserver's X-Kfx-Trace-Id): every new
        # object in the batch shares it, so a job and the resources it
        # arrived with join on one correlation ID. Stored on metadata,
        # it rides through reconciles into gang envs and events. The
        # admission span is the ROOT of the submission's trace tree —
        # its ID is annotated onto each new object so reconcile spans
        # (and everything under them) parent to it.
        trace_id = trace_id or obs_trace.new_trace_id()
        out = []
        with obs_trace.span("admission", trace_id=trace_id,
                            objects=str(len(resources))) as sp:
            for obj in resources:
                obj.validate()
                # Re-applies keep the live object's IDs so an unchanged
                # manifest stays "unchanged" (no resourceVersion churn).
                existing = self.store.try_get(obj.KIND, obj.name,
                                              obj.namespace)
                inherited = obs_trace.trace_of(existing)
                if inherited and not obs_trace.trace_of(obj):
                    obj.metadata.annotations[obs_trace.TRACE_ANNOTATION] = \
                        inherited
                else:
                    obs_trace.ensure_trace(obj, trace_id)
                inherited_span = obs_trace.span_of(existing)
                if inherited_span:
                    obj.metadata.annotations[obs_trace.SPAN_ANNOTATION] = \
                        inherited_span
                elif obs_trace.trace_of(obj) == trace_id:
                    # Only stamp the admission span onto objects whose
                    # effective trace IS this admission's trace: a
                    # pre-span-era re-apply keeps its old trace ID, and
                    # parenting its reconciles to a span from another
                    # trace would orphan them in `kfx trace`.
                    obj.metadata.annotations.setdefault(
                        obs_trace.SPAN_ANNOTATION, sp.span_id)
                out.append(self.store.apply(obj))
        return out

    def apply_file(self, path: str) -> List[Tuple[Resource, str]]:
        return self.apply(load_manifest_file(path))

    def apply_text(self, text: str) -> List[Tuple[Resource, str]]:
        return self.apply(load_manifests(text))

    def wait_for_job(self, kind: str, name: str, namespace: str = "default",
                     timeout: float = 600.0) -> TrainingJob:
        """Block until the job reaches Succeeded/Failed (or timeout)."""
        deadline = time.monotonic() + timeout
        while True:
            obj = self.store.try_get(kind, name, namespace)
            if obj is None:
                raise KeyError(f"{kind} {namespace}/{name} disappeared")
            assert isinstance(obj, TrainingJob)
            if obj.is_finished():
                return obj
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{kind} {namespace}/{name} not finished after {timeout}s;"
                    f" conditions={[c.to_dict() for c in obj.conditions]}")
            time.sleep(0.1)

    def wait_for_condition(self, kind: str, name: str, ctype: str,
                           namespace: str = "default",
                           timeout: float = 600.0) -> Resource:
        deadline = time.monotonic() + timeout
        while True:
            obj = self.store.try_get(kind, name, namespace)
            if obj is not None and obj.has_condition(ctype):
                return obj
            if time.monotonic() > deadline:
                conds = [] if obj is None else \
                    [c.to_dict() for c in obj.conditions]
                raise TimeoutError(
                    f"{kind} {namespace}/{name} lacks condition {ctype} "
                    f"after {timeout}s; conditions={conds}")
            time.sleep(0.1)

    def _replica_log_path(self, kind: str, name: str, namespace: str,
                          replica: str) -> str:
        obj = self.store.get(kind, name, namespace)
        assert isinstance(obj, TrainingJob)
        gkey = f"{kind.lower()}/{namespace}/{name}"
        gang = self.gangs.get(gkey)
        rid = replica or f"{obj.chief_replica_type().lower()}-0"
        if gang is not None:
            return gang.log_path(rid)
        # Finished gang was forgotten; its workdir is stable.
        return os.path.join(self.gangs.workdir_for(gkey), "logs",
                            f"{rid}.log")

    def job_logs(self, kind: str, name: str, namespace: str = "default",
                 replica: str = "") -> str:
        """Read a replica's full log (chief replica if unspecified)."""
        path = self._replica_log_path(kind, name, namespace, replica)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no log at {path}")
        with open(path, "rb") as f:
            return f.read().decode(errors="replace")

    def job_logs_from(self, kind: str, name: str, namespace: str,
                      replica: str, offset: int) -> Tuple[str, int]:
        """Incremental tail: read from byte ``offset``, return (new text,
        next offset) — pollers don't re-read the whole file. A NEGATIVE
        offset reads the last ``-offset`` bytes (the `kfx top` path: a
        multi-hundred-MB chief log must not be read whole for its last
        few metric lines)."""
        path = self._replica_log_path(kind, name, namespace, replica)
        if not os.path.exists(path):
            return "", max(offset, 0)
        with open(path, "rb") as f:
            if offset < 0:
                f.seek(0, os.SEEK_END)
                offset = max(0, f.tell() + offset)
            f.seek(offset)
            data = f.read()
        return data.decode(errors="replace"), offset + len(data)
