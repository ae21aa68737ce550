"""kfx — the platform CLI (kubectl+kfctl-shaped UX, SURVEY.md §7); the
port's copy of ``kubeflow_tpu/cli.py``.

Two modes:

* **run mode** (`kfx run -f job.yaml`) embeds a control plane, applies the
  manifests, waits for every training job and Experiment in them to
  finish, streams the chief log of each job (an Experiment prints its
  `best trial:` line), and exits 0/1 on Succeeded/Failed:

      python -m kubeflow_tpu_torch.cli --home /tmp/kfx run \\
          -f examples/torch/mnist-jaxjob.yaml

* **server mode** (`kfx server`, ``apiserver.py``): a persistent control
  plane behind a REST apiserver and dashboard; other kfx invocations
  with ``KFX_SERVER=http://host:port`` become thin HTTP clients (the
  kubectl model), and a local mutation against a home a live server owns
  is routed through it:

      python -m kubeflow_tpu_torch.cli --home /tmp/kfx server --port 8134
      KFX_SERVER=http://127.0.0.1:8134 python -m kubeflow_tpu_torch.cli \\
          run -f kfdef.yaml

A KfDef document expands client-side (``kfctl.py``; `kfx init` scaffolds
one, `kfx generate` writes what it renders), and `kfx profile` captures a
trace of a running worker (``profiling.py``). The workers run the port's
runners on the card; ``KFX_WORKER_PLATFORM=cpu`` (or
``ControlPlane(worker_platform="cpu")``) pins them to the CPU
(``operators/training.py``). The CLI and ``kfx server`` import no torch.

Verbs: apply, run, get, describe, delete, logs, events, profile, trace,
top, queue, rollout, query, alerts, slo, usage, postmortem, flight,
kill-replica, init, generate, server, version.

An InferenceService applied in local mode serves while that process
lives: ``apply`` without a server returns at once and its replicas stop
with the plane.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

from .api.base import Resource, resource_class
from .api.training import TrainingJob
from .controlplane import ControlPlane, HomeBusy, default_home, resolve_home


def _fmt_age(created: str) -> str:
    from .api.base import age_seconds

    if not created:
        return "?"
    try:
        s = int(age_seconds(created))
    except ValueError:
        return "?"
    if s < 60:
        return f"{s}s"
    if s < 3600:
        return f"{s // 60}m{s % 60}s"
    return f"{s // 3600}h{(s % 3600) // 60}m"


def _job_state(obj: Resource) -> str:
    from .api.base import display_state

    return display_state(obj.conditions)


def _fmt_pooled(pooled: dict) -> str:
    """Render status.pooledModels ({revision: {model: loaded?}}):
    resident models by name, unloaded ones parenthesized — "(m)" is
    pooled but unloaded, one weight swap from serving."""
    names: dict = {}
    for rev_map in pooled.values():
        for m, loaded in rev_map.items():
            names[m] = bool(loaded) or names.get(m, False)
    if not names:
        return "-"
    return ",".join(m if loaded else f"({m})"
                    for m, loaded in sorted(names.items()))


def _print_table(rows: List[List[str]], headers: List[str]) -> None:
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    print("  ".join(h.ljust(w) for h, w in zip(headers, widths)))
    for r in rows:
        print("  ".join(c.ljust(w) for c, w in zip(r, widths)))


class KfxCLI:
    """CLI against a ControlPlane (embedded, or remote when KFX_SERVER is
    set — see kubeflow_tpu_torch.apiserver.Client, which matches this surface)."""

    def __init__(self, cp: ControlPlane):
        self.cp = cp

    # -- verbs --------------------------------------------------------------
    def apply(self, paths: List[str]) -> List[Resource]:
        from .api.base import from_manifest
        from .kfctl import expand_manifest_file

        out = []
        for path in paths:
            # KfDef documents expand client-side into their rendered
            # platform resources (kfctl model; see kubeflow_tpu_torch.kfctl).
            resources = [from_manifest(d)
                         for d in expand_manifest_file(path)]
            for obj, verb in self.cp.apply(resources):
                print(f"{obj.KIND.lower()}/{obj.name} {verb}")
                out.append(obj)
        return out

    def run(self, paths: List[str], timeout: float, follow: bool = True) -> int:
        applied = self.apply(paths)
        waitable = [o for o in applied
                    if isinstance(o, TrainingJob)
                    or o.KIND in ("Experiment", "Pipeline")]
        if not waitable:
            print("nothing to wait for (no training jobs, experiments or "
                  "pipelines in manifests)")
            return 0
        return self.wait_and_report(waitable, timeout, follow=follow)

    def wait_and_report(self, objs: List[Resource], timeout: float,
                        follow: bool = False) -> int:
        """Wait for each object to finish and print its terminal state
        (plus the best-trial summary for Experiments). Shared by `kfx
        run` and the serverless `kfx apply` wait."""
        rc = 0
        for obj in objs:
            final = self._wait_streaming(
                obj, timeout, follow and isinstance(obj, TrainingJob))
            state = _job_state(final)
            print(f"{obj.KIND.lower()}/{obj.name} {state.lower()}")
            if state != "Succeeded":
                rc = 1
            if final.KIND == "Experiment":
                best = final.status.get("currentOptimalTrial")
                if best:
                    metrics = best.get("observation", {}).get("metrics", [])
                    print(f"best trial: {best.get('bestTrialName')} "
                          f"{metrics} "
                          f"{best.get('parameterAssignments')}")
        return rc

    @staticmethod
    def _is_terminal(obj: Resource) -> bool:
        if isinstance(obj, TrainingJob):
            return obj.is_finished()
        return obj.has_condition("Succeeded") or obj.has_condition("Failed")

    def _wait_streaming(self, job: Resource, timeout: float,
                        follow: bool) -> Resource:
        """Wait for completion while tailing the chief log to stdout."""
        deadline = time.monotonic() + timeout
        offset = 0
        while True:
            obj = self.cp.store.try_get(job.KIND, job.name, job.namespace)
            if obj is None:
                raise SystemExit(f"{job.KIND} {job.key} disappeared")
            if follow:
                offset = self._tail(obj, offset)
            if self._is_terminal(obj):
                if follow:
                    time.sleep(0.2)  # final flush
                    self._tail(obj, offset)
                return obj
            if time.monotonic() > deadline:
                raise SystemExit(
                    f"timeout: {job.KIND} {job.key} still "
                    f"{_job_state(obj)} after {timeout}s")
            time.sleep(0.2)

    def _tail(self, job: TrainingJob, offset: int) -> int:
        try:
            text, offset = self.cp.job_logs_from(
                job.KIND, job.name, job.namespace, "", offset)
        except KeyError:
            return offset
        if text:
            sys.stdout.write(text)
            sys.stdout.flush()
        return offset

    def get(self, kind: str, name: Optional[str], namespace: str,
            output: str) -> int:
        cls = resource_class(kind)
        if name:
            objs = [self.cp.store.get(cls.KIND, name, namespace)]
        else:
            objs = self.cp.store.list(cls.KIND, namespace)
        if output == "json":
            docs = [o.to_dict() for o in objs]
            print(json.dumps(docs[0] if name else docs, indent=2))
        elif output == "yaml":
            from .api.manifest import dump_manifest

            print("---\n".join(dump_manifest(o) for o in objs), end="")
        else:
            rows = [[o.name, _job_state(o),
                     str(o.status.get("restartCount", 0)),
                     _fmt_age(o.metadata.creation_timestamp)] for o in objs]
            headers = ["NAME", "STATE", "RESTARTS", "AGE"]
            if any(o.status.get("pooledModels") for o in objs):
                # Multi-model weight pools (status.pooledModels):
                # "loaded" names are HBM-resident, "(name)" is pooled
                # but unloaded — servable after one weight swap.
                headers.append("POOLED")
                for row, o in zip(rows, objs):
                    row.append(_fmt_pooled(
                        o.status.get("pooledModels") or {}))
            _print_table(rows, headers)
        return 0

    def describe(self, kind: str, name: str, namespace: str) -> int:
        cls = resource_class(kind)
        obj = self.cp.store.get(cls.KIND, name, namespace)
        from .api.manifest import dump_manifest

        print(dump_manifest(obj), end="")
        events = self.cp.store.events_for(cls.KIND, f"{namespace}/{name}")
        if events:
            print("events:")
            for e in events:
                trace = f" [trace={e.trace_id}]" if e.trace_id else ""
                print(f"  {e.timestamp} {e.type} {e.reason}: "
                      f"{e.message}{trace}")
        return 0

    def delete(self, kind: str, name: str, namespace: str) -> int:
        cls = resource_class(kind)
        self.cp.store.delete(cls.KIND, name, namespace)
        print(f"{cls.KIND.lower()}/{name} deleted")
        return 0

    def delete_files(self, paths: List[str]) -> int:
        """kfctl-delete model: tear down everything the manifests (or a
        KfDef) render, in REVERSE apply order so dependents go before
        the profiles/defaults they hang off."""
        from .core.store import NotFound

        def delete(kind: str, name: str, ns: str) -> bool:
            try:
                self.cp.store.delete(kind, name, ns)
                return True
            except (NotFound, KeyError):
                return False

        return _delete_rendered(paths, delete)

    def logs(self, kind: str, name: str, namespace: str, replica: str) -> int:
        cls = resource_class(kind)
        print(self.cp.job_logs(cls.KIND, name, namespace, replica), end="")
        return 0

    def events(self, kind: str, name: str, namespace: str) -> int:
        cls = resource_class(kind)
        for e in self.cp.store.events_for(cls.KIND, f"{namespace}/{name}"):
            trace = f" [trace={e.trace_id}]" if e.trace_id else ""
            print(f"{e.timestamp} {e.type} {e.reason}: {e.message}{trace}")
        return 0

    def trace(self, kind: str, name: str, namespace: str,
              fmt: str = "ascii", output: str = "",
              since_s: float = 0.0, min_ms: float = 0.0,
              tenant: str = "") -> int:
        """Cross-process timeline reconstruction (`kfx trace <job>`):
        merge the span logs of the control plane and every gang replica
        for this job's trace ID into one tree; render an ASCII
        waterfall with the critical path, or Chrome trace JSON
        (--format=chrome) loadable in Perfetto / chrome://tracing.
        ``--since N`` keeps only spans still live in the last N
        seconds and ``--min-ms M`` drops spans shorter than M ms —
        the long-lived-revision filters (a serving trace accretes
        request spans forever; the waterfall must not)."""
        from .obs import timeline
        from .obs.trace import SPANS_DIRNAME, trace_of

        cls = resource_class(kind)
        job = self.cp.store.get(cls.KIND, name, namespace)
        trace_id = trace_of(job)
        if not trace_id:
            print(f"error: {cls.KIND} {namespace}/{name} carries no "
                  f"trace annotation (applied before tracing existed?)",
                  file=sys.stderr)
            return 1
        import glob

        gkey = f"{cls.KIND.lower()}/{namespace}/{name}"
        # Every place this home's processes write span logs: the plane
        # itself, this job's gang replicas, and all serving revisions
        # (a request trace crosses router -> model server there).
        dirs = [os.path.join(self.cp.home, SPANS_DIRNAME),
                os.path.join(self.cp.gangs.workdir_for(gkey),
                             SPANS_DIRNAME)]
        dirs += sorted(glob.glob(os.path.join(
            self.cp.home, "serving", "*", SPANS_DIRNAME)))
        spans = timeline.load_spans(timeline.span_files(dirs), trace_id)
        spans = timeline.filter_spans(spans, since_s=since_s,
                                      min_duration_s=min_ms / 1000.0,
                                      tenant=tenant)
        if not spans:
            print(f"error: no spans recorded for trace {trace_id} "
                  f"(searched {', '.join(dirs)}"
                  + (f"; --since/--min-ms/--tenant filtered "
                     f"everything out"
                     if since_s or min_ms or tenant else "") + ")",
                  file=sys.stderr)
            return 1
        if fmt == "chrome":
            text = json.dumps(timeline.chrome_trace(spans), indent=1)
        else:
            text = timeline.render_waterfall(spans)
        if output:
            with open(output, "w") as f:
                f.write(text + "\n")
            print(f"wrote {output} ({len(spans)} spans)")
        else:
            print(text)
        return 0

    def top(self, watch: float = 0.0, window_s: float = 30.0) -> int:
        """Live training telemetry (the `kubectl top` analogue): latest
        step/loss/throughput per training job, parsed from each chief
        log with the same stdout-metric contract the HPO collector uses
        (SURVEY.md §5.5) — so `kfx top`, Katib observations and the
        runner all agree on one number. Headed by the gang scheduler's
        capacity/queue summary; per-InferenceService replica lines
        (ready/spawned vs the autoscaler's target) follow the table,
        with TOK/S, RPS and SKIP% computed as TRUE WINDOW RATES from
        the central telemetry store's history buffer (obs/tsdb.py) —
        not gauge snapshots. ``--watch N`` refreshes every N seconds."""
        while True:
            rc = self._top_once(window_s)
            if watch <= 0:
                return rc
            try:
                time.sleep(watch)
            except KeyboardInterrupt:
                return rc
            print(f"\n--- kfx top (refresh every {watch:g}s, "
                  f"rates over {window_s:g}s) ---")

    def _top_once(self, window_s: float) -> int:
        running, queued = _slice_state(_store_jobs(self.cp))
        serving = _serving_slice_rows(
            self.cp.store.list("InferenceService"))
        print(_capacity_summary(
            self.cp.sched.capacity,
            sum(r.chips for r in running + serving), len(queued)))
        rows = []
        for kind in _training_kinds():
            for job in self.cp.store.list(kind):
                try:
                    # Negative offset = tail: never read a huge chief
                    # log whole for its last few metric lines.
                    text, _ = self.cp.job_logs_from(
                        kind, job.name, job.namespace, "", -16384)
                except (OSError, KeyError):
                    text = ""
                rows.append([job.name, kind, job.namespace,
                             _job_state(job)] + _telemetry_cells(text))
        rc = _print_top(rows)
        _print_serving_top(_serving_top_rows(
            self.cp.store.list("InferenceService"),
            rates_fn=_local_rates_fn(self.cp, window_s)))
        return rc

    def query(self, family: str, fn: str, labels: str,
              since: float, as_json: bool = False) -> int:
        """Windowed telemetry query (`kfx query FAMILY --fn rate`):
        the central store's history for any scraped family, rendered
        as the aggregate value plus an ASCII sparkline of the window's
        points (or the raw result dict with ``--json`` — scriptable
        incident tooling; rc semantics identical). Shares the /query
        endpoint's semantics exactly."""
        from .apiserver import parse_label_selector

        try:
            sel = parse_label_selector(labels)
            res = self.cp.telemetry.query(family, fn, sel or None,
                                          since)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        return _print_query(res.to_dict(), as_json=as_json)

    def _passive_rule_note(self) -> None:
        # A passive (read-only) plane never scrapes or evaluates:
        # rendering every rule as "inactive" would read as a green
        # fleet during an incident the OWNING server sees. Applies
        # equally to SLO-generated burn rules (same engine).
        if self.cp.alerts.last_eval == 0:
            print("note: rules have never been evaluated in this "
                  "process (passive plane) — run inside `kfx server` "
                  "or set KFX_SERVER to query the live plane",
                  file=sys.stderr)

    def alerts(self, as_json: bool = False) -> int:
        """Alert-rule states (`kfx alerts`): the rule pack with each
        rule's live state/value — transitions land as kind=Alert store
        events (`kfx events` territory); this is the "what is firing
        right now" view. ``--json`` emits the raw state list (rc still
        1 while anything fires — same scriptable health-check
        contract)."""
        self._passive_rule_note()
        return _print_alerts(self.cp.alerts.states(), as_json=as_json)

    def slo(self, as_json: bool = False) -> int:
        """Error-budget dashboard (`kfx slo`): every SLO's remaining
        budget, fast/slow burn rates, and its generated burn rules'
        live states (same renderer as `kfx alerts`). rc 1 while any
        SLO's fast-burn rule fires — the page-now signal, scriptable
        like a health check (same rc with ``--json``)."""
        from .obs.slo import slo_snapshot

        self._passive_rule_note()
        return _print_slos(slo_snapshot(self.cp.store, self.cp.alerts),
                           as_json=as_json)

    def usage(self, tenant: str = "", window: float = 3600.0,
              as_json: bool = False) -> int:
        """Per-tenant usage (`kfx usage [--tenant T] [--window N]`):
        the fleet-aggregated token ledger — window deltas (stitching
        onto the downsampled tier for long windows) plus exact
        cumulative totals, top consumers first."""
        from .obs.slo import usage_summary

        rows = usage_summary(self.cp.telemetry, window_s=window,
                             tenant=tenant or None)
        return _print_usage(rows, window, as_json=as_json)

    def postmortem(self, name: str, namespace: str,
                   bundle: str = "") -> int:
        """List an InferenceService's postmortem bundles (`kfx
        postmortem <isvc>`) and render the newest one's flight ring as
        an ASCII timeline with the stalled iteration marked — the
        incident-bridge view of what the replica's engine was doing
        when the operator killed (or reaped) it. ``--bundle PATH``
        renders a specific bundle instead of the newest."""
        import glob

        from .obs.flightrec import render_timeline

        self.cp.store.get("InferenceService", name, namespace)
        pattern = os.path.join(self.cp.home, "serving", "*",
                               "postmortem", "*")
        bundles = []
        for d in sorted(glob.glob(pattern)):
            meta = _read_json(os.path.join(d, "meta.json")) or {}
            if meta.get("isvc") == name and \
                    meta.get("namespace") == namespace:
                bundles.append((d, meta))
        if not bundles:
            print(f"no postmortem bundles for {namespace}/{name} "
                  f"(searched {pattern})")
            return 1
        rows = [[os.path.basename(d), str(meta.get("reason", "-")),
                 str(meta.get("revision", "-")),
                 str(meta.get("port", "-")), d]
                for d, meta in bundles]
        _print_table(rows, ["BUNDLE", "REASON", "REVISION", "PORT",
                            "PATH"])
        chosen = bundle or bundles[-1][0]
        flight = _read_json(os.path.join(chosen, "flight.json"))
        if flight is None:
            print(f"error: {chosen}/flight.json unreadable",
                  file=sys.stderr)
            return 1
        print(f"\nflight ring from {chosen}:")
        for model, snap in sorted(
                _flight_models(flight).items()):
            print(f"[{model}]")
            print(render_timeline(snap.get("records") or [],
                                  heartbeat=snap.get("heartbeat")))
        return 0

    def flight(self, name: str, namespace: str) -> int:
        """Live flight-ring view (`kfx flight <isvc>`): render the
        newest /healthz-refreshed flight snapshot file each replica of
        the InferenceService wrote into its revision workdir — the
        same timeline `kfx postmortem` renders, before anything has
        died. Host-local (reads workdir files), like `kfx trace`."""
        import glob

        from .obs.flightrec import render_timeline

        self.cp.store.get("InferenceService", name, namespace)
        snaps = sorted(glob.glob(os.path.join(
            self.cp.home, "serving", "*", "flight", "*.json")),
            key=lambda p: os.path.getmtime(p))
        if not snaps:
            print(f"no flight snapshots under "
                  f"{os.path.join(self.cp.home, 'serving')} (replicas "
                  f"write them on /healthz; KFX_FLIGHT=0 disables)")
            return 1
        rendered = 0
        for snap_path in snaps[-4:]:
            doc = _read_json(snap_path)
            if doc is None:
                continue
            print(f"{snap_path}:")
            for model, snap in sorted(_flight_models(doc).items()):
                print(f"[{model}]")
                print(render_timeline(snap.get("records") or [],
                                      heartbeat=snap.get("heartbeat")))
                rendered += 1
        return 0 if rendered else 1

    def queue(self) -> int:
        """Gang-scheduler view (`kfx queue`): slice capacity, the gangs
        holding chips (incl. elastic serving reservations), and the
        priority-ordered wait queue — derived from the store
        (conditions + annotations the scheduler writes), so it reads
        identically against a live plane, a passive CLI plane, or a
        journal-recovered home."""
        running, queued = _slice_state(_store_jobs(self.cp))
        serving = _serving_slice_rows(
            self.cp.store.list("InferenceService"))
        print(_capacity_summary(
            self.cp.sched.capacity,
            sum(r.chips for r in running + serving), len(queued)))
        return _print_queue(running + serving, queued)

    def rollout(self, name: Optional[str], namespace: str) -> int:
        """Canary rollout state (`kfx rollout [name]`): the controller-
        owned traffic percent, phase, and the last SLO observation per
        InferenceService — plus the rollback verdict annotation when a
        canary was auto-rolled-back."""
        if name:
            isvcs = [self.cp.store.get("InferenceService", name, namespace)]
        else:
            isvcs = self.cp.store.list("InferenceService", namespace)
        return _print_rollouts(isvcs)

    def profile(self, kind: str, name: str, namespace: str, replica: str,
                duration_ms: int, logdir: str) -> int:
        """Capture a torch.profiler trace from a running replica (SURVEY.md
        §5.1: `kfx profile <job>` → a ``.pt.trace.json.gz`` under
        TensorBoard's ``plugins/profile/<run>/`` layout, where the
        reference writes an xplane dump; ``profiling.py``).

        Works cross-process: the workdir where workers advertise their
        profiler ports is derived from the store, so a passive kfx
        invocation can profile a job owned by `kfx server` (or another
        `kfx run`) on the same host."""
        from .profiling import capture_trace, replica_port

        cls = resource_class(kind)
        job = self.cp.store.get(cls.KIND, name, namespace)
        key = f"{cls.KIND.lower()}/{namespace}/{name}"
        gang = self.cp.gangs.get(key)
        workdir = gang.workdir if gang else self.cp.gangs.workdir_for(key)
        if not replica:
            if gang is not None:
                chief = gang.chief_replica_type
            elif isinstance(job, TrainingJob):
                chief = job.chief_replica_type()
            else:
                chief = "worker"
            replica = f"{chief.lower()}-0"
        port = replica_port(workdir, replica)
        if port is None:
            print(f"replica {replica} of {key} has not advertised a "
                  f"profiler port (job not running, started with "
                  f"KFX_PROFILE=0, or still initialising?)",
                  file=sys.stderr)
            return 1
        out = logdir or os.path.join(workdir, "profiler", "traces")
        try:
            paths = capture_trace(f"localhost:{port}", out, duration_ms)
        except RuntimeError as e:  # the worker's answer: busy, no ops
            print(f"error: {e}", file=sys.stderr)
            return 1
        for p in paths:
            print(p)
        print(f"trace captured: point tensorboard --logdir at {out}, or "
              f"open the file in ui.perfetto.dev")
        return 0

    def kill_replica(self, kind: str, name: str, namespace: str,
                     replica: str) -> int:
        """Fault-injection hook (SURVEY.md §5.3: `kfx kill-worker`)."""
        gang = self.cp.gangs.get(f"{kind.lower()}/{namespace}/{name}")
        if gang is None:
            print(f"no running gang for {kind} {namespace}/{name}",
                  file=sys.stderr)
            return 1
        if gang.kill_replica(replica):
            print(f"killed {replica}")
            return 0
        print(f"replica {replica} not running", file=sys.stderr)
        return 1


class _SliceRow:
    """One job's scheduler-relevant state for `kfx queue` / `kfx top`."""

    __slots__ = ("name", "kind", "namespace", "priority", "chips", "state",
                 "detail", "created")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))


def _slice_state(jobs) -> Tuple[List["_SliceRow"], List["_SliceRow"]]:
    """(running, queued) slice rows derived from ``jobs`` — an iterable
    of (kind, Resource): gangs that hold chips vs jobs waiting (queued
    on capacity/quota, or preempted and waiting to resume). Queued rows
    come back in scheduler order — priority desc, fair share (namespace
    holding fewer running chips first), then submission age."""
    from .api.base import get_condition
    from .sched import PREEMPTED_ANNOTATION, job_priority

    running, queued = [], []
    for kind, job in jobs:
        if job.is_finished():
            continue
        row = _SliceRow(
            name=job.name, kind=kind, namespace=job.namespace,
            priority=job_priority(job), chips=job.total_replicas(),
            created=job.metadata.creation_timestamp, detail="")
        preempted = PREEMPTED_ANNOTATION in job.metadata.annotations
        if job.has_condition("Queued"):
            cond = get_condition(job.conditions, "Queued")
            row.state = "Queued"
            row.detail = (cond.message if cond else "") or \
                (cond.reason if cond else "")
            queued.append(row)
        elif job.run_policy().suspend or job.has_condition("Suspended"):
            if preempted:
                row.state = "Preempted"
                row.detail = "resumes from checkpoint when capacity frees"
                queued.append(row)
            # User-suspended jobs hold no chips and wait for the user,
            # not the scheduler — they are not part of this view.
        else:
            row.state = "Running"
            running.append(row)
    used: dict = {}
    for r in running:
        used[r.namespace] = used.get(r.namespace, 0) + r.chips
    queued.sort(key=lambda r: (-r.priority, used.get(r.namespace, 0),
                               r.created or ""))
    return running, queued


def _serving_slice_rows(isvcs) -> "List[_SliceRow]":
    """Elastic serving reservations as slice rows (`kfx queue` /
    `kfx top` header): an InferenceService's spawned predictor replicas
    (default + canary) each hold one chip, like gang members. A
    disaggregated service (KV transfer plane) shows its per-tier
    replica split — ``prefill=N decode=M`` — since the tiers scale on
    different signals and a capacity squeeze hits them separately."""
    rows = []
    for isvc in isvcs:
        repl = isvc.status.get("replicas") or {}
        chips = sum(int(repl.get(r) or 0) for r in ("default", "canary"))
        if chips <= 0:
            continue
        auto = isvc.status.get("autoscaling") or {}
        wanted = sum(int((auto.get(r) or {}).get("desired") or 0)
                     for r in ("default", "canary"))
        detail = (f"elastic; autoscaler wants {wanted}"
                  if wanted and wanted != chips else "elastic")
        tiers: Dict[str, int] = {}
        for r in ("default", "canary"):
            role = str((auto.get(r) or {}).get("role") or "mixed")
            n = int(repl.get(r) or 0)
            if n > 0 and role != "mixed":
                tiers[role] = tiers.get(role, 0) + n
        if tiers:
            detail += "; " + " ".join(
                f"{role}={n}" for role, n in sorted(tiers.items()))
        rows.append(_SliceRow(
            name=isvc.name, kind="InferenceService",
            namespace=isvc.namespace, priority=isvc.scheduling_priority(),
            chips=chips, state="Serving",
            detail=detail,
            created=isvc.metadata.creation_timestamp))
    return rows


def _serving_top_rows(isvcs, rates_fn=None) -> List[List[str]]:
    """Per-revision replica lines for `kfx top`: ready/spawned against
    the autoscaler's desired count and concurrency target, the decode
    engine's KV-page pool utilization, prefix-cache prefill-skip
    fraction (SKIP% — the signal prefix-affinity routing moves),
    speculative-decode accept rate and quantization mode (Q column:
    "w8"/"kv8"/"w8+kv8"/"d8"/"f32"; paged LM revisions — "-" for
    classifiers and engines with the signal absent), the adapter-slot
    pool as "pinned/total" (ADPT column — multi-tenant LoRA revisions
    only), the weight-slot pool as "loaded/total" (MODELS column —
    multi-model revisions only), the in-flight QoS-class split as
    "interactive/batch" (I/B
    column — request plane, LM revisions only), the disaggregation
    tier as P/D/M (ROLE column — KV transfer plane) with cumulative
    KV migrations out of the revision (MIG column), cumulative
    replica restarts (crashes + liveness wedge-kills, the
    kfx_replica_restarts_total number), window-rate TOK/S + RPS
    columns, plus the canary traffic split.

    ``rates_fn(namespace, isvc, revision) -> (tok_s, rps, skip)`` taps
    the central telemetry store's history buffer: TOK/S and RPS are
    true window rates (None renders "-"), and a non-None window
    ``skip`` REPLACES the status snapshot's cumulative SKIP% — the
    live number a `--watch` loop should show."""
    rows = []
    for isvc in isvcs:
        repl = isvc.status.get("replicas") or {}
        ready = isvc.status.get("readyReplicas") or {}
        auto = isvc.status.get("autoscaling") or {}
        pct = (isvc.status.get("rollout") or {}).get(
            "percent", isvc.canary_traffic_percent_split())
        for rev in ("default", "canary"):
            if rev not in repl and rev not in auto:
                continue
            a = auto.get(rev) or {}
            panic = " (panic)" if a.get("panic") else ""
            # Disaggregation tier (KV transfer plane): P/D/M for
            # prefill/decode/mixed, "-" for pre-role status snapshots.
            role = str(a.get("role") or "")[:1].upper() or "-"
            mig = a.get("migrations")  # cumulative KV migrations out
            kv = a.get("kvUtil")
            acc = a.get("specAcceptRate")
            skip = a.get("prefillSkip")
            adpt = a.get("adapters")  # "pinned/total" or absent
            mdl = a.get("models")  # weight pool "loaded/total" or absent
            classes = a.get("classes")  # "interactive/batch" or absent
            tok_s = rps = None
            if rates_fn is not None:
                tok_s, rps, window_skip = rates_fn(
                    isvc.namespace, isvc.name, rev)
                if window_skip is not None:
                    skip = window_skip
            rows.append([
                isvc.name, isvc.namespace, rev, role,
                f"{int(ready.get(rev) or 0)}/{int(repl.get(rev) or 0)}",
                f"{a.get('desired', '-')}{panic}",
                str(a.get("target", "-")),
                f"{kv * 100:.0f}%" if kv is not None else "-",
                f"{skip * 100:.0f}%" if skip is not None else "-",
                f"{acc * 100:.0f}%" if acc is not None else "-",
                str(a.get("quant") or "-"),
                str(adpt) if adpt else "-",
                str(mdl) if mdl else "-",
                str(classes) if classes else "-",
                str(int(mig)) if mig else "-",
                str(a["restarts"]) if a.get("restarts") is not None
                else "-",
                f"{tok_s:.1f}" if tok_s is not None else "-",
                f"{rps:.1f}" if rps is not None else "-",
                f"{pct}%" if rev == "canary" else "-"])
    return rows


def _print_serving_top(rows: List[List[str]]) -> None:
    if not rows:
        return
    print()
    _print_table(rows, ["ISVC", "NAMESPACE", "REV", "ROLE",
                        "READY/REPL", "DESIRED", "TARGET", "KV%",
                        "SKIP%", "ACC%", "Q", "ADPT", "MODELS", "I/B",
                        "MIG", "RESTARTS", "TOK/S", "RPS", "CANARY%"])


def _revision_window_rates(query, namespace: str, isvc: str,
                           revision: str, window_s: float):
    """(tokens/s, RPS, window prefill-skip fraction) for one revision
    from a telemetry ``query(family, fn, labels, since)`` callable —
    the one rate derivation local and remote `kfx top` share. Any
    signal without history in the window is None ("-")."""
    sel = {"namespace": namespace, "isvc": isvc, "revision": revision}

    def q(family, fn):
        try:
            res = query(family, fn, sel, window_s)
        except Exception:
            return None
        return res.get("value") if isinstance(res, dict) else res.value

    tok_s = q("kfx_lm_generated_tokens_total", "rate")
    rps = q("kfx_router_requests_total", "rate")
    reused = q("kfx_lm_prefix_tokens_reused", "delta")
    admitted = q("kfx_lm_prompt_tokens_admitted", "delta")
    skip = (reused / admitted) if reused is not None \
        and admitted else None
    return tok_s, rps, skip


def _local_rates_fn(cp, window_s: float):
    telemetry = getattr(cp, "telemetry", None)
    if telemetry is None:
        return None

    def rates(namespace, isvc, revision):
        return _revision_window_rates(telemetry.query, namespace, isvc,
                                      revision, window_s)
    return rates


def _selector_dict(text: str) -> dict:
    from .apiserver import parse_label_selector

    return parse_label_selector(text)


def _remote_rates_fn(client, window_s: float):
    def rates(namespace, isvc, revision):
        return _revision_window_rates(
            lambda fam, fn, sel, since: client.query(fam, fn, sel, since),
            namespace, isvc, revision, window_s)
    return rates


_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def _sparkline(values: List[float], width: int = 60) -> str:
    """Downsampled unicode sparkline of a value series."""
    if not values:
        return ""
    if len(values) > width:
        # Bucket-mean downsample so a long window still fits one line.
        step = len(values) / width
        buckets = []
        for i in range(width):
            chunk = values[int(i * step):int((i + 1) * step)] or \
                [values[min(int(i * step), len(values) - 1)]]
            buckets.append(sum(chunk) / len(chunk))
        values = buckets
    lo, hi = min(values), max(values)
    span = hi - lo
    out = []
    for v in values:
        idx = int((v - lo) / span * (len(_SPARK_BLOCKS) - 1)) if span \
            else 0
        out.append(_SPARK_BLOCKS[idx])
    return "".join(out)


def _fmt_value(v, fn: str) -> str:
    if v is None:
        return "-"
    return f"{v:.4g}/s" if fn == "rate" else f"{v:.4g}"


def _read_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _flight_models(doc: dict) -> dict:
    """{model: snapshot} out of a flight document — both the server's
    /debug/flight body and the on-disk snapshot file nest snapshots
    under "models" (a bare single-model snapshot also renders)."""
    if not isinstance(doc, dict):
        return {}
    models = doc.get("models")
    if isinstance(models, dict):
        return models
    return {"model": doc} if "records" in doc else {}


def _print_query(res: dict, as_json: bool = False) -> int:
    """Render one /query result (shared by local and remote `kfx
    query`). rc 1 when the window holds no samples at all — the
    scriptable 'is there history' signal (same rc with --json)."""
    pts = res.get("points") or []
    value = res.get("value")
    fn = res.get("fn", "latest")
    if as_json:
        print(json.dumps(res, indent=1))
        return 1 if (value is None and not pts) else 0
    print(f"{res.get('family')} {fn}[{res.get('since'):g}s] = "
          f"{_fmt_value(value, fn)}  "
          f"({res.get('seriesMatched', 0)} series, {len(pts)} points)")
    if pts:
        values = [v for _, v in pts]
        span = pts[-1][0] - pts[0][0]
        print(f"  {_sparkline(values)}")
        print(f"  min {min(values):.4g}  max {max(values):.4g}  "
              f"span {span:.0f}s")
    if value is None and not pts:
        print("  no samples in the window (is the scraper running? "
              "`kfx query` needs a live `kfx server` or embedded plane)")
        return 1
    return 0


def _alert_rows(states: List[dict]) -> List[List[str]]:
    """Rule states -> table rows: the ONE rule-state renderer, shared
    by `kfx alerts` and the rules section of `kfx slo`."""
    rows = []
    for st in states:
        val = st.get("value")
        rows.append([st.get("name", ""), st.get("severity", ""),
                     str(st.get("state", "")),
                     f"{val:.4g}" if isinstance(val, (int, float))
                     else "-",
                     st.get("expr", "")])
    return rows


def _print_alerts(states: List[dict], as_json: bool = False) -> int:
    """Render the rule states (shared by local and remote `kfx
    alerts`). rc 1 while anything is firing — scriptable like a
    health check (same rc with --json)."""
    firing = sum(1 for st in states if st.get("state") == "firing")
    if as_json:
        print(json.dumps({"alerts": states, "firing": firing},
                         indent=1))
        return 1 if firing else 0
    rows = _alert_rows(states)
    if not rows:
        print("no alert rules loaded")
        return 0
    _print_table(rows, ["RULE", "SEVERITY", "STATE", "VALUE", "EXPR"])
    return 1 if firing else 0


def _print_slos(slos: List[dict], as_json: bool = False) -> int:
    """Render the /slos payload (shared by local and remote `kfx
    slo`): budget table with burn arrows, then the generated rules
    through the same renderer `kfx alerts` uses. rc 1 while any
    fast-burn rule fires."""
    from .obs.slo import FAST_BURN_THRESHOLD, SLOW_BURN_THRESHOLD

    paging = sum(1 for s in slos for st in s.get("rules", [])
                 if st.get("state") == "firing"
                 and st.get("name", "").endswith("-fast-burn"))
    if as_json:
        print(json.dumps({"slos": slos, "firingFast": paging},
                         indent=1))
        return 1 if paging else 0
    if not slos:
        print("no SLOs applied (kind: SLO)")
        return 0

    def _burn(v, threshold) -> str:
        if not isinstance(v, (int, float)):
            return "-"
        return f"{v:.2f}" + ("▲" if v > threshold else "")

    rows = []
    for s in slos:
        meta = s.get("metadata") or {}
        spec = s.get("spec") or {}
        st = s.get("status") or {}
        budget = st.get("budgetRemaining")
        rows.append([
            f"{meta.get('namespace', 'default')}/{meta.get('name', '')}",
            str(spec.get("objective", "")),
            f"{spec.get('target', 0):g}",
            f"{int(spec.get('windowSeconds', 3600))}s",
            f"{budget:.4f}" if isinstance(budget, (int, float)) else "-",
            _burn(st.get("burnRateFast"), FAST_BURN_THRESHOLD),
            _burn(st.get("burnRateSlow"), SLOW_BURN_THRESHOLD),
        ])
    _print_table(rows, ["SLO", "OBJECTIVE", "TARGET", "WINDOW",
                        "BUDGET", "BURN-FAST", "BURN-SLOW"])
    rule_rows = _alert_rows([st for s in slos
                             for st in s.get("rules", [])])
    if rule_rows:
        print()
        _print_table(rule_rows, ["RULE", "SEVERITY", "STATE", "VALUE",
                                 "EXPR"])
    return 1 if paging else 0


def _print_usage(rows: List[dict], window: float,
                 as_json: bool = False) -> int:
    """Render the /usage payload (shared by local and remote `kfx
    usage`): top consumers over the window with a per-row sparkline
    of token increases, plus the exact cumulative ledger totals."""
    if as_json:
        print(json.dumps({"usage": rows, "windowSeconds": window},
                         indent=1))
        return 0
    if not rows:
        print("no tenant usage recorded (kfx_tenant_tokens_total is "
              "empty — is a model serving traffic?)")
        return 1
    table = []
    for r in rows:
        pts = [v for _, v in (r.get("points") or [])]
        table.append([
            r["tenant"], r["qos"], r["adapter"],
            f"{r['windowTokens']:.0f}", f"{r['windowRequests']:.0f}",
            f"{r['promptTokens']:.0f}", f"{r['generatedTokens']:.0f}",
            f"{r['totalTokens']:.0f}",
            _sparkline(pts, width=16) if pts else "",
        ])
    print(f"tenant usage over the last {window:g}s "
          f"(totals are exact cumulative ledger counts):")
    _print_table(table, ["TENANT", "QOS", "ADAPTER", f"TOK/{window:g}s",
                         "REQS", "PROMPT", "GENERATED", "TOTAL",
                         "TREND"])
    return 0


def _print_rollouts(isvcs) -> int:
    from .serving.autoscaler import ROLLBACK_ANNOTATION

    rows, notes = [], []
    for isvc in isvcs:
        ro = isvc.status.get("rollout")
        if ro is None:
            continue
        p99 = ro.get("p99Ms")
        err = ro.get("errorRate")
        rows.append([
            isvc.name, isvc.namespace, f"{ro.get('percent', 0)}%",
            str(ro.get("phase", "")),
            f"{p99:.1f}" if isinstance(p99, (int, float)) else "-",
            f"{err:.2%}" if isinstance(err, (int, float)) else "-",
            str(ro.get("observed", "-"))])
        verdict = isvc.metadata.annotations.get(ROLLBACK_ANNOTATION)
        if verdict:
            notes.append(f"{isvc.name}: rolled back — {verdict}")
    if not rows:
        print("no InferenceService with an active rollout")
        return 0
    _print_table(rows, ["NAME", "NAMESPACE", "CANARY%", "PHASE",
                        "P99_MS", "ERR_RATE", "OBSERVED"])
    for note in notes:
        print(note)
    return 0


def _print_queue(running, queued) -> int:
    """The `kfx queue` table body, shared by the local and remote
    paths (which differ only in where the job rows come from)."""
    rows = [[r.name, r.kind, r.namespace, str(r.priority),
             str(r.chips), r.state, r.detail] for r in running + queued]
    if not rows:
        print("no active or queued training jobs")
        return 0
    _print_table(rows, ["NAME", "KIND", "NAMESPACE", "PRIO", "CHIPS",
                        "STATE", "DETAIL"])
    return 0


def _store_jobs(cp):
    for kind in _training_kinds():
        for job in cp.store.list(kind):
            yield kind, job


def _capacity_summary(capacity: int, reserved: int, queued: int) -> str:
    free = max(capacity - reserved, 0)
    return (f"slice: capacity={capacity} chips  reserved={reserved}  "
            f"free={free}  queued={queued}")


def _training_kinds() -> List[str]:
    from .api.base import registered_kinds

    out = []
    for kind in registered_kinds():
        try:
            if issubclass(resource_class(kind), TrainingJob):
                out.append(kind)
        except KeyError:
            continue
    return out


def _telemetry_cells(text: str) -> List[str]:
    """[step, loss, step_time, rate] display cells from a chief log tail
    (shared by local and remote `kfx top`)."""
    from .hpo.collector import parse_metrics_text

    wanted = ["step", "loss", "step_time",
              "examples_per_sec", "tokens_per_s"]
    latest = {}
    for ob in parse_metrics_text(text, wanted):
        latest[ob["name"]] = ob["value"]
        latest["step"] = ob["step"]

    def fmt(key, spec="{:.4g}"):
        v = latest.get(key)
        return spec.format(v) if v is not None else "-"

    rate = latest.get("tokens_per_s", latest.get("examples_per_sec"))
    return [str(int(latest.get("step", 0))) if latest else "-",
            fmt("loss"), fmt("step_time"),
            "{:.1f}".format(rate) if rate is not None else "-"]


def _print_top(rows: List[List[str]]) -> int:
    if not rows:
        print("no training jobs")
        return 0
    _print_table(rows, ["NAME", "KIND", "NAMESPACE", "STATE", "STEP",
                        "LOSS", "STEP_TIME", "EX_OR_TOK/S"])
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="kfx",
                                description="ML platform CLI (the PyTorch/CUDA port)")
    p.add_argument("--home", default=None,
                   help=f"state dir (default {default_home()})")
    p.add_argument("-n", "--namespace", default="default")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("apply", help="apply resource manifests")
    sp.add_argument("-f", "--filename", action="append", required=True)
    sp.add_argument("--wait", action="store_true",
                    help="wait for training jobs to finish")
    sp.add_argument("--timeout", type=float, default=3600.0)

    sp = sub.add_parser("run", help="apply + wait + stream logs")
    sp.add_argument("-f", "--filename", action="append", required=True)
    sp.add_argument("--timeout", type=float, default=3600.0)
    sp.add_argument("--no-follow", action="store_true")

    sp = sub.add_parser("get", help="list/get resources")
    sp.add_argument("kind")
    sp.add_argument("name", nargs="?")
    sp.add_argument("-o", "--output", choices=["table", "json", "yaml"],
                    default="table")

    sp = sub.add_parser("describe", help="full resource + events")
    sp.add_argument("kind")
    sp.add_argument("name")

    sp = sub.add_parser("delete", help="delete a resource (or every "
                                       "resource in manifest files)")
    sp.add_argument("kind", nargs="?")
    sp.add_argument("name", nargs="?")
    sp.add_argument("-f", "--filename", action="append", default=[],
                    help="delete everything a manifest (or KfDef) "
                         "renders, in reverse apply order — the kfctl "
                         "delete model")

    sp = sub.add_parser("logs", help="print replica logs")
    sp.add_argument("kind")
    sp.add_argument("name")
    sp.add_argument("--replica", default="",
                    help="replica id, e.g. worker-1 (default: chief)")

    sp = sub.add_parser("events", help="print resource events")
    sp.add_argument("kind")
    sp.add_argument("name")

    sp = sub.add_parser(
        "trace", help="cross-process span waterfall for a submission "
                      "(merged from the plane's and replicas' span logs)")
    sp.add_argument("kind")
    sp.add_argument("name")
    sp.add_argument("--format", choices=["ascii", "chrome"],
                    default="ascii",
                    help="chrome = Perfetto-loadable trace-event JSON")
    sp.add_argument("-o", "--output", default="",
                    help="write to a file instead of stdout")
    sp.add_argument("--since", type=float, default=0.0,
                    help="only spans still live in the last N seconds "
                         "(0 = no time filter)")
    sp.add_argument("--min-ms", type=float, default=0.0,
                    help="drop spans shorter than this many ms")
    sp.add_argument("--tenant", default="",
                    help="only spans whose tenant attribute matches "
                         "(router.dispatch / serving.generate stamp "
                         "the billable tenant)")

    sp = sub.add_parser("top", help="live training telemetry (latest "
                                    "step/loss/throughput per job)")
    sp.add_argument("--watch", type=float, default=0.0, metavar="N",
                    help="refresh every N seconds (rate columns are "
                         "true window rates from the telemetry store)")
    sp.add_argument("--window", type=float, default=30.0,
                    help="rate-column window in seconds (default 30)")

    sp = sub.add_parser(
        "query", help="windowed telemetry query against the central "
                      "scrape store (rate/delta/pNN/max over history)")
    sp.add_argument("family", help="metric family, e.g. "
                                   "kfx_router_requests_total")
    sp.add_argument("--fn", default="latest",
                    choices=["latest", "rate", "delta", "max", "min",
                             "avg", "p50", "p90", "p99"])
    sp.add_argument("-l", "--labels", default="",
                    help="label selector, e.g. isvc=fleet,code=5xx")
    sp.add_argument("--since", type=float, default=60.0,
                    help="window in seconds (default 60)")
    sp.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the raw result dict (rc unchanged)")

    sp = sub.add_parser("alerts", help="alert-rule states (pending/"
                                       "firing/resolved ride "
                                       "kind=Alert events)")
    sp.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the raw state list (rc still 1 while "
                         "anything fires)")

    sp = sub.add_parser(
        "slo", help="error-budget dashboard: every SLO's remaining "
                    "budget, burn rates, and generated rule states")
    sp.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the raw payload (rc still 1 while any "
                         "fast-burn rule fires)")

    sp = sub.add_parser(
        "usage", help="per-tenant usage: fleet-aggregated token/"
                      "request ledger, top consumers first")
    sp.add_argument("--tenant", default="",
                    help="only this tenant's rows")
    sp.add_argument("--window", type=float, default=3600.0,
                    help="trailing window in seconds (default 3600; "
                         "long windows read the downsampled tier)")
    sp.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the raw row list")

    sp = sub.add_parser(
        "postmortem", help="list an InferenceService's postmortem "
                           "bundles and render the newest flight ring "
                           "(stalled iteration marked)")
    sp.add_argument("name")
    sp.add_argument("-n", "--namespace", default="default")
    sp.add_argument("--bundle", default="",
                    help="render this bundle dir instead of the newest")

    sp = sub.add_parser(
        "flight", help="render the live flight-recorder snapshots of "
                       "an InferenceService's replicas (workdir files "
                       "refreshed on every liveness probe)")
    sp.add_argument("name")
    sp.add_argument("-n", "--namespace", default="default")

    sub.add_parser("queue", help="gang-scheduler state: slice capacity, "
                                 "running gangs (incl. serving "
                                 "reservations), and the priority-"
                                 "ordered wait queue")

    sp = sub.add_parser(
        "rollout", help="canary rollout state per InferenceService "
                        "(traffic percent, phase, last SLO observation)")
    sp.add_argument("name", nargs="?")

    sp = sub.add_parser("kill-replica", help="fault injection: kill a replica")
    sp.add_argument("kind")
    sp.add_argument("name")
    sp.add_argument("replica")

    sp = sub.add_parser(
        "profile", help="capture a torch.profiler trace from a running job")
    sp.add_argument("kind")
    sp.add_argument("name")
    sp.add_argument("--replica", default="",
                    help="replica id, e.g. worker-1 (default: chief-0)")
    sp.add_argument("--duration-ms", type=int, default=2000)
    sp.add_argument("--logdir", default="",
                    help="output dir (default <job workdir>/profiler/traces)")

    sp = sub.add_parser("server", help="run the persistent control plane")
    sp.add_argument("--port", type=int, default=8134)

    sp = sub.add_parser("init", help="scaffold a KfDef platform config")
    sp.add_argument("name")
    sp.add_argument("-o", "--output", default="kfdef.yaml")
    sp.add_argument("--platform-namespace", default=None)

    sp = sub.add_parser(
        "generate", help="render a KfDef to per-resource manifests")
    sp.add_argument("-f", "--filename", required=True)
    sp.add_argument("-o", "--output", default="manifests")

    sub.add_parser("version", help="print version")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    try:
        return _main(argv)
    except SystemExit:
        raise
    except (KeyboardInterrupt, BrokenPipeError):  # pragma: no cover
        return 130
    except Exception as e:  # surface clean one-line errors, not tracebacks
        import yaml

        from .api.base import ValidationError
        from .core.store import AlreadyExists, Conflict, NotFound

        if isinstance(e, (ValidationError, NotFound, Conflict, AlreadyExists,
                          KeyError, FileNotFoundError, TimeoutError,
                          yaml.YAMLError)):
            msg = e.args[0] if e.args else str(e)
            print(f"error: {msg}", file=sys.stderr)
            return 1
        raise


def _main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "version":
        from . import __version__

        print(f"kfx {__version__}")
        return 0
    if args.cmd == "init":
        from .kfctl import init_scaffold

        if os.path.exists(args.output):
            print(f"error: {args.output} already exists", file=sys.stderr)
            return 1
        with open(args.output, "w") as f:
            f.write(init_scaffold(args.name, args.platform_namespace))
        print(f"wrote {args.output}")
        return 0
    if args.cmd == "generate":
        from .kfctl import generate

        for p in generate(args.filename, args.output):
            print(p)
        return 0
    _REMOTE_VERBS = ("apply", "run", "get", "describe", "delete", "logs",
                     "events", "top", "queue", "rollout", "query",
                     "alerts", "slo", "usage")
    if os.environ.get("KFX_SERVER") and args.cmd in _REMOTE_VERBS:
        return _remote_main(args)
    if os.environ.get("KFX_SERVER") and args.cmd in ("trace",
                                                     "postmortem",
                                                     "flight"):
        # Falling through to a local passive plane would diagnose "not
        # found" against the LOCAL home while the job lives on the
        # server — a misleading answer. Span files, postmortem bundles
        # and flight snapshots are host-local; run the verb where the
        # server's home is.
        print(f"error: `kfx {args.cmd}` reads files from the server's "
              f"home on its own host and is not supported in "
              f"KFX_SERVER client mode; run it on the host of "
              f"{os.environ['KFX_SERVER']} (unset KFX_SERVER there)",
              file=sys.stderr)
        return 1
    if args.cmd == "server":
        try:
            from .apiserver import serve_forever
        except ImportError:
            print("error: server mode is not available in this build",
                  file=sys.stderr)
            return 1
        return serve_forever(home=args.home, port=args.port)

    # A running `kfx server` owns its home: its in-memory store, watches
    # and gangs are authoritative, and a local-mode mutation (apply /
    # delete) against the same sqlite would silently diverge — the server
    # never observes it, and its next status write resurrects the row.
    # Detect the owner (health-checked marker it wrote at startup) and
    # route through it.
    server_url = _detect_server(args.home)
    if server_url is not None:
        if args.cmd in _REMOTE_VERBS:
            print(f"note: routing through the running kfx server at "
                  f"{server_url} (it owns this home)", file=sys.stderr)
            return _remote_main(args, url=server_url)
        if args.cmd == "kill-replica":
            print(f"error: this home is owned by the kfx server at "
                  f"{server_url}; kill-replica must run in the owning "
                  f"process (its gangs are not visible here)",
                  file=sys.stderr)
            return 1
        # profile is read-only cross-process (profiler ports are
        # advertised on disk) and safe to run locally.

    # Verbs that don't launch work must never reconcile: a second control
    # plane on the same home would adopt Running jobs and spawn duplicate
    # gangs next to their owner. kill-replica only acts on gangs this
    # process owns; delete without a live server is store-only and the
    # finished/ownerless gang case is the only one left after the routing
    # above.
    passive = args.cmd in ("get", "describe", "logs", "events", "profile",
                           "delete", "kill-replica", "top", "trace",
                           "queue", "rollout", "query", "alerts",
                           "slo", "usage", "postmortem", "flight")
    try:
        plane = ControlPlane(home=args.home, journal=True, passive=passive)
    except HomeBusy:
        # Owner without a marker (e.g. another local `kfx run`, or a
        # server that hasn't finished startup): refuse rather than
        # reconcile the same sqlite twice.
        print("error: this home's reconcile loops are owned by another "
              "live kfx process; re-run when it exits, or start a "
              "`kfx server` and use client mode", file=sys.stderr)
        return 1
    with plane as cp:
        cli = KfxCLI(cp)
        if args.cmd == "apply":
            if args.wait:
                return cli.run(args.filename, args.timeout, follow=False)
            applied = cli.apply(args.filename)
            # Without a persistent server, fire-and-forget gangs would die
            # with this process; wait for the work applied HERE (not
            # suspended ones, not leftovers from prior invocations).
            # Experiments count: exiting mid-sweep would strand trials
            # Pending with no control plane to reconcile them.
            jobs = []
            for o in applied:
                if isinstance(o, TrainingJob):
                    if o.is_finished() or o.run_policy().suspend:
                        continue
                elif o.KIND not in ("Experiment", "Pipeline"):
                    continue
                jobs.append(o)
            if jobs:
                print("note: no kfx server running; waiting for "
                      "applied jobs (use `kfx run` or `kfx server`)")
                return _wait_jobs(cli, jobs, args.timeout)
            return 0
        if args.cmd == "run":
            return cli.run(args.filename, args.timeout,
                           follow=not args.no_follow)
        if args.cmd == "get":
            return cli.get(args.kind, args.name, args.namespace, args.output)
        if args.cmd == "describe":
            return cli.describe(args.kind, args.name, args.namespace)
        if args.cmd == "delete":
            if args.filename:
                return cli.delete_files(args.filename)
            if not (args.kind and args.name):
                print("error: delete needs KIND NAME or -f FILE",
                      file=sys.stderr)
                return 2
            return cli.delete(args.kind, args.name, args.namespace)
        if args.cmd == "logs":
            return cli.logs(args.kind, args.name, args.namespace, args.replica)
        if args.cmd == "events":
            return cli.events(args.kind, args.name, args.namespace)
        if args.cmd == "trace":
            return cli.trace(args.kind, args.name, args.namespace,
                             args.format, args.output,
                             since_s=args.since, min_ms=args.min_ms,
                             tenant=args.tenant)
        if args.cmd == "top":
            return cli.top(watch=args.watch, window_s=args.window)
        if args.cmd == "query":
            return cli.query(args.family, args.fn, args.labels,
                             args.since, as_json=args.as_json)
        if args.cmd == "alerts":
            return cli.alerts(as_json=args.as_json)
        if args.cmd == "slo":
            return cli.slo(as_json=args.as_json)
        if args.cmd == "usage":
            return cli.usage(tenant=args.tenant, window=args.window,
                             as_json=args.as_json)
        if args.cmd == "postmortem":
            return cli.postmortem(args.name, args.namespace,
                                  bundle=args.bundle)
        if args.cmd == "flight":
            return cli.flight(args.name, args.namespace)
        if args.cmd == "queue":
            return cli.queue()
        if args.cmd == "rollout":
            return cli.rollout(args.name, args.namespace)
        if args.cmd == "kill-replica":
            return cli.kill_replica(args.kind, args.name, args.namespace,
                                    args.replica)
        if args.cmd == "profile":
            return cli.profile(args.kind, args.name, args.namespace,
                               args.replica, args.duration_ms, args.logdir)
    return 0


def _delete_rendered(paths: List[str], delete) -> int:
    """Shared `delete -f` engine (local store and remote client modes):
    expand each manifest/KfDef, normalize kinds through the registry —
    the apply path accepts lowercase/plural spellings, so delete must
    too, or a `kind: jaxjob` manifest would "delete" nothing while
    reporting success — and remove in reverse apply order.
    ``delete(kind, name, ns) -> bool`` returns False for already-gone."""
    from .kfctl import expand_manifest_file

    docs: List[dict] = []
    for path in paths:
        docs.extend(expand_manifest_file(path))
    for doc in reversed(docs):
        raw_kind = str(doc.get("kind", ""))
        try:
            kind = resource_class(raw_kind).KIND
        except KeyError:
            print(f"{raw_kind.lower()}: unknown kind, skipped")
            continue
        meta = doc.get("metadata") or {}
        name = str(meta.get("name", ""))
        ns = str(meta.get("namespace", "default"))
        if delete(kind, name, ns):
            print(f"{kind.lower()}/{name} deleted")
        else:
            print(f"{kind.lower()}/{name} not found (already gone)")
    return 0


def _dict_state(obj: dict) -> str:
    from .api.base import display_state

    return display_state(obj.get("status", {}).get("conditions", []))


def _same_server(a: str, b: str) -> bool:
    """URL equivalence for the admin-token gate: canonical scheme/host
    (lowercased, default ports filled) and path. No DNS — `localhost`
    vs `127.0.0.1` intentionally does NOT match (fail closed; the
    withheld-token note tells the user which spelling the marker has).
    """
    from urllib.parse import urlsplit

    def canon(u):
        s = urlsplit(u if "//" in u else f"//{u}", scheme="http")
        port = s.port or {"http": 80, "https": 443}.get(s.scheme, 0)
        return (s.scheme.lower(), (s.hostname or "").lower(), port,
                s.path.rstrip("/"))

    try:
        return canon(a) == canon(b)
    except ValueError:
        return False


def _detect_server(home: Optional[str]) -> Optional[str]:
    """URL of a live `kfx server` owning this home, else None."""
    try:
        from .apiserver import live_server_url
    except ImportError:
        return None
    return live_server_url(resolve_home(home))


def _remote_main(args, url: Optional[str] = None) -> int:
    """Thin-client mode: KFX_SERVER points at a running `kfx server`
    (or one was detected owning the home); state and gangs live there
    (the kubectl model — see apiserver)."""
    import urllib.error

    from .apiserver import SERVER_MARKER, ApiError, Client, read_admin_token

    url = url or os.environ["KFX_SERVER"]
    # Local possession of the home's 0600 token file == cluster-admin —
    # but only toward the server that OWNS this home. Sending it to an
    # arbitrary KFX_SERVER would hand the credential to whoever runs
    # that endpoint (cleartext HTTP). Trust derives from the FILESYSTEM,
    # never from the endpoint's own responses (a malicious server could
    # simply echo the guessable home path): the flock-holding owner
    # writes its URL into the home's server.json marker, and the token
    # rides along only when KFX_SERVER matches that marker. Mismatch
    # (incl. no marker) fails closed — requests still go out, just
    # unprivileged.
    home = resolve_home(getattr(args, "home", None))
    token = read_admin_token(home)
    if token:
        marker_url = None
        try:
            with open(os.path.join(home, SERVER_MARKER)) as f:
                marker_url = json.load(f).get("url")
        except (OSError, ValueError):
            pass
        if not marker_url or not _same_server(marker_url, url):
            # Visible, because the symptom downstream is otherwise an
            # unexplained 403 on admin surfaces.
            print(f"note: admin token withheld — KFX_SERVER {url!r} does "
                  f"not match this home's server marker "
                  f"({marker_url!r}); requests proceed unprivileged",
                  file=sys.stderr)
            token = None
    client = Client(url, admin_token=token)
    try:
        return _remote_dispatch(client, args)
    except ApiError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except (urllib.error.URLError, ConnectionError, TimeoutError) as e:
        reason = getattr(e, "reason", e)
        print(f"error: cannot reach kfx server at {url}: {reason} "
              f"(is `kfx server` running? unset KFX_SERVER for local mode)",
              file=sys.stderr)
        return 1


def _remote_dispatch(client, args) -> int:
    if args.cmd in ("apply", "run"):
        import yaml

        from .kfctl import expand_manifest_file

        applied = []
        for path in args.filename:
            # KfDef expands client-side (kfctl model); the server receives
            # plain rendered resources.
            text = "---\n".join(
                yaml.safe_dump(d, sort_keys=False)
                for d in expand_manifest_file(path))
            for item in client.apply_text(text):
                print(f"{item['kind'].lower()}/{item['name']} "
                      f"{item['verb']}")
                applied.append(item)
        wait = args.cmd == "run" or getattr(args, "wait", False)
        if not wait:
            return 0
        follow = args.cmd == "run" and not getattr(args, "no_follow", False)
        return _remote_wait(client, applied, args.timeout, follow)
    if args.cmd == "get":
        if args.name:
            objs = [client.get(args.kind, args.namespace, args.name)]
        else:
            objs = client.list(args.kind, args.namespace)
        if args.output == "json":
            print(json.dumps(objs[0] if args.name else objs, indent=2))
        elif args.output == "yaml":
            import yaml

            print("---\n".join(yaml.safe_dump(o, sort_keys=False)
                               for o in objs), end="")
        else:
            rows = [[o["metadata"]["name"], _dict_state(o),
                     str(o.get("status", {}).get("restartCount", 0)),
                     _fmt_age(o["metadata"].get("creationTimestamp", ""))]
                    for o in objs]
            headers = ["NAME", "STATE", "RESTARTS", "AGE"]
            if any(o.get("status", {}).get("pooledModels") for o in objs):
                # Same POOLED column the embedded path renders —
                # thin-client mode is how a live plane is queried.
                headers.append("POOLED")
                for row, o in zip(rows, objs):
                    row.append(_fmt_pooled(
                        o.get("status", {}).get("pooledModels") or {}))
            _print_table(rows, headers)
        return 0
    if args.cmd == "describe":
        import yaml

        obj = client.get(args.kind, args.namespace, args.name)
        print(yaml.safe_dump(obj, sort_keys=False), end="")
        events = client.events(args.kind, args.namespace, args.name)
        if events:
            print("events:")
            for e in events:
                print(f"  {e['timestamp']} {e['type']} {e['reason']}: "
                      f"{e['message']}")
        return 0
    if args.cmd == "delete":
        if getattr(args, "filename", None):
            from .apiserver import ApiError

            def delete(kind: str, name: str, ns: str) -> bool:
                try:
                    client.delete(kind, ns, name)
                    return True
                except ApiError as e:
                    if e.status != 404:
                        raise
                    return False

            return _delete_rendered(args.filename, delete)
        if not (args.kind and args.name):
            print("error: delete needs KIND NAME or -f FILE",
                  file=sys.stderr)
            return 2
        client.delete(args.kind, args.namespace, args.name)
        print(f"{args.kind.lower()}/{args.name} deleted")
        return 0
    if args.cmd == "logs":
        print(client.logs(args.kind, args.namespace, args.name,
                          args.replica), end="")
        return 0
    if args.cmd == "events":
        for e in client.events(args.kind, args.namespace, args.name):
            trace = f" [trace={e['traceId']}]" if e.get("traceId") else ""
            print(f"{e['timestamp']} {e['type']} {e['reason']}: "
                  f"{e['message']}{trace}")
        return 0
    if args.cmd == "top":
        from .apiserver import ApiError

        watch = getattr(args, "watch", 0.0)
        window = getattr(args, "window", 30.0)
        while True:
            print(_remote_capacity_summary(client))
            rows = []
            for kind in _training_kinds():
                for o in client.list(kind):
                    ns = o["metadata"].get("namespace", "default")
                    name = o["metadata"]["name"]
                    try:
                        # Tail: don't download whole logs for a few
                        # lines.
                        text = client.logs_tail(kind, ns, name)
                    except ApiError:
                        text = ""
                    rows.append([name, kind, ns, _dict_state(o)]
                                + _telemetry_cells(text))
            rc = _print_top(rows)
            _print_serving_top(_serving_top_rows(
                _remote_isvcs(client),
                rates_fn=_remote_rates_fn(client, window)))
            if watch <= 0:
                return rc
            try:
                time.sleep(watch)
            except KeyboardInterrupt:
                return rc
            print(f"\n--- kfx top (refresh every {watch:g}s, rates "
                  f"over {window:g}s) ---")
    if args.cmd == "query":
        from .apiserver import ApiError

        try:
            return _print_query(client.query(
                args.family, args.fn,
                _selector_dict(args.labels), args.since),
                as_json=args.as_json)
        except (ApiError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    if args.cmd == "alerts":
        return _print_alerts(client.alerts(), as_json=args.as_json)
    if args.cmd == "slo":
        return _print_slos(client.slos(), as_json=args.as_json)
    if args.cmd == "usage":
        return _print_usage(client.usage(args.tenant or None,
                                         args.window),
                            args.window, as_json=args.as_json)
    if args.cmd == "queue":
        print(_remote_capacity_summary(client))
        running, queued = _slice_state(_remote_jobs(client))
        return _print_queue(
            running + _serving_slice_rows(_remote_isvcs(client)), queued)
    if args.cmd == "rollout":
        if args.name:
            isvcs = [client.get("InferenceService", args.namespace,
                                args.name)]
        else:
            isvcs = client.list("InferenceService", args.namespace)
        from .api.base import from_manifest

        return _print_rollouts([from_manifest(o) for o in isvcs])
    raise AssertionError(f"unhandled remote cmd {args.cmd}")


def _remote_jobs(client):
    """(kind, Resource) pairs rebuilt from the server's dicts, so the
    remote `kfx queue` shares the local view's derivation exactly."""
    from .api.base import from_manifest

    for kind in _training_kinds():
        for o in client.list(kind):
            try:
                yield kind, from_manifest(o)
            except Exception:
                continue


def _remote_isvcs(client):
    """InferenceService resources rebuilt from the server's dicts (the
    remote serving rows share the local derivation)."""
    from .api.base import from_manifest

    out = []
    try:
        for o in client.list("InferenceService"):
            try:
                out.append(from_manifest(o))
            except Exception:
                continue
    except Exception:
        pass
    return out


def _remote_capacity_summary(client) -> str:
    try:
        sched = client.metrics_json().get("sched") or {}
    except Exception:
        sched = {}
    capacity = int(sched.get("capacity") or 0)
    reserved = int(sched.get("reserved") or 0)
    return _capacity_summary(capacity, reserved,
                             int(sched.get("queued") or 0))


def _remote_wait(client, applied: List[dict], timeout: float,
                 follow: bool) -> int:
    from .apiserver import ApiError

    rc = 0
    for item in applied:
        kind, ns, name = item["kind"], item["namespace"], item["name"]
        try:
            is_job = issubclass(resource_class(kind), TrainingJob)
        except KeyError:
            continue
        if not is_job and kind not in ("Experiment", "Pipeline"):
            continue
        deadline = time.monotonic() + timeout
        offset = 0
        state = "Pending"
        while time.monotonic() < deadline:
            obj = client.get(kind, ns, name)
            if follow and is_job:  # experiments have no chief log
                try:
                    text, offset = client.logs_from(kind, ns, name, "",
                                                    offset)
                except ApiError:
                    text = ""
                if text:
                    sys.stdout.write(text)
                    sys.stdout.flush()
            state = _dict_state(obj)
            if state in ("Succeeded", "Failed"):
                break
            time.sleep(0.3)
        else:
            raise SystemExit(f"timeout: {kind} {ns}/{name} still {state} "
                             f"after {timeout}s")
        print(f"{kind.lower()}/{name} {state.lower()}")
        if state != "Succeeded":
            rc = 1
    return rc


def _wait_jobs(cli: KfxCLI, jobs: List[Resource], timeout: float) -> int:
    return cli.wait_and_report(jobs, timeout)


if __name__ == "__main__":
    sys.exit(main())
