"""Deterministic fault injection (chaos) — named fault points, seeded.

Port of ``kubeflow_tpu/chaos/__init__.py``: the same API, spec grammar,
per-point streams and ``state=`` file format, so one spec and one seed
give the same decisions in both packages and a state file written by
one is read by the other.

The platform's whole claim (PAPER.md, SURVEY.md §5.3-5.4) is that gang
restarts resume from the latest checkpoint and serving degrades
gracefully. This module is what turns that claim into a regression-
tested property: sites across the stack declare *fault points*. The
port reaches the points marked ``*``; the rest belong to the control
plane and the router, which the port does not have yet (ROADMAP.md
Queue A 8), and a spec naming them parses but injects nothing here:

    gang.spawn          member spawn failure        (runtime/gang.py)
    gang.kill           supervisor kills a member   (runtime/gang.py)
  * rendezvous.delay    slow worker bootstrap       (runtime/rendezvous.py)
    store.read          store read error/latency    (core/store.py)
    store.write         store write error/latency   (core/store.py)
    workqueue.requeue   spurious requeue storm      (core/workqueue.py)
  * checkpoint.save     corrupt/partial write       (training/checkpoint.py)
  * checkpoint.restore  restore read error          (training/checkpoint.py)
    serving.request     router->backend failure     (serving/router.py)
    router.affinity     prefix-affinity miss +      (serving/router.py)
                        map eviction (degrades to
                        plain load balancing)
  * serving.predict     in-server predict failure   (serving/server.py)
  * engine.admit        LM decode-engine admission  (serving/engine.py)
                        failure/latency
  * engine.kv_alloc     KV page allocation fails    (serving/engine.py)
                        (503 + Retry-After)
  * engine.spec_verify  full-rejection verify wave  (serving/engine.py)
  * engine.kv_quant     int8 KV scale planes zeroed (serving/engine.py)
  * runner.crash        worker self-crash at a      (runners/jax_runner.py)
                        checkpoint boundary
    sched.preempt       scheduler preemption fails  (sched/scheduler.py)
                        to land (cycle aborts)
    autoscale.decide    autoscaler skips/stalls a   (operators/serving.py)
                        scale decision cycle
    serving.cold_start  scale-from-zero spawn is    (operators/serving.py)
                        delayed
  * engine.wedge        decode loop stalls with     (serving/engine.py)
                        slots active (liveness)
    replica.kill        SIGKILL a serving replica   (operators/serving.py)
                        mid-request
    router.stream_cut   sever an in-flight SSE      (serving/router.py)
                        token stream after >=1
                        relayed token
  * weights.load        artifact load fails/stalls  (serving/weights.py)
                        during a weight-pool swap

— and a *plan* decides, deterministically, which evaluations inject.

Determinism: one run seed; each point draws from its own
``random.Random(f"{seed}:{point}")`` stream, so the decision sequence
at a point depends only on the seed and that point's own evaluation
order — never on how other points interleave. With a ``state=`` file
the draw/injection counts persist across processes (gang restarts
re-exec workers), so ``count=N`` caps a whole run, and a restarted
worker fast-forwards its streams to where the dead one stopped.

Activation: programmatic (``install(plan)`` — tests) or the
``KFX_CHAOS`` env spec (inherited by gang members automatically):

    KFX_CHAOS="seed=7;state=/tmp/run/chaos.json;
               gang.kill:p=0.5,count=2;
               store.read:p=0.05,mode=delay,delay=0.2;
               checkpoint.save:mode=corrupt,after=1,count=1;
               serving.request:match=127.0.0.1:5001"

Entries are ``;``-separated. ``seed=N`` / ``state=PATH`` configure the
run; every other entry is ``<point>[:k=v[,k=v...]]`` with keys
``p`` (probability per draw, default 1), ``count`` (max injections,
default unlimited), ``after`` (skip the first N draws), ``delay``
(seconds slept on injection), ``mode`` (site-interpreted: ``error`` is
the default at failure sites, ``delay`` means latency-only,
``corrupt`` at checkpoint.save), ``match`` (substring the site's
target — backend endpoint, replica id — must contain).

Every injection increments ``kfx_chaos_injected_total{point}`` in the
process-default obs registry (servers re-export it via ``collect``),
prints a ``chaos_inject`` line stamped with the current trace ID, and
fans out to listeners (the control plane records a store event), so a
chaos run reads like any other job in ``kfx events``.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Callable, Dict, List, Optional

from ..obs import trace as obs_trace
from ..obs.metrics import MetricsRegistry, default_registry

__all__ = [
    "Rule", "ChaosPlan", "parse_spec", "install", "reset", "active_plan",
    "draw", "fail_or_delay", "maybe_delay", "collect", "add_listener",
    "remove_listener", "injected_counts", "KNOWN_POINTS",
]

# The fault-point catalog (docs/chaos.md). parse_spec validates against
# it: a typo'd point name would otherwise produce a chaos run that
# injects nothing and passes vacuously. Programmatic plans built from
# Rule objects directly stay unvalidated (custom/experimental points).
KNOWN_POINTS = frozenset({
    "gang.spawn", "gang.kill", "rendezvous.delay",
    "store.read", "store.write", "workqueue.requeue",
    "checkpoint.save", "checkpoint.restore",
    "serving.request", "serving.predict", "engine.admit",
    "engine.kv_alloc", "engine.spec_verify", "engine.kv_quant",
    "engine.adapter_load", "engine.wedge", "replica.kill",
    "router.affinity", "router.stream_cut",
    "runner.crash", "sched.preempt",
    "autoscale.decide", "serving.cold_start",
    "kv.transfer", "kv.offload", "weights.load",
})


class Rule:
    """One fault point's injection policy."""

    __slots__ = ("point", "p", "count", "after", "delay", "mode", "match")

    def __init__(self, point: str, p: float = 1.0,
                 count: Optional[int] = None, after: int = 0,
                 delay: float = 0.0, mode: str = "", match: str = ""):
        self.point = point
        self.p = p
        self.count = count
        self.after = after
        self.delay = delay
        self.mode = mode
        self.match = match

    def __repr__(self) -> str:  # pragma: no cover
        return (f"Rule({self.point!r}, p={self.p}, count={self.count}, "
                f"after={self.after}, delay={self.delay}, "
                f"mode={self.mode!r}, match={self.match!r})")


class ChaosPlan:
    """A seeded set of rules plus per-point draw/injection bookkeeping.

    ``state_path`` (optional) persists the bookkeeping as JSON so the
    same plan evaluated from several processes — the operator, gang
    members, their restarts — shares one global budget and one
    deterministic draw sequence per point."""

    def __init__(self, rules: List[Rule], seed: int = 0,
                 state_path: str = ""):
        self.seed = seed
        self.state_path = state_path
        self.rules: Dict[str, Rule] = {r.point: r for r in rules}
        self._lock = threading.Lock()
        # In-memory bookkeeping (authoritative when no state file).
        self._draws: Dict[str, int] = {}
        self._injected: Dict[str, int] = {}
        # {point: [rng, next-draw-index]} — incremental stream cursors.
        self._rngs: Dict[str, List] = {}

    # -- deterministic draws -------------------------------------------------
    def _rng_at(self, point: str, nth_draw: int) -> float:
        """The point's nth draw value. Streams are keyed seed:point; an
        in-memory cursor advances incrementally, and a state file that
        moved the cursor past it (another process drew) fast-forwards —
        exactly reproducible across processes either way."""
        entry = self._rngs.get(point)
        if entry is None or entry[1] > nth_draw:
            # No stream yet, or asked for an earlier index — a Mersenne
            # stream cannot rewind, so restart it.
            entry = self._rngs[point] = [
                random.Random(f"{self.seed}:{point}"), 0]
        rng, cursor = entry
        v = 0.0
        while cursor <= nth_draw:
            v = rng.random()
            cursor += 1
        entry[1] = cursor
        return v

    def draw(self, point: str, target: str = "") -> Optional[Rule]:
        """Evaluate the point once; the rule if this evaluation injects."""
        rule = self.rules.get(point)
        if rule is None:
            return None
        if rule.match and rule.match not in target:
            # Non-matching targets do not consume a draw: the stream
            # indexes *matching* evaluations, so a rule pinned to one
            # backend is unaffected by traffic to the others.
            return None
        with self._lock:
            if self.state_path:
                return self._draw_stateful(point, rule)
            n = self._draws.get(point, 0)
            self._draws[point] = n + 1
            if not self._decide(rule, n, self._injected.get(point, 0)):
                return None
            self._injected[point] = self._injected.get(point, 0) + 1
        return rule

    def _decide(self, rule: Rule, nth_draw: int, injected: int) -> bool:
        if nth_draw < rule.after:
            return False
        if rule.count is not None and injected >= rule.count:
            return False
        if rule.p >= 1.0:
            return True
        return self._rng_at(rule.point, nth_draw) < rule.p

    # -- cross-process state -------------------------------------------------
    def _draw_stateful(self, point: str, rule: Rule) -> Optional[Rule]:
        """One locked read-modify-write of the shared state file per
        draw. Chaos draws are rare; correctness beats throughput."""
        import fcntl

        lock_path = self.state_path + ".lock"
        with open(lock_path, "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                with open(self.state_path) as f:
                    state = json.load(f)
            except (OSError, ValueError):
                state = {}
            draws = state.setdefault("draws", {})
            injected = state.setdefault("injected", {})
            n = int(draws.get(point, 0))
            draws[point] = n + 1
            hit = self._decide(rule, n, int(injected.get(point, 0)))
            if hit:
                injected[point] = int(injected.get(point, 0)) + 1
            tmp = self.state_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(state, f)
            os.replace(tmp, self.state_path)
        return rule if hit else None

    def injected_counts(self) -> Dict[str, int]:
        if self.state_path:
            try:
                with open(self.state_path) as f:
                    return {k: int(v) for k, v in
                            json.load(f).get("injected", {}).items()}
            except (OSError, ValueError):
                return {}
        with self._lock:
            return dict(self._injected)


def parse_spec(spec: str) -> ChaosPlan:
    """Parse a ``KFX_CHAOS`` spec string (see module docstring grammar).
    Raises ValueError on malformed entries — a typo'd chaos spec must
    fail loudly, not silently run without faults."""
    seed = 0
    state_path = ""
    rules: List[Rule] = []
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        point, sep, params = entry.partition(":")
        point = point.strip()
        if not sep and "=" in point:
            k, _, v = point.partition("=")
            k, v = k.strip(), v.strip()
            if k == "seed":
                seed = int(v)
            elif k == "state":
                state_path = v
            else:
                raise ValueError(f"KFX_CHAOS: unknown run key {k!r}")
            continue
        kw: Dict[str, object] = {}
        for kv in params.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, eq, v = kv.partition("=")
            if not eq:
                raise ValueError(f"KFX_CHAOS: bad param {kv!r} in {entry!r}")
            k, v = k.strip(), v.strip()
            if k == "p":
                kw["p"] = float(v)
            elif k == "count":
                kw["count"] = int(v)
            elif k == "after":
                kw["after"] = int(v)
            elif k == "delay":
                kw["delay"] = float(v)
            elif k == "mode":
                kw["mode"] = v
            elif k == "match":
                kw["match"] = v
            else:
                raise ValueError(
                    f"KFX_CHAOS: unknown param {k!r} in {entry!r}")
        if point not in KNOWN_POINTS:
            raise ValueError(
                f"KFX_CHAOS: unknown fault point {point!r} "
                f"(known: {', '.join(sorted(KNOWN_POINTS))})")
        rules.append(Rule(point, **kw))  # type: ignore[arg-type]
    return ChaosPlan(rules, seed=seed, state_path=state_path)


# -- module-level activation (one plan per process) --------------------------

_lock = threading.Lock()
_installed: Optional[ChaosPlan] = None
_env_plan: Optional[ChaosPlan] = None
_env_spec: Optional[str] = None
_counts: Dict[str, int] = {}  # process-local injected totals, for export
_listeners: List[Callable[[str, Rule, str], None]] = []


def install(plan: Optional[ChaosPlan]) -> None:
    """Activate a programmatic plan (None deactivates). Takes precedence
    over the KFX_CHAOS env spec."""
    global _installed
    with _lock:
        _installed = plan


def reset() -> None:
    """Drop every active plan, cached env parse and injection count —
    test isolation."""
    global _installed, _env_plan, _env_spec
    with _lock:
        _installed = None
        _env_plan = None
        _env_spec = None
        _counts.clear()


def active_plan() -> Optional[ChaosPlan]:
    """The plan in force: the installed one, else a (cached) parse of
    KFX_CHAOS. Re-parses when the env var's value changes.

    The no-plan fast path is lock-free (one attribute read + one env
    lookup): this runs on every store CRUD, workqueue add and proxied
    request across all threads, and must not serialize them on a
    process-global mutex just to learn chaos is off. The unlocked reads
    are benign races — ``_env_spec`` is published AFTER ``_env_plan``,
    so a reader that observes the spec also observes its plan."""
    global _env_plan, _env_spec
    installed = _installed
    if installed is not None:
        return installed
    spec = os.environ.get("KFX_CHAOS", "")
    if not spec:
        return None
    if spec == _env_spec:
        return _env_plan
    with _lock:
        if spec != _env_spec:
            _env_plan = parse_spec(spec)
            _env_spec = spec
        return _env_plan


def add_listener(fn: Callable[[str, Rule, str, str], None]) -> None:
    """Register ``fn(point, rule, trace_id, span_id)`` called on every
    injection in this process (the control plane records a store event
    here, pinned to the span the injection happened inside)."""
    with _lock:
        _listeners.append(fn)


def remove_listener(fn: Callable[[str, Rule, str, str], None]) -> None:
    with _lock:
        if fn in _listeners:
            _listeners.remove(fn)


def draw(point: str, target: str = "") -> Optional[Rule]:
    """Evaluate ``point`` against the active plan. Returns the rule when
    this evaluation injects (recording the injection), else None. The
    no-plan fast path is one env lookup."""
    plan = active_plan()
    if plan is None:
        return None
    rule = plan.draw(point, target=target)
    if rule is None:
        return None
    _record(point, rule)
    return rule


def _record(point: str, rule: Rule) -> None:
    with _lock:
        _counts[point] = _counts.get(point, 0) + 1
        n = _counts[point]
        listeners = list(_listeners)
    default_registry().counter(
        "kfx_chaos_injected_total",
        "Chaos fault injections by fault point.").inc(1, point=point)
    trace = obs_trace.current_trace_id()
    span = obs_trace.current_span_id()
    print(f"chaos_inject point={point} n={n} mode={rule.mode or 'error'}"
          + (f" trace={trace}" if trace else "")
          + (f" span={span}" if span else ""), flush=True)
    for fn in listeners:
        try:
            fn(point, rule, trace, span)
        except Exception:
            pass  # observers never break the injected path


def fail_or_delay(point: str, exc_type: type, message: str,
                  target: str = "") -> None:
    """The standard failure-site helper: if the point injects, sleep the
    rule's delay and (unless ``mode=delay``) raise ``exc_type(message)``."""
    rule = draw(point, target=target)
    if rule is None:
        return
    if rule.delay > 0:
        time.sleep(rule.delay)
    if rule.mode != "delay":
        raise exc_type(f"chaos[{point}]: {message}")


def maybe_delay(point: str, default_s: float = 0.5,
                target: str = "") -> float:
    """Latency-site helper: sleep the rule's delay (or ``default_s``)
    when the point injects; returns the seconds slept."""
    rule = draw(point, target=target)
    if rule is None:
        return 0.0
    d = rule.delay if rule.delay > 0 else default_s
    time.sleep(d)
    return d


def injected_counts() -> Dict[str, int]:
    """Process-local injections by point (what ``collect`` exports)."""
    with _lock:
        return dict(_counts)


def collect(reg: MetricsRegistry) -> None:
    """Pull-time collector: mirror this process's injection totals into
    ``reg`` — lets per-component registries (control plane, model
    server) export kfx_chaos_injected_total alongside their own
    instruments."""
    counts = injected_counts()
    if not counts:
        return
    c = reg.counter("kfx_chaos_injected_total",
                    "Chaos fault injections by fault point.")
    for point, n in counts.items():
        c.set_total(n, point=point)
