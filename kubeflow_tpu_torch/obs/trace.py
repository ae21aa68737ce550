"""Request spans for the model server — the port's copy of the parts of
``kubeflow_tpu/obs/trace.py`` the server reaches.

  * a **trace** is one submission, identified by a 16-hex ID that
    callers pass in the ``X-Kfx-Trace-Id`` header (the server echoes it);
  * a **span** is one timed unit of work inside it — span_id, parent_id,
    wall-clock start, duration, ok/error status and string attributes;
    the server opens one per request, parented to the caller's
    ``X-Kfx-Span-Id`` header, and returns its id in the same header;
  * spans nest per thread, and finished spans append to a per-process
    JSONL file ``<KFX_WORKDIR>/spans/<component>-<pid>.jsonl`` in the
    reference's record format, so its ``obs.timeline`` merges the port's
    spans with its own. Without ``KFX_WORKDIR`` spans are dropped.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Dict, List, Optional

TRACE_ENV = "KFX_TRACE_ID"
TRACE_HEADER = "X-Kfx-Trace-Id"
SPAN_ENV = "KFX_SPAN_ID"
SPAN_HEADER = "X-Kfx-Span-Id"
COMPONENT_ENV = "KFX_COMPONENT"
SPANS_DIRNAME = "spans"

_tls = threading.local()


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def current_trace_id() -> str:
    """The calling thread's trace ID, falling back to the process env."""
    return getattr(_tls, "trace_id", "") or os.environ.get(TRACE_ENV, "")


def current_span_id() -> str:
    """The innermost open span on this thread, falling back to the
    process env (KFX_SPAN_ID) — what a child span parents to."""
    stack = getattr(_tls, "span_stack", None)
    if stack:
        return stack[-1].span_id
    return os.environ.get(SPAN_ENV, "")


class Span:
    """One timed unit of work under a trace ID."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start",
                 "duration", "status", "attrs", "_prev_trace")

    def __init__(self, name: str, trace_id: str, parent_id: str = "",
                 ts: Optional[float] = None,
                 attrs: Optional[Dict[str, str]] = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.start = time.time() if ts is None else ts
        self.duration = 0.0
        self.status = "ok"
        self.attrs: Dict[str, str] = dict(attrs or {})
        self._prev_trace = ""

    def to_record(self) -> Dict:
        rec = {"name": self.name, "trace": self.trace_id,
               "span": self.span_id, "parent": self.parent_id,
               "ts": self.start, "dur": self.duration,
               "status": self.status}
        if self.attrs:
            rec["attrs"] = self.attrs
        return rec


# -- the per-process span sink ------------------------------------------------

class _SpanSink:
    """Appends finished spans to ``<dir>/<component>-<pid>.jsonl``, one
    line-buffered JSON record each. Past the size cap
    (``KFX_SPAN_LOG_MAX_MB``, default 32) the file rotates to ``.1``, one
    generation kept, so a server writing a span per request stays within
    ~2x the cap."""

    DEFAULT_MAX_MB = 32
    ROTATE_CHECK_EVERY = 512

    def __init__(self, directory: str, component: str):
        self.directory = os.path.abspath(directory)
        self.component = component
        try:
            max_mb = float(os.environ.get("KFX_SPAN_LOG_MAX_MB", "") or
                           self.DEFAULT_MAX_MB)
        except ValueError:
            max_mb = float(self.DEFAULT_MAX_MB)
        self.max_bytes = max(int(max_mb * 1024 * 1024), 4096)
        self.path = os.path.join(self.directory,
                                 f"{component}-{os.getpid()}.jsonl")
        self._file = None
        self._lock = threading.Lock()
        self.written = 0

    def write(self, record: Dict) -> None:
        record = dict(record)
        record["proc"] = self.component
        record["pid"] = os.getpid()
        line = json.dumps(record, separators=(",", ":")) + "\n"
        with self._lock:
            if self._file is None:
                os.makedirs(self.directory, exist_ok=True)
                self._file = open(self.path, "a", buffering=1)
            self._file.write(line)
            self.written += 1
            if self.written % self.ROTATE_CHECK_EVERY == 0 and \
                    self._file.tell() > self.max_bytes:
                self._file.close()
                os.replace(self.path,
                           self.path[:-len(".jsonl")] + ".1.jsonl")
                self._file = open(self.path, "a", buffering=1)


_sink_lock = threading.Lock()
_sink: Optional[_SpanSink] = None
_sink_resolved = False
# {component: spans written} — what `collect` mirrors into
# kfx_spans_recorded_total.
_recorded: Dict[str, int] = {}


def default_component() -> str:
    """This process's component label: KFX_COMPONENT, else the replica
    env pair, else "proc"."""
    comp = os.environ.get(COMPONENT_ENV, "")
    if comp:
        return comp
    rtype = os.environ.get("KFX_REPLICA_TYPE", "")
    if rtype:
        idx = os.environ.get("KFX_REPLICA_INDEX", "0")
        return f"{rtype.lower()}-{idx}"
    return "proc"


def _resolve_sink() -> Optional[_SpanSink]:
    """The sink, configured once from KFX_WORKDIR (None without it)."""
    global _sink, _sink_resolved
    sink = _sink
    if sink is not None or _sink_resolved:
        return sink
    with _sink_lock:
        if _sink is None and not _sink_resolved:
            workdir = os.environ.get("KFX_WORKDIR", "")
            if workdir:
                _sink = _SpanSink(os.path.join(workdir, SPANS_DIRNAME),
                                  default_component())
            _sink_resolved = True
        return _sink


def _emit(sp: Span) -> None:
    sink = _resolve_sink()
    if sink is None:
        return
    try:
        sink.write(sp.to_record())
    except OSError:
        return  # tracing is an observer, never a failure path
    with _sink_lock:
        _recorded[sink.component] = _recorded.get(sink.component, 0) + 1


def collect(reg) -> None:
    """Pull-time collector: this process's span-write totals as
    ``kfx_spans_recorded_total{component=...}``."""
    with _sink_lock:
        counts = dict(_recorded)
    if not counts:
        return
    c = reg.counter("kfx_spans_recorded_total",
                    "Trace spans written to the span log by component.")
    for comp, n in counts.items():
        c.set_total(n, component=comp)


# -- span lifecycle -----------------------------------------------------------

def _stack() -> List[Span]:
    stack = getattr(_tls, "span_stack", None)
    if stack is None:
        stack = _tls.span_stack = []
    return stack


def start_span(name: str, trace_id: str = "", parent_id: str = "",
               **attrs: str) -> Span:
    """Open a span on the calling thread. Trace defaults to the current
    context (thread-local, then KFX_TRACE_ID); parent to the innermost
    open span (then KFX_SPAN_ID). Must be closed with finish_span."""
    tid = trace_id or current_trace_id()
    parent = parent_id or current_span_id()
    sp = Span(name, tid, parent_id=parent,
              attrs={k: str(v) for k, v in attrs.items()})
    sp._prev_trace = getattr(_tls, "trace_id", "")
    _tls.trace_id = tid
    _stack().append(sp)
    return sp


def finish_span(sp: Span, status: str = "") -> Span:
    """Close a span: stamp duration/status, restore the thread context,
    append it to the process span log."""
    sp.duration = max(time.time() - sp.start, 0.0)
    if status:
        sp.status = status
    stack = _stack()
    if sp in stack:
        # Pop through sp: a leaked inner span must not re-parent every
        # later span on this thread to itself forever.
        del stack[stack.index(sp):]
    _tls.trace_id = sp._prev_trace
    _emit(sp)
    return sp
