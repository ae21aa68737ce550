"""Flight recorder — the port's own copy of ``kubeflow_tpu/obs/
flightrec.py`` (which imports no JAX; the port imports nothing of the
reference package). Snapshot and request dicts keep the reference's
keys, so the reference's ``kfx flight`` reader parses the port's files.

A lock-light, always-on ring of per-iteration engine state plus a
per-request event trail, so the last seconds before a wedge/crash/
SIGKILL survive long enough to be read. Every field is host-side
bookkeeping: recording reads no tensor, so it adds no device sync.

The `DecodeEngine` loop appends exactly one fixed-shape record per
iteration (iteration id, timestamp, active/prefilling slots with
request ids, pages free in both KV pools, speculation counters,
iteration stall seconds, queue depth, preemption count) into a
bounded ring. Each `Request` accumulates a small event trail (admit,
prefill chunks, first token, preempt, retire); on retire the trail is
folded into a latency breakdown ``{queue_wait_s, prefill_s, decode_s,
stalled_s, spec_accept}`` and pushed into a bounded recent-requests
ring.

Concurrency contract: both rings are ``collections.deque`` with
``maxlen`` — CPython appends are atomic, so the single engine-loop
writer never takes a lock on the hot path, and snapshot readers (the
model server's HTTP threads, including the heartbeat path while the
loop is wedged) copy with ``list(deque)`` which is safe against a
concurrent append (worst case the copy misses/doubles one edge
record). Crucially the loop appends its record at the END of an
iteration — before ``_iterations`` advances — and the chaos wedge
stalls mid-iteration, so a wedged engine's ring is frozen at the last
completed iteration: exactly the forensic picture a postmortem wants.

Sizing: one record is a small dict (~10 keys, slot lists bounded by
``n_slots``); at the default 2048 records and 4 slots that is well
under 2 MB resident, and at a healthy ~100 iterations/s the ring
covers the last ~20 s of engine history. Tune with
``KFX_FLIGHT_RING`` / ``KFX_FLIGHT_RECENT``; ``KFX_FLIGHT=0``
disables recording entirely (the engine then skips every hook).
"""

from __future__ import annotations

import collections
import os
import time
from typing import List, Optional

DEFAULT_RING = 2048
DEFAULT_RECENT = 256
# Per-request event-trail cap: admit + first/retire + a bounded run of
# prefill-chunk / preempt entries. Long requests drop middle chunks
# rather than growing without bound.
MAX_EVENTS = 64


def enabled_from_env() -> bool:
    return os.environ.get("KFX_FLIGHT", "1") != "0"


def ring_size_from_env() -> int:
    try:
        return max(16, int(os.environ.get("KFX_FLIGHT_RING",
                                          str(DEFAULT_RING))))
    except ValueError:
        return DEFAULT_RING


def recent_size_from_env() -> int:
    try:
        return max(8, int(os.environ.get("KFX_FLIGHT_RECENT",
                                         str(DEFAULT_RECENT))))
    except ValueError:
        return DEFAULT_RECENT


class FlightRecorder:
    """One per engine. The engine loop is the only writer of the
    iteration ring; `retire()` runs on whichever thread finishes a
    request (loop thread for normal retirement, submitter threads for
    timeouts) — deque append keeps that safe without a lock."""

    def __init__(self, ring_size: Optional[int] = None,
                 recent_size: Optional[int] = None):
        self.ring_size = int(ring_size or ring_size_from_env())
        self.recent_size = int(recent_size or recent_size_from_env())
        self._ring = collections.deque(maxlen=self.ring_size)
        self._recent = collections.deque(maxlen=self.recent_size)
        self._t0 = time.monotonic()

    # ------------------------------------------------------------------
    # iteration ring (engine loop thread only)

    def record_iteration(self, iteration: int, active, prefilling,
                         pages_free: int, draft_pages_free: int,
                         spec_proposed: int, spec_accepted: int,
                         stall_s: float, queue_depth: int,
                         preemptions: int) -> None:
        self._ring.append({
            "it": int(iteration),
            "ts": time.monotonic(),
            "active": list(active),
            "prefilling": list(prefilling),
            "pages_free": int(pages_free),
            "draft_pages_free": int(draft_pages_free),
            "spec_proposed": int(spec_proposed),
            "spec_accepted": int(spec_accepted),
            "stall_s": round(float(stall_s), 6),
            "queue_depth": int(queue_depth),
            "preemptions": int(preemptions),
        })

    # ------------------------------------------------------------------
    # per-request trail

    @staticmethod
    def event(req, name: str, **extra) -> None:
        """Append one event to a request's trail (loop thread)."""
        ev = {"ev": name, "ts": time.monotonic()}
        if extra:
            ev.update(extra)
        trail = req.events
        if len(trail) >= MAX_EVENTS:
            # Keep admit + early chunks and the tail; drop the middle.
            if trail[-1].get("ev") == "dropped":
                trail[-1]["n"] += 1
                trail[-1]["ts"] = ev["ts"]
                return
            ev = {"ev": "dropped", "ts": ev["ts"], "n": 1}
        trail.append(ev)

    @staticmethod
    def timing(req) -> dict:
        """Latency breakdown for one request, computable at any point
        after retirement (and best-effort before)."""
        t_done = req.t_done or time.monotonic()
        t_admit = req.t_admitted or t_done
        t_first = req.t_first or t_done
        queue_wait = max(0.0, t_admit - req.t_enqueue)
        prefill = max(0.0, t_first - t_admit)
        decode = max(0.0, t_done - t_first)
        accept = (req.spec_acc / req.spec_prop) if req.spec_prop else None
        return {
            "queue_wait_s": round(queue_wait, 6),
            "prefill_s": round(prefill, 6),
            "decode_s": round(decode, 6),
            "stalled_s": round(float(req.stall_s), 6),
            "spec_accept": None if accept is None else round(accept, 4),
        }

    def retire(self, req) -> None:
        """Fold a finished request's trail into the recent-requests
        ring. Called from Request._finish — the single funnel every
        retirement path (normal, abort, drain, chaos, close) passes
        through."""
        entry = {
            "rid": req.rid,
            "tokens": len(req.tokens),
            "preempts": int(req.preempts),
            "error": str(req.error) if req.error else None,
            "t_enqueue": req.t_enqueue,
            "t_done": req.t_done,
            "timing": self.timing(req),
            "events": list(req.events),
        }
        self._recent.append(entry)

    # ------------------------------------------------------------------
    # read side (any thread)

    def __len__(self) -> int:
        return len(self._ring)

    def snapshot(self, heartbeat: Optional[dict] = None) -> dict:
        """The /debug/flight payload. list(deque) is atomic enough for
        a concurrent single appender; while wedged, appends have
        stopped entirely."""
        records = list(self._ring)
        out = {
            "ring_size": self.ring_size,
            "records": records,
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "snapshot_ts": time.time(),
            "snapshot_monotonic": time.monotonic(),
        }
        if heartbeat is not None:
            out["heartbeat"] = dict(heartbeat)
        return out

    def requests(self) -> dict:
        """The /debug/requests payload: recently retired requests,
        newest last."""
        return {
            "recent_size": self.recent_size,
            "requests": list(self._recent),
            "snapshot_ts": time.time(),
        }


def render_timeline(records: List[dict], heartbeat: Optional[dict] = None,
                    width: int = 72, tail: int = 30) -> str:
    """ASCII timeline of the flight ring: one line per iteration
    (newest `tail`), showing active/prefilling slots, pool fill, spec
    accept, and stall time; the final iteration is flagged when the
    heartbeat says the loop is wedged (appends stopped mid-iteration,
    so the last record IS the last completed tick before the stall).
    Shared by `kfx flight` and `kfx postmortem`."""
    if not records:
        return "(flight ring empty)"
    lines = []
    recs = records[-tail:]
    if len(records) > len(recs):
        lines.append(f"... {len(records) - len(recs)} earlier record(s)")
    t_last = recs[-1].get("ts", 0.0)
    max_free = max((r.get("pages_free", 0) for r in records), default=0) or 1
    wedged = bool(heartbeat and heartbeat.get("wedged"))
    for i, r in enumerate(recs):
        is_last = i == len(recs) - 1
        age = t_last - r.get("ts", t_last)
        slots = ",".join(f"s{s}:r{rid}" for s, rid in r.get("active", []))
        pre = ",".join(f"s{s}:r{rid}*" for s, rid in r.get("prefilling", []))
        busy = ";".join(x for x in (slots, pre) if x) or "-"
        fill = 1.0 - (r.get("pages_free", 0) / max_free)
        bar_w = 8
        bar = "#" * int(round(fill * bar_w))
        bar = (bar + "." * bar_w)[:bar_w]
        prop = r.get("spec_proposed", 0)
        acc = r.get("spec_accepted", 0)
        spec = f"spec {acc}/{prop}" if prop else "spec -"
        stall = r.get("stall_s", 0.0)
        mark = ""
        if is_last and wedged:
            mark = "  <== WEDGED after this iteration (loop stalled, " \
                   f"{heartbeat.get('stalled_s', 0):.1f}s)"
        lines.append(
            f"it {r.get('it', 0):>8}  -{age:6.2f}s  kv[{bar}] "
            f"q={r.get('queue_depth', 0):<3} "
            f"stall={stall:6.3f}s  {spec:<14} {busy}{mark}")
    if wedged:
        hb = heartbeat or {}
        lines.append(
            f"heartbeat: wedged=true iterations={hb.get('iterations')} "
            f"stalled_s={hb.get('stalled_s')} busy={hb.get('busy')} "
            f"compiling={hb.get('compiling')}")
    return "\n".join(lines)
