"""A profiled stretch of a run: the device's operations from
``torch.profiler`` (CUPTI), reduced to busy time, per-kernel sums, the
top operations and the longest idle gaps.

Only the CUDA activity is recorded (no host ops), which keeps the trace
small and its stop short. The trace is exported as Chrome JSON into the
run's temporary directory, read, and deleted.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class DeviceTrace:
    def __init__(self, tmpdir: str):
        self.tmpdir = tmpdir
        self._prof = None
        self.t_start = self.t_stop = 0.0
        self.events: List[Tuple[str, float, float]] = []  # name, ts, dur (us)

    def start(self) -> None:
        import torch

        torch.cuda.synchronize()
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.t_start = time.perf_counter()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
        self._prof.__exit__(None, None, None)
        path = os.path.join(self.tmpdir, "kfxbench-trace.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        try:
            with open(path) as f:
                raw = json.load(f)
        finally:
            os.remove(path)
        self.events = parse(raw)

    @property
    def window_s(self) -> float:
        return self.t_stop - self.t_start

    def summary(self) -> Dict[str, object]:
        return summarize(self.events, self.window_s)


def parse(raw: dict) -> List[Tuple[str, float, float]]:
    """(name, start us, duration us) of every device operation."""
    out = []
    for ev in raw.get("traceEvents", []):
        if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS:
            out.append((ev["name"], float(ev["ts"]), float(ev["dur"])))
    out.sort(key=lambda e: e[1])
    return out


def summarize(events: List[Tuple[str, float, float]],
              window_s: float) -> Dict[str, object]:
    """busy_s (the union of the operations' intervals), window_s (from
    the first operation's start to the last one's end, or the host's
    ``window_s`` without operations), kernel seconds and
    launches by name, the ten kinds of operation (by ``short`` name) that took most time and the ten longest idle
    gaps, each named by the operation that ended before it."""
    busy = 0.0
    gaps: List[Tuple[str, float]] = []
    by_name: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    end: Optional[float] = None
    last = ""
    for name, ts, dur in events:
        by_name[name] += dur * 1e-6
        counts[name] += 1
        if end is None or ts >= end:
            if end is not None and ts > end:
                gaps.append((f"after {short(last)}", (ts - end) * 1e-6))
            busy += dur
            end = ts + dur
        elif ts + dur > end:
            busy += ts + dur - end
            end = ts + dur
        if end == ts + dur:
            last = name
    by_short: Dict[str, float] = defaultdict(float)
    for name, seconds in by_name.items():
        by_short[short(name)] += seconds
    top = sorted(by_short.items(), key=lambda kv: -kv[1])[:10]
    gaps.sort(key=lambda g: -g[1])
    if events:
        # The traced window on the device's clock: the host's start and
        # stop race the engine thread's launches at both edges.
        window_s = (end - events[0][1]) * 1e-6
    return {"busy_s": busy * 1e-6, "window_s": window_s,
            "by_name": dict(by_name), "counts": dict(counts),
            "device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps[:10]]}


def short(name: str, limit: int = 96) -> str:
    """A kernel's name without its template arguments, parameters and
    anonymous namespaces, cut to ``limit``."""
    base = name.replace("(anonymous namespace)::", "").split("(")[0]
    depth, out = 0, []
    for ch in base:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    text = "".join(out).strip()
    if text.startswith("void "):
        text = text[len("void "):]
    return (text or name)[:limit]
