"""Profiling subsystem: a trace server in every worker + `kfx profile
<job>` capturing a trace of the running job; the port's counterpart of
``kubeflow_tpu/profiling.py``, with its names and its advertising contract.

Server side — runners call :func:`maybe_start_profiler_server` right
after distributed init. Unless ``KFX_PROFILE=0``, it starts a small HTTP
trace server on ``127.0.0.1:<free port>`` in a daemon thread and
advertises the port in ``<KFX_WORKDIR>/profiler/<replica>.port`` so the
control plane can find it without pre-allocating ports in the job spec
(the server binds first, then advertises). With no ``KFX_WORKDIR`` it
advertises nothing.

PyTorch has no profiler *server* (the reference's ``jax.profiler.
start_server``), so the engine is this module's own: ``GET
/trace?duration_ms=N`` runs ``torch.profiler.profile`` over the process for
N ms and answers with the gzipped Chrome trace. The profiler records the
ops of the thread that starts it only, and the listener is not the
training thread: the capture asks for every thread
(``_ExperimentalConfig(profile_all_threads=True)``). It records CPU ops,
plus CUDA activity (every kernel of the process, the ones launched through
``ctypes`` by ``ops/flash_attention.py`` included) once the process has
initialised CUDA. One capture runs at a time; a concurrent request is
answered 409. A capture that holds no CPU op is answered 500, and the
client raises: an empty trace is a failure, not a result. ``torch.profiler``
is imported when the server starts, on the runner's thread (an import on
the listener while the training thread imports can meet a half-initialised
module), never when this module is imported: a CLI or ``kfx server`` that
imports it loads no torch.

Client side — :func:`capture_trace` fetches a trace over plain HTTP and
writes it under the reference's TensorBoard layout, as
``<logdir>/plugins/profile/<run>/<replica>.pt.trace.json.gz`` (the
reference writes ``*.xplane.pb`` there). The file opens in Perfetto
(ui.perfetto.dev) and in TensorBoard's PyTorch profiler plugin. Its
top-level ``kfxCapture`` object gives the window's wall-clock start and
end (``time.time()``), the seconds the profiler then took to stop and to
export, the worker's pid and replica, and the native ids (the trace's
``tid``) of its main thread, where the runners train, and of the thread
that ran the capture.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qs, urlparse

ENV_PROFILE = "KFX_PROFILE"
PORT_DIR = "profiler"
TRACE_DIR = "traces"
TRACE_SUFFIX = ".pt.trace.json.gz"
REPLICA_HEADER = "X-Kfx-Replica"
MAX_DURATION_MS = 600_000
# How the Chrome trace export marks an op's event.
CPU_OP = b'"cat": "cpu_op"'


def _replica_id() -> str:
    rtype = os.environ.get("KFX_REPLICA_TYPE", "worker").lower()
    ridx = os.environ.get("KFX_REPLICA_INDEX", "0")
    return f"{rtype}-{ridx}"


def port_file(workdir: str, replica: str) -> str:
    return os.path.join(workdir, PORT_DIR, f"{replica}.port")


class CaptureBusy(RuntimeError):
    """A trace capture is already running in this process."""


class TraceServer:
    """The worker's trace server: ``GET /trace?duration_ms=N`` on a
    ThreadingHTTPServer in a daemon thread. Captures are serialised by a
    lock taken without waiting."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        import torch.profiler  # noqa: F401  (on the caller's thread)

        self._busy = threading.Lock()
        self.httpd = ThreadingHTTPServer((host, port), _TraceHandler)
        self.httpd.daemon_threads = True
        self.httpd.trace_server = self  # type: ignore[attr-defined]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="kfx-profiler", daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def capture(self, duration_ms: int) -> bytes:
        """One window of ``duration_ms`` over every thread of the process;
        the gzipped Chrome trace with its ``kfxCapture`` header object.
        Raises CaptureBusy while another capture runs and RuntimeError
        when the window held no CPU op."""
        if not self._busy.acquire(blocking=False):
            raise CaptureBusy("a trace capture is already running in this "
                              "worker; retry when it ends")
        try:
            return _capture(duration_ms)
        finally:
            self._busy.release()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=5)


def _capture(duration_ms: int) -> bytes:
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=activities,
                 experimental_config=config) as prof:
        start = time.time()
        time.sleep(duration_ms / 1e3)
        end = time.time()
    stopped = time.time()
    with tempfile.TemporaryDirectory(prefix="kfx-profile-") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path, "rb") as f:
            text = f.read()
    exported = time.time()
    if CPU_OP not in text:
        raise RuntimeError(
            f"the {duration_ms} ms capture held no CPU op (was the worker "
            f"idle for the whole window?)")
    head = json.dumps({"kfxCapture": {
        "start": start, "end": end, "duration_ms": duration_ms,
        "pid": os.getpid(), "replica": _replica_id(),
        "stop_s": stopped - end, "export_s": exported - stopped,
        "main_tid": threading.main_thread().native_id,
        "listener_tid": threading.get_native_id(),
        "activities": [a.name for a in activities]}})
    # The export is one JSON object: splice the header object in front of
    # its first key.
    brace = text.index(b"{")
    text = text[:brace + 1] + head[1:-1].encode() + b",\n" \
        + text[brace + 1:]
    return gzip.compress(text, compresslevel=1)


class _TraceHandler(BaseHTTPRequestHandler):
    server_version = "kfx-profiler"

    def log_message(self, fmt, *args):  # quiet
        pass

    def _reply(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header(REPLICA_HEADER, _replica_id())
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, msg: str) -> None:
        self._reply(code, json.dumps({"error": msg}).encode(),
                    "application/json")

    def do_GET(self):  # noqa: N802 (stdlib naming)
        url = urlparse(self.path)
        if url.path != "/trace":
            return self._error(404, f"no route {url.path}")
        try:
            duration = int(parse_qs(url.query).get(
                "duration_ms", ["2000"])[0])
        except ValueError:
            return self._error(400, "duration_ms must be an integer")
        if not 0 < duration <= MAX_DURATION_MS:
            return self._error(
                400, f"duration_ms must be in (0, {MAX_DURATION_MS}]")
        try:
            body = self.server.trace_server.capture(duration)
        except CaptureBusy as e:
            return self._error(409, str(e))
        except Exception as e:  # the worker keeps training
            return self._error(500, f"{type(e).__name__}: {e}")
        self._reply(200, body, "application/gzip")


# One trace server a process, as the reference's profiler service is: a
# runner's main() called again in the same process reuses it.
_SERVER: Optional[TraceServer] = None
_SERVER_LOCK = threading.Lock()


def maybe_start_profiler_server() -> Optional[int]:
    """Start the per-worker trace server (idempotent, opt-out via
    KFX_PROFILE=0). Returns the port, or None when disabled."""
    global _SERVER
    if os.environ.get(ENV_PROFILE, "1") == "0":
        return None
    with _SERVER_LOCK:
        if _SERVER is None:
            try:
                _SERVER = TraceServer()
            except OSError:  # no loopback socket: profiling unavailable
                return None
        port = _SERVER.port
    workdir = os.environ.get("KFX_WORKDIR")
    if not workdir:
        # Direct runner invocation (no gang): the server runs, but there
        # is no job workdir to advertise in — never pollute the cwd.
        return port
    path = port_file(workdir, _replica_id())
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(str(port))
        os.replace(tmp, path)  # atomic: readers never see a partial write
    except OSError:
        pass  # server still reachable if the caller knows the port
    return port


def replica_port(workdir: str, replica: str) -> Optional[int]:
    try:
        with open(port_file(workdir, replica)) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def capture_trace(service_addr: str, logdir: str,
                  duration_ms: int = 2000) -> List[str]:
    """Grab a trace from a running worker's trace server into ``logdir``
    (the TensorBoard layout). Returns the trace paths under
    ``<logdir>/plugins/profile/*/``.

    Plain ``urllib``: the CLI process imports no torch. Raises
    RuntimeError when the worker is gone, answers with an error (a
    capture already running, a window with no op) or with no trace."""
    import urllib.error
    import urllib.request

    os.makedirs(logdir, exist_ok=True)
    url = f"http://{service_addr}/trace?duration_ms={int(duration_ms)}"
    try:
        with urllib.request.urlopen(
                url, timeout=duration_ms / 1e3 + 300) as r:
            body = r.read()
            replica = r.headers.get(REPLICA_HEADER) or \
                service_addr.replace(":", "_")
    except urllib.error.HTTPError as e:
        detail = e.read().decode(errors="replace")
        try:
            detail = json.loads(detail).get("error", detail)
        except ValueError:
            pass
        raise RuntimeError(f"profiler at {service_addr} answered "
                           f"{e.code}: {detail}") from None
    except (urllib.error.URLError, ConnectionError) as e:
        raise RuntimeError(
            f"cannot reach the profiler at {service_addr}: "
            f"{getattr(e, 'reason', e)} (has the worker exited?)") from None
    if not body:
        raise RuntimeError(
            f"profiler at {service_addr} returned no trace for {logdir}")
    run = time.strftime("%Y_%m_%d_%H_%M_%S")
    out_dir = os.path.join(logdir, "plugins", "profile", run)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{replica}{TRACE_SUFFIX}")
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(body)
    os.replace(tmp, path)
    dumps = sorted(glob.glob(os.path.join(
        logdir, "plugins", "profile", "*", f"*{TRACE_SUFFIX}")))
    if not dumps:
        raise RuntimeError(
            f"profiler at {service_addr} returned no trace under {logdir}")
    return dumps


def load_trace(path: str) -> dict:
    """A trace file written by :func:`capture_trace`, parsed."""
    with gzip.open(path, "rt") as f:
        return json.load(f)
