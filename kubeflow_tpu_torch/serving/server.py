"""Model server: the V1 data plane — port of
``kubeflow_tpu/serving/server.py`` for the LM one-shot path.

    GET  /healthz | /                   -> {"status": "alive"|"draining"}
    GET  /metrics[?format=json]         -> Prometheus text (or JSON)
    GET  /v1/models                     -> {"models": [...]}
    GET  /v1/models/{m}                 -> {"name": m, "ready": true}
    POST /v1/models/{m}:generate        -> {"generated_tokens": [...], ...}
                                           ("stream": true -> SSE)
    POST /v1/models/{m}:predict         -> 400/500 for an LM, 404 unknown
    POST /drain[?wait_s=S]              -> {"draining": true, "drained": b}

/drain is the operator's pre-kill hook: readiness flips false and new
requests shed with 503 + Retry-After. The reference's engine, weight
pool, KV-transfer and flight-recorder routes (``:kvimport``,
``:migrate``, ``:kvpeers``, ``:evict``, ``/debug/*``), its chaos points
and the classifier predictors and micro-batcher are not ported yet
(ROADMAP.md Queue A 5, 7 and 8).

    python -m kubeflow_tpu_torch.serving.server --model-dir EXPORT \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import socket
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional
from urllib.parse import parse_qs, urlsplit

from ..obs import trace as obs_trace
from ..obs.metrics import MetricsRegistry
from ..obs.trace import SPAN_HEADER, TRACE_HEADER
from ..utils.prom import PROM_CTYPE

request_log = logging.getLogger("kfx.serving")

# Request-latency buckets (seconds), the reference's: sub-millisecond
# rejections up to minute-long LM generations.
SERVING_BUCKETS = (
    0.001, 0.0025, 0.005, 0.0075, 0.01, 0.015, 0.02, 0.03, 0.04, 0.05,
    0.065, 0.08, 0.1, 0.13, 0.17, 0.25, 0.4, 0.65, 1.0, 2.5, 5.0, 10.0,
    30.0, 60.0)


class Predictor:
    """Base predictor: load() once, predict(instances) per request."""

    name: str = "model"
    ready: bool = False

    def load(self) -> None:
        raise NotImplementedError

    def predict(self, instances, probabilities: bool = False
                ) -> Dict[str, Any]:
        raise NotImplementedError


class ModelServer:
    """HTTP server hosting one or more predictors (V1 protocol)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self.predictors: Dict[str, Predictor] = {}
        # Drain mode: readiness false, new requests shed with 503 +
        # Retry-After. One-way.
        self.draining = False
        self.metrics = MetricsRegistry()
        self.latency = self.metrics.histogram(
            "kfx_serving_request_seconds",
            "End-to-end predict/generate handling time by model and verb.",
            buckets=SERVING_BUCKETS)
        self.requests_total = self.metrics.counter(
            "kfx_serving_requests_total",
            "Predict requests served since startup.")
        self.errors_total = self.metrics.counter(
            "kfx_serving_errors_total",
            "Requests answered with a non-2xx status.")
        self.metrics.add_collector(self._collect_model_gauges)
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # Never let Nagle hold a partial segment waiting on a delayed
            # ACK (worth ~40ms per request on loopback).
            disable_nagle_algorithm = True

            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, payload: Dict[str, Any],
                      extra_headers: Optional[Dict[str, str]] = None
                      ) -> None:
                self._send_text(code, json.dumps(payload),
                                "application/json",
                                extra_headers=extra_headers)

            def _send_text(self, code: int, text: str, ctype: str,
                           extra_headers: Optional[Dict[str, str]] = None
                           ) -> None:
                body = text.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, v)
                trace = self.headers.get(TRACE_HEADER, "")
                if trace:
                    # Echo the caller's correlation ID.
                    self.send_header(TRACE_HEADER, trace)
                span_id = getattr(self, "_span_id", "")
                if span_id:
                    # This request's span, so callers can parent to it.
                    self.send_header(SPAN_HEADER, span_id)
                self.end_headers()
                self.wfile.write(body)
                self._last_code = code

            def do_GET(self):
                server._handle_get(self)

            def do_POST(self):
                server._handle_post(self)

        class Server(ThreadingHTTPServer):
            # The default listen backlog of 5 resets bursts of clients.
            request_queue_size = 128

        self.httpd = Server((host, port), Handler)
        self.port = self.httpd.server_port
        self._thread: Optional[threading.Thread] = None

    # -- observability ------------------------------------------------------
    @property
    def request_count(self) -> int:
        """Total routed predict/generate requests (a view over the
        registry counter, so both /metrics formats agree)."""
        return int(sum(v for _, v in self.requests_total.samples()))

    def _collect_model_gauges(self, reg: MetricsRegistry) -> None:
        reg.gauge("kfx_serving_models",
                  "Registered models.").set(len(self.predictors))
        reg.gauge("kfx_serving_models_ready",
                  "Models ready to serve.").set(
                      sum(1 for p in self.predictors.values() if p.ready))
        obs_trace.collect(reg)

    def _latency_summary(self) -> Dict[str, Dict[str, Optional[float]]]:
        """Server-reported per-model p50/p99 (ms) from the request
        histogram."""
        out: Dict[str, Dict[str, Optional[float]]] = {}
        for name in self.predictors:
            if not self.latency.count(model=name):
                continue
            p50 = self.latency.percentile(0.5, {"model": name})
            p99 = self.latency.percentile(0.99, {"model": name})
            out[name] = {
                "p50": round(p50 * 1000, 3) if p50 is not None else None,
                "p99": round(p99 * 1000, 3) if p99 is not None else None,
            }
        return out

    def _finish_request(self, h, name: str, verb: str, t0: float) -> None:
        """Record latency/outcome for one routed request and emit the
        request log line (trace ID echoed from the caller)."""
        dt = time.perf_counter() - t0
        # _last_code was reset at routing time, so 0 means the handler
        # died before sending anything: an error, not a success.
        code = getattr(h, "_last_code", 0)
        # Only registered names become label values, or a scanner cycling
        # model names would grow the label space without bound.
        model = name if name in self.predictors else "unknown"
        self.requests_total.inc(1, model=model, verb=verb)
        if 200 <= code < 400:
            # 4xx rejections would distort the p50 clients experience.
            self.latency.observe(dt, model=model, verb=verb)
        else:
            self.errors_total.inc(1, model=model, verb=verb)
        request_log.info(
            "request model=%s verb=%s status=%s ms=%.2f trace=%s",
            name, verb, code, dt * 1000, h.headers.get(TRACE_HEADER, ""))

    # -- registration -------------------------------------------------------
    def register(self, predictor: Predictor) -> None:
        self.predictors[predictor.name] = predictor
        # Predictors with their own instruments (LM tokens/sec) record
        # into the server's registry so one /metrics shows everything.
        predictor.metrics = self.metrics
        hook = getattr(predictor, "on_metrics_attached", None)
        if hook is not None:
            # Re-seed gauges set before the swap (warm-bucket count) so a
            # scrape before the first request already sees them.
            hook()

    # -- request handling ---------------------------------------------------
    def drain(self, wait_s: float = 0.0) -> Dict[str, Any]:
        """Enter drain mode: readiness false, new requests shed (503 +
        Retry-After). The one-shot predictor holds no in-flight state
        beyond the HTTP handler threads, which finish on their own, so
        ``wait_s`` bounds nothing here and the verdict is drained."""
        self.draining = True
        return {"draining": True, "drained": True}

    def _handle_get(self, h) -> None:
        path = h.path
        if path == "/healthz" or path == "/":
            h._send(200, {"status": "draining" if self.draining
                          else "alive"})
        elif path == "/metrics" or path.startswith("/metrics?"):
            # Prometheus exposition by default; JSON via ?format=json.
            # Both render the same registry state.
            q = parse_qs(urlsplit(path).query)
            if (q.get("format") or [""])[0] == "json":
                # "engine" is the decode engine's load block; the one-shot
                # path has no engine, so it is empty (as the reference's
                # is with KFX_LM_ENGINE=0).
                h._send(200, {"request_count": self.request_count,
                              "models": sorted(self.predictors),
                              "latency_ms": self._latency_summary(),
                              "engine": {}})
            else:
                h._send_text(200, self.metrics.render(), PROM_CTYPE)
        elif path == "/v1/models":
            h._send(200, {"models": sorted(self.predictors)})
        elif path.startswith("/v1/models/"):
            name = path[len("/v1/models/"):]
            p = self.predictors.get(name)
            if p is None:
                h._send(404, {"error": f"model {name!r} not found"})
            else:
                # A draining server is deliberately not ready.
                h._send(200, {"name": name,
                              "ready": p.ready and not self.draining})
        else:
            h._send(404, {"error": f"no route {path}"})

    def _handle_post(self, h) -> None:
        path = h.path
        t0 = time.perf_counter()
        # Reset per request: the handler persists across a keep-alive
        # connection, and a stale 200 must not mark an aborted request.
        h._last_code = 0
        if path == "/drain" or path.startswith("/drain?"):
            q = parse_qs(urlsplit(path).query)
            try:
                wait_s = float((q.get("wait_s") or ["0"])[0])
            except ValueError:
                h._send(400, {"error": "wait_s must be a number"})
                return
            h._send(200, self.drain(wait_s))
            return
        for verb in ("generate", "predict"):
            suffix = f":{verb}"
            if path.startswith("/v1/models/") and path.endswith(suffix):
                name = path[len("/v1/models/"):-len(suffix)]
                sp = self._request_span(h, f"serving.{verb}", name)
                try:
                    if verb == "generate":
                        self._handle_generate(h, name)
                    else:
                        self._handle_predict(h, name)
                finally:
                    self._finish_request(h, name, verb, t0)
                    self._finish_span(h, sp)
                return
        h._send(404, {"error": f"no route {path}"})

    @staticmethod
    def _request_span(h, name: str, model: str):
        """Open the request's span, adopting the caller's trace/span
        headers so this hop joins the caller's trace tree."""
        sp = obs_trace.start_span(
            name, trace_id=h.headers.get(TRACE_HEADER, ""),
            parent_id=h.headers.get(SPAN_HEADER, ""), model=model)
        h._span_id = sp.span_id  # echoed back by _send_text
        return sp

    @staticmethod
    def _finish_span(h, sp) -> None:
        code = getattr(h, "_last_code", 0)
        obs_trace.finish_span(
            sp, status="ok" if 200 <= code < 400 else "error")
        h._span_id = ""

    def _unavailable(self, h, name: str, p: Predictor) -> bool:
        """Answer 503 (Retry-After while draining) unless ``p`` serves."""
        if p.ready and not self.draining:
            return False
        h._send(503, {"error": f"model {name!r} not ready"
                      if not p.ready else "server draining"},
                extra_headers={"Retry-After": "1"}
                if self.draining else None)
        return True

    def _read_json(self, h) -> Optional[Dict[str, Any]]:
        """The request body as JSON, or None after answering 400."""
        try:
            length = int(h.headers.get("Content-Length", 0))
            return json.loads(h.rfile.read(length) or b"{}")
        except ValueError as e:
            h._send(400, {"error": f"bad request: {e}"})
            return None

    def _handle_predict(self, h, name: str) -> None:
        p = self.predictors.get(name)
        if p is None:
            h._send(404, {"error": f"model {name!r} not found"})
            return
        if self._unavailable(h, name, p):
            return
        body = self._read_json(h)
        if body is None:
            return
        if "instances" not in body:
            h._send(400, {"error": "bad request: 'instances'"})
            return
        try:
            result = p.predict(body["instances"],
                               probabilities=bool(
                                   body.get("probabilities", False)))
        except Exception as e:
            h._send(500, {"error": str(e)})
            return
        h._send(200, result)

    def _handle_generate(self, h, name: str) -> None:
        """LM generation (serving/lm_server.py): token ids in, generated
        token ids out."""
        p = self.predictors.get(name)
        if p is None:
            h._send(404, {"error": f"model {name!r} not found"})
            return
        if not getattr(p, "generate", None):
            h._send(400, {"error": f"model {name!r} does not support "
                                   f":generate"})
            return
        if self._unavailable(h, name, p):
            return
        body = self._read_json(h)
        if body is None:
            return
        try:
            if body.get("stream"):
                events = p.generate_stream(body)
                self._send_sse(h, events)
                return
            result = p.generate(body)
        except ValueError as e:
            h._send(400, {"error": str(e)})
            return
        except Exception as e:
            h._send(500, {"error": str(e)})
            return
        h._send(200, result)

    def _send_sse(self, h, events) -> None:
        """Stream SSE events over a chunked HTTP/1.1 response. The
        predictor validated and generated before handing over the
        iterator, so failures reach the client as a 400/500 above. A
        client hangup just ends the relay."""
        h.send_response(200)
        h.send_header("Content-Type", "text/event-stream")
        h.send_header("Cache-Control", "no-store")
        h.send_header("Transfer-Encoding", "chunked")
        h.end_headers()
        h._last_code = 200
        try:
            for ev in events:
                h.wfile.write(b"%x\r\n%s\r\n" % (len(ev), ev))
                h.wfile.flush()
            h.wfile.write(b"0\r\n\r\n")
            h.wfile.flush()
        except OSError:
            # Leave the stream unterminated (no final chunk) so the client
            # sees a truncated stream; shutdown() sends the FIN that a
            # bare close() would not while rfile/wfile hold the socket.
            try:
                h.connection.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        h.close_connection = True

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "ModelServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="kfx-modelserver")
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="kfx model server (GPU)")
    p.add_argument("--model-dir", required=True,
                   help="export directory (storageUri)")
    p.add_argument("--name", default="model")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max-batch-size", type=int, default=8,
                   help="prompts per :generate request")
    p.add_argument("--device", default="auto",
                   choices=["auto", "default", "cuda", "cpu"],
                   help="auto/default mean cuda")
    p.add_argument("--framework", default="auto",
                   choices=["auto", "jax", "pytorch", "tensorflow",
                            "sklearn", "lm"],
                   help="predict backend; auto sniffs the export format")
    args = p.parse_args(argv)

    from .lm_server import LMPredictor, is_lm_export

    framework = args.framework
    if framework == "auto" and is_lm_export(args.model_dir):
        framework = "lm"
    if framework != "lm":
        print(f"error: {args.model_dir} is not an LM export; the port "
              "serves LM exports only (classifier predictors: ROADMAP.md "
              "Queue A 7)", file=sys.stderr)
        return 2
    predictor = LMPredictor(args.model_dir, name=args.name,
                            max_batch_size=args.max_batch_size,
                            device=args.device)
    t0 = time.time()
    predictor.load()
    server = ModelServer(port=args.port)
    server.register(predictor)
    server.start()
    print(f"server_ready name={args.name} port={server.port} "
          f"framework={framework} "
          f"load_seconds={time.time() - t0:.1f} "
          f"device={predictor.device}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
