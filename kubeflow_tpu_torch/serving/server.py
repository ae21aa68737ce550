"""Model server: the V1 data plane — port of
``kubeflow_tpu/serving/server.py``: LM exports through ``:generate`` and
classifier exports through ``:predict`` (``JaxPredictor``, optionally
behind the ``MicroBatcher``).

    GET  /healthz | /                   -> {"status": "alive"|"draining"}
                                           503 {"status": "wedged"} while
                                           a decode loop is stalled with
                                           work in flight
    GET  /debug/flight                  -> {"models": {m: flight ring}}
    GET  /debug/requests                -> {"models": {m: retired reqs}}
                                           (both 404 without a recorder)
    GET  /metrics[?format=json]         -> Prometheus text (or JSON, with
                                           the decode engines' load block)
    GET  /v1/models                     -> {"models": [...]}
    GET  /v1/models/{m}                 -> {"name": m, "ready": true}
                                           (+ "pooledModels" on a weight
                                           pool's host; a pooled name ->
                                           {"pooled": true, "loaded",
                                           "host"})
    POST /v1/models/{m}:generate        -> {"generated_tokens": [...], ...}
                                           ("stream": true -> SSE)
    POST /v1/models/{m}:predict         -> {"predictions": [...]} (and
                                           "probabilities" when asked);
                                           400 on a bad body, 500 on a
                                           predictor error (an LM's too)
                                           or an injected
                                           ``serving.predict`` fault
    POST /v1/models/{m}:kvimport        -> {"resume", "tokens", "pages"}
                                           (body: a kvtransfer payload;
                                           400 corrupt or mismatched,
                                           503 + Retry-After no capacity)
    POST /v1/models/{m}:migrate?peer=URL[&reason=R]
                                        -> {"moved", "failed", "pages"}
    POST /v1/models/{m}:kvpeers         -> {"peers": n} (body: JSON list)
    POST /v1/models/{m}:evict           -> {"model", "evicted"} (body:
                                           {"model": pooled name})
    POST /drain[?wait_s=S]              -> {"draining": true, "drained": b}

/drain is the operator's pre-kill hook: readiness flips false, new
requests shed with 503 + Retry-After, and each predictor's engine stops
admitting and finishes its in-flight requests (``drained`` says whether
they finished within ``wait_s``). An engine's bounded-queue overflow
(``EngineOverloaded``) is a 503 + Retry-After too; a deadline or rate
shed carries its own Retry-After, and a migrated request's 503 the
adopting peer in ``X-Kfx-Migrated``. ``:generate`` merges the
``X-KFX-Deadline-Ms`` header into the body's ``deadline_ms`` (the body
wins; a malformed header is a 400). An engine-served
``:generate`` answer carries the flight recorder's ``X-Kfx-Timing``
header, and each ``/healthz`` writes the newest flight snapshot to
``$KFX_WORKDIR/flight/<KFX_COMPONENT>-<pid>.json`` (atomically, at most
once every ``KFX_FLIGHT_SNAP_S`` seconds, default 1, "0" off). The
``serving.predict`` chaos point answers 500 ``chaos[serving.predict]:
<model>`` on ``:predict`` (the reference's site) and on ``:generate``,
and ``/metrics`` carries ``kfx_chaos_injected_total``. ``:evict`` is the
operator's scale-to-zero push into a weight pool (serving/weights.py):
best-effort, a slot worn by in-flight requests (or the pinned default)
stays and the answer says so. ``--framework auto`` sniffs the export in
the reference's order (lm, pytorch, tensorflow, sklearn, jax): a
TorchScript export serves on the card through ``torch_server``, a
SavedModel and a joblib export on the host through ``tf_server`` and
``sklearn_server`` (TensorFlow and scikit-learn have no claim on the card,
as in the reference).

    python -m kubeflow_tpu_torch.serving.server --model-dir EXPORT \\
        [--device cpu] [--batcher-max-latency-ms 5]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import queue
import socket
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional
from urllib.parse import parse_qs, urlsplit

import numpy as np
import torch

from .. import chaos
from ..obs import trace as obs_trace
from ..obs.metrics import MetricsRegistry
from ..obs.trace import SPAN_HEADER, TRACE_HEADER
from ..utils.prom import PROM_CTYPE
from .engine import EngineOverloaded, quant_mode_string

request_log = logging.getLogger("kfx.serving")

# Request-latency buckets (seconds), the reference's: sub-millisecond
# rejections up to minute-long LM generations.
SERVING_BUCKETS = (
    0.001, 0.0025, 0.005, 0.0075, 0.01, 0.015, 0.02, 0.03, 0.04, 0.05,
    0.065, 0.08, 0.1, 0.13, 0.17, 0.25, 0.4, 0.65, 1.0, 2.5, 5.0, 10.0,
    30.0, 60.0)


TIMING_HEADER = "X-Kfx-Timing"


def _timing_header(result: Dict[str, Any]) -> Optional[Dict[str, str]]:
    """Fold the first request's latency breakdown into the
    ``X-Kfx-Timing`` response header (``k=v;...``), so a client reads
    where the time went without parsing the body. None when the engine
    or its recorder is off."""
    timing = result.get("timing") if isinstance(result, dict) else None
    if not timing:
        return None
    first = timing[0]
    parts = []
    for key in ("queue_wait_s", "prefill_s", "decode_s", "stalled_s",
                "spec_accept"):
        v = first.get(key)
        if v is not None:
            parts.append(f"{key}={v:g}")
    return {TIMING_HEADER: ";".join(parts)} if parts else None


class Predictor:
    """Base predictor: load() once, predict(instances) per request."""

    name: str = "model"
    ready: bool = False

    def load(self) -> None:
        raise NotImplementedError

    def predict(self, instances, probabilities: bool = False
                ) -> Dict[str, Any]:
        raise NotImplementedError


def load_export_meta(model_dir: str, filename: str = "config.json"):
    """(input_shape, num_classes) from an export's metadata sidecar."""
    path = os.path.join(model_dir, filename)
    if not os.path.exists(path):
        return None, None
    with open(path) as f:
        meta = json.load(f)
    shape = tuple(meta["input_shape"]) if meta.get("input_shape") else None
    ncls = int(meta["num_classes"]) if meta.get("num_classes") else None
    return shape, ncls


class JaxPredictor(Predictor):
    """Serves a classifier export (``serving/export.py``, the reference's
    format, so the name is the reference's too) on one device.

    Batch-size buckets are the powers of two up to ``max_batch_size``,
    plus ``max_batch_size`` itself when it is not one; a request pads up
    to its bucket and one larger than ``max_batch_size`` runs as chunks of
    it, so the model sees a fixed set of shapes, each warmed at
    ``load()`` (cuDNN picks its algorithms per shape on the first call).
    Probabilities are copied to the host only when asked for.

    One deliberate divergence: the reference's ``device="auto"`` probes
    the accelerator against the host CPU and may place small buckets on
    the CPU, for a tunneled TPU whose every sync costs 65-100 ms. Here
    ``auto`` and ``default`` mean ``cuda``, as they do for the LM server,
    and ``placement`` reads "accelerator" for every bucket; ``probe_ms``
    records the best of three one-instance predicts on the device. Only
    ``device="cpu"`` serves on the CPU.
    """

    def __init__(self, model_dir: str, name: str = "",
                 max_batch_size: int = 64, device: str = "auto"):
        self.model_dir = model_dir
        self.name = name or "model"
        self.max_batch_size = max_batch_size
        self.device = "cuda" if device in ("auto", "default") else device
        self._buckets: List[int] = []
        self.placement: Dict[int, str] = {}
        self.probe_ms: Dict[str, float] = {}
        self._model = None
        self._dev = None

    def load(self) -> None:
        from ..device import resolve_device
        from ..models import get_model
        from ..models.convert import classifier_params_from_jax
        from .export import load_exported

        dev = resolve_device(self.device)
        config, payload = load_exported(self.model_dir)
        self.input_shape = tuple(config["input_shape"])
        self.num_classes = int(config["num_classes"])
        model = get_model(config["model"], num_classes=self.num_classes,
                          input_shape=self.input_shape)
        model.load_state_dict(classifier_params_from_jax(
            config["model"], payload["params"], payload.get("batch_stats")))
        self._model = model.to(dev, memory_format=torch.channels_last).eval()
        self._dev = dev
        self._buckets = []
        b = 1
        while b <= self.max_batch_size:
            self._buckets.append(b)
            b *= 2
        if self._buckets[-1] != self.max_batch_size:
            self._buckets.append(self.max_batch_size)
        where = "cpu" if dev.type == "cpu" else "accelerator"
        self.placement = {b: where for b in self._buckets}
        for b in self._buckets:
            self._run(np.zeros((b,) + self.input_shape, np.float32))[0].cpu()
        probe = np.zeros((1,) + self.input_shape, np.float32)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            self._run(probe)[0].cpu()
            best = min(best, (time.perf_counter() - t0) * 1000)
        self.probe_ms = {where: round(best, 2)}
        self.ready = True

    @torch.inference_mode()
    def _run(self, x: np.ndarray):
        logits = self._model(torch.from_numpy(x).to(self._dev))
        return logits.argmax(-1), torch.softmax(logits, -1)

    def _bucket(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self._buckets[-1]

    def predict(self, instances: np.ndarray,
                probabilities: bool = False) -> Dict[str, Any]:
        instances = np.asarray(instances, np.float32)
        if instances.size and tuple(instances.shape[1:]) != self.input_shape:
            raise ValueError(
                f"instance shape {tuple(instances.shape[1:])} does not "
                f"match model input {self.input_shape}")
        preds: List[Any] = []
        probs_out: List[Any] = []
        for start in range(0, instances.shape[0], self.max_batch_size):
            chunk = instances[start:start + self.max_batch_size]
            n = chunk.shape[0]
            b = self._bucket(n)
            if n < b:
                pad = np.zeros((b - n,) + chunk.shape[1:], chunk.dtype)
                chunk = np.concatenate([chunk, pad], 0)
            cls, probs = self._run(chunk)
            if probabilities:
                probs_out.extend(p.tolist() for p in probs[:n].cpu())
            preds.extend(cls[:n].cpu().tolist())
        out: Dict[str, Any] = {"predictions": preds}
        if probabilities:
            out["probabilities"] = probs_out
        return out


class MicroBatcher:
    """Aggregates concurrent predict calls into one device dispatch — the
    reference's, unchanged: flush when ``max_batch_size`` instances wait or
    the oldest has waited ``max_latency_ms``. ``workers`` > 1 runs that many
    batcher threads, so a batch can dispatch while another is in flight.
    Each reply goes to its request's own queue, in order."""

    def __init__(self, predictor: Predictor, max_batch_size: int = 32,
                 max_latency_ms: float = 2.0, reply_timeout_s: float = 60.0,
                 workers: int = 1):
        self.predictor = predictor
        self.max_batch_size = max_batch_size
        self.max_latency_s = max_latency_ms / 1000.0
        self.reply_timeout_s = reply_timeout_s
        # Entries carry the submitting request's (trace, span) context: the
        # batch runs on a worker thread, where the flush span and the
        # predict must still correlate to the requests behind them.
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        # Orders enqueue against close(): once close() sets _stop under
        # this gate, no new request can slip past the drain.
        self._gate = threading.Lock()
        self._threads = [
            threading.Thread(target=self._run, daemon=True,
                             name=f"kfx-batcher-{i}")
            for i in range(max(1, workers))]
        for t in self._threads:
            t.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            count = first[0].shape[0]
            deadline = time.monotonic() + self.max_latency_s
            while count < self.max_batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                batch.append(item)
                count += item[0].shape[0]
            # A bad request (mismatched shapes failing the concatenate)
            # must reply an error to every caller in its batch, never kill
            # the batcher thread. The flush span takes the OLDEST request's
            # context (its deadline forced the flush).
            try:
                want_probs = any(b[1] for b in batch)
                stacked = np.concatenate([b[0] for b in batch], 0)
                with obs_trace.span("batcher.flush", trace_id=first[3],
                                    parent_id=first[4],
                                    requests=str(len(batch)),
                                    instances=str(stacked.shape[0])):
                    result = self.predictor.predict(
                        stacked, probabilities=want_probs)
                preds = result["predictions"]
                probs = result.get("probabilities")
                off = 0
                for arr, wp, reply, _, _ in batch:
                    n = arr.shape[0]
                    out = {"predictions": preds[off:off + n]}
                    if wp and probs is not None:
                        out["probabilities"] = probs[off:off + n]
                    reply.put(out)
                    off += n
            except Exception as e:  # propagate per-request
                for _, _, reply, _, _ in batch:
                    reply.put(e)

    def predict(self, instances: np.ndarray,
                probabilities: bool = False) -> Dict[str, Any]:
        # Shape mismatches fail fast here instead of poisoning a batch.
        want = getattr(self.predictor, "input_shape", None)
        if want is not None and tuple(instances.shape[1:]) != tuple(want):
            raise ValueError(
                f"instance shape {tuple(instances.shape[1:])} does not "
                f"match model input {tuple(want)}")
        reply: "queue.Queue" = queue.Queue()
        with self._gate:
            if self._stop.is_set():
                # A predict racing close() fails fast instead of waiting
                # reply_timeout_s with no worker left.
                raise RuntimeError("batcher is closed")
            self._q.put((instances, probabilities, reply,
                         obs_trace.current_trace_id(),
                         obs_trace.current_span_id()))
        try:
            out = reply.get(timeout=self.reply_timeout_s)
        except queue.Empty:
            raise TimeoutError(
                f"batcher did not reply within {self.reply_timeout_s}s")
        if isinstance(out, Exception):
            raise out
        return out

    def close(self) -> None:
        """Stop the workers, then answer every request they left queued
        with an error (none waits out its reply timeout)."""
        with self._gate:
            self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        while True:
            try:
                reply = self._q.get_nowait()[2]
            except queue.Empty:
                break
            reply.put(RuntimeError("batcher closed while request queued"))


class ModelServer:
    """HTTP server hosting one or more predictors (V1 protocol)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self.predictors: Dict[str, Predictor] = {}
        self.batchers: Dict[str, MicroBatcher] = {}
        # Drain mode: readiness false, new requests shed with 503 +
        # Retry-After. One-way.
        self.draining = False
        # Last flight-snapshot-file write (monotonic): the /healthz
        # piggyback's throttle.
        self._flight_snap_ts = 0.0
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
        # This process's chaos injections and span-log writes, on the
        # /metrics a scraper already reads.
        chaos.collect(reg)
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

    def _engine_summary(self) -> Dict[str, Dict[str, Any]]:
        """Per-model decode-engine load from this registry's gauges — what
        an autoscaler polls as its queue-depth signal. Empty when no
        predictor runs an engine (the one-shot path)."""
        out: Dict[str, Dict[str, Any]] = {}
        for family, field in (("kfx_lm_queue_depth", "queue_depth"),
                              ("kfx_lm_slot_occupancy", "slot_occupancy"),
                              ("kfx_lm_slots", "slots"),
                              ("kfx_lm_kv_pages", "kv_pages"),
                              ("kfx_lm_kv_pages_free", "kv_pages_free"),
                              ("kfx_lm_kv_bytes_per_token",
                               "kv_bytes_per_token"),
                              ("kfx_lm_prefix_tokens_reused",
                               "prefix_tokens_reused"),
                              ("kfx_lm_prompt_tokens_admitted",
                               "prompt_tokens_admitted"),
                              ("kfx_lm_adapter_slots", "adapter_slots"),
                              ("kfx_lm_adapter_slots_free",
                               "adapter_slots_free"),
                              ("kfx_lm_weight_slots", "weight_slots"),
                              ("kfx_lm_weight_slots_free",
                               "weight_slots_free"),
                              ("kfx_lm_weight_models_loaded",
                               "weight_models_loaded"),
                              ("kfx_lm_spec_accept_rate",
                               "spec_accept_rate")):
            for labels, value in self.metrics.gauge(family).samples():
                out.setdefault(labels.get("model", ""), {})[field] = value
        # Per-model weight-pool residency flattened into {name: loaded?}
        # ("pooled but unloaded" is False, never an absent name).
        for labels, value in self.metrics.gauge(
                "kfx_lm_weight_model_loaded").samples():
            pooled = labels.get("pooled", "")
            if pooled:
                out.setdefault(labels.get("model", ""), {}).setdefault(
                    "pooled", {})[pooled] = bool(value)
        # The quantization info gauge's labels as the `kfx top` Q-column
        # string ("w8", "kv8", "w8+kv8", "d8" or "f32").
        for labels, _ in self.metrics.gauge("kfx_lm_quant_mode").samples():
            out.setdefault(labels.get("model", ""), {})["quant"] = \
                quant_mode_string(labels.get("weights", "f32"),
                                  labels.get("kv", "f32"))
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
    def register(self, predictor: Predictor,
                 batcher: Optional[Dict[str, Any]] = None) -> None:
        """Host ``predictor``; ``batcher`` (the InferenceService spec's
        ``{maxBatchSize, maxLatencyMs, replyTimeoutS, workers}``) puts its
        :predict behind a MicroBatcher."""
        self.predictors[predictor.name] = predictor
        # Predictors with their own instruments (LM tokens/sec) record
        # into the server's registry so one /metrics shows everything.
        predictor.metrics = self.metrics
        hook = getattr(predictor, "on_metrics_attached", None)
        if hook is not None:
            # Re-seed gauges set before the swap (warm-bucket count) so a
            # scrape before the first request already sees them.
            hook()
        if batcher:
            self.batchers[predictor.name] = MicroBatcher(
                predictor,
                max_batch_size=int(batcher.get("maxBatchSize", 32)),
                max_latency_ms=float(batcher.get("maxLatencyMs", 2.0)),
                reply_timeout_s=float(batcher.get("replyTimeoutS", 60.0)),
                workers=int(batcher.get("workers", 1)))

    # -- request handling ---------------------------------------------------
    def _liveness(self) -> Dict[str, Any]:
        """Aggregate the decode-loop heartbeats across predictors: the
        /healthz verdict. ``wedged`` when any engine reports stale
        progress while busy — the server keeps answering HTTP with a stuck
        loop, which is why readiness alone cannot catch it."""
        wedged: Dict[str, Any] = {}
        for name, p in self.predictors.items():
            hb_fn = getattr(p, "engine_heartbeat", None)
            hb = hb_fn() if hb_fn is not None else None
            if hb and hb.get("wedged"):
                wedged[name] = {"iterations": hb["iterations"],
                                "stalled_s": hb["stalled_s"]}
        if wedged:
            return {"status": "wedged", "models": wedged}
        return {"status": "draining" if self.draining else "alive"}

    def drain(self, wait_s: float = 0.0) -> Dict[str, Any]:
        """Enter drain mode and wait up to ``wait_s`` for in-flight work to
        finish: readiness false, new requests shed (503 + Retry-After),
        then every predictor that holds in-flight state drains (the decode
        engine fails its queue with a retriable error and finishes its
        slots). Returns the verdict /drain reports."""
        self.draining = True
        deadline = time.monotonic() + max(float(wait_s), 0.0)
        drained = True
        for p in self.predictors.values():
            fn = getattr(p, "drain", None)
            if fn is None:
                continue  # no in-flight state beyond the HTTP handler
            drained = fn(max(deadline - time.monotonic(), 0.0)) and drained
        return {"draining": True, "drained": drained}

    def _handle_get(self, h) -> None:
        path = h.path
        if path == "/healthz" or path == "/":
            live = self._liveness()
            # The operator polls /healthz every reconcile, so the on-disk
            # flight snapshot stays fresh enough to be the postmortem
            # source when a crash leaves no process to ask.
            self._maybe_snapshot_flight()
            h._send(503 if live["status"] == "wedged" else 200, live)
        elif path in ("/debug/flight", "/debug/requests"):
            attr = "flight_snapshot" if path == "/debug/flight" \
                else "flight_requests"
            snaps = self._flight_payloads(attr)
            if not snaps:
                h._send(404, {"error": "no flight recorder (engine off "
                                       "or KFX_FLIGHT=0)"})
            else:
                h._send(200, {"models": snaps})
        elif path == "/metrics" or path.startswith("/metrics?"):
            # Prometheus exposition by default; JSON via ?format=json.
            # Both render the same registry state.
            q = parse_qs(urlsplit(path).query)
            if (q.get("format") or [""])[0] == "json":
                # "engine" is the decode engines' load block (empty on the
                # one-shot path, as the reference's is with
                # KFX_LM_ENGINE=0).
                h._send(200, {"request_count": self.request_count,
                              "models": sorted(self.predictors),
                              "latency_ms": self._latency_summary(),
                              "engine": self._engine_summary()})
            else:
                h._send_text(200, self.metrics.render(), PROM_CTYPE)
        elif path == "/v1/models":
            h._send(200, {"models": sorted(self.predictors)})
        elif path.startswith("/v1/models/"):
            name = path[len("/v1/models/"):]
            p = self.predictors.get(name)
            if p is None:
                # A pooled model resolves to the predictor hosting its
                # weight pool: "pooled but unloaded" is ready after one
                # swap at admission, not a 404.
                for host in self.predictors.values():
                    pooled = getattr(host, "pooled_models", lambda: {})()
                    if name in pooled:
                        h._send(200, {
                            "name": name,
                            "ready": host.ready and not self.draining,
                            "pooled": True,
                            "loaded": bool(pooled[name]),
                            "host": host.name})
                        return
                h._send(404, {"error": f"model {name!r} not found"})
            else:
                # A draining server is deliberately not ready.
                body = {"name": name, "ready": p.ready and not self.draining}
                pooled = getattr(p, "pooled_models", lambda: {})()
                if pooled:
                    body["pooledModels"] = pooled
                h._send(200, body)
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
        route = path.split("?", 1)[0]
        for verb, handler in (("kvimport", self._handle_kvimport),
                              ("migrate", self._handle_migrate)):
            suffix = f":{verb}"
            if route.startswith("/v1/models/") and route.endswith(suffix):
                name = route[len("/v1/models/"):-len(suffix)]
                sp = self._request_span(h, f"serving.{verb}", name)
                try:
                    handler(h, name)
                finally:
                    self._finish_request(h, name, verb, t0)
                    self._finish_span(h, sp)
                return
        if route.startswith("/v1/models/") and route.endswith(":kvpeers"):
            self._handle_kvpeers(h, route[len("/v1/models/"):-len(":kvpeers")])
            return
        if route.startswith("/v1/models/") and route.endswith(":evict"):
            self._handle_evict(h, route[len("/v1/models/"):-len(":evict")])
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
        h._cur_span = sp
        return sp

    @staticmethod
    def _finish_span(h, sp) -> None:
        code = getattr(h, "_last_code", 0)
        obs_trace.finish_span(
            sp, status="ok" if 200 <= code < 400 else "error")
        h._span_id = ""
        h._cur_span = None

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
        length = int(h.headers.get("Content-Length", 0))
        raw = h.rfile.read(length)
        if self._chaos_predict(h, name):
            return
        try:
            body = json.loads(raw or b"{}")
            instances = np.asarray(body["instances"], np.float32)
            want_probs = bool(body.get("probabilities", False))
        except (ValueError, KeyError, TypeError) as e:
            h._send(400, {"error": f"bad request: {e}"})
            return
        try:
            batcher = self.batchers.get(name)
            result = (batcher or p).predict(instances,
                                            probabilities=want_probs)
        except Exception as e:
            h._send(500, {"error": str(e)})
            return
        h._send(200, result)

    @staticmethod
    def _chaos_predict(h, name: str) -> bool:
        """Fault point ``serving.predict``: an in-server failure (500) or
        latency, the flapping backend a router's passive health must
        eject around. Returns whether the request was answered."""
        inj = chaos.draw("serving.predict", target=name)
        if inj is None:
            return False
        if inj.delay > 0:
            time.sleep(inj.delay)
        if inj.mode == "delay":
            return False
        h._send(500, {"error": f"chaos[serving.predict]: {name}"})
        return True

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
        if body is None or self._chaos_predict(h, name):
            return
        # Deadline header alias for clients that cannot touch the body;
        # the body field wins.
        hdr_deadline = h.headers.get("X-KFX-Deadline-Ms")
        if hdr_deadline is not None and isinstance(body, dict) \
                and "deadline_ms" not in body:
            try:
                body["deadline_ms"] = float(hdr_deadline)
            except ValueError:
                h._send(400, {"error": "X-KFX-Deadline-Ms must be a "
                                       "number"})
                return
        # The tenant on the serving.generate span, resolved as the engine
        # resolves it: the explicit tenant, else the adapter's ("" or
        # absent: the default adapter, the base when there is none).
        sp = getattr(h, "_cur_span", None)
        if sp is not None and isinstance(body, dict):
            tenant = body.get("tenant")
            if not isinstance(tenant, str) or not tenant:
                adapter = body.get("adapter")
                if adapter is None:
                    adapter = getattr(p, "adapter_default", "")
                tenant = str(adapter or "") or "base"
            sp.attrs["tenant"] = tenant
        try:
            if body.get("stream"):
                events = p.generate_stream(body)
                self._send_sse(h, events)
                return
            result = p.generate(body)
        except ValueError as e:
            h._send(400, {"error": str(e)})
            return
        except EngineOverloaded as e:
            # Bounded-queueing overflow and drain are load shedding, not a
            # client mistake and not a server fault: 503 + Retry-After.
            # Deadline and rate sheds carry their own Retry-After, and a
            # migrated request's 503 names the adopting peer.
            extra = self._retry_after(e)
            peer = getattr(e, "peer", "")
            if peer:
                extra["X-Kfx-Migrated"] = str(peer)
            h._send(503, {"error": str(e)}, extra_headers=extra)
            return
        except Exception as e:
            h._send(500, {"error": str(e)})
            return
        h._send(200, result, extra_headers=_timing_header(result))

    @staticmethod
    def _retry_after(e: BaseException) -> Dict[str, str]:
        retry = getattr(e, "retry_after_s", None)
        return {"Retry-After": f"{retry:.1f}" if retry else "1"}

    def _handle_kvimport(self, h, name: str) -> None:
        """Adopt a migrated request's KV pages (serving/kvtransfer.py wire
        format, raw in the body). A corrupt or mismatched stream is a 400
        (the donor must not resend the same bytes here), a capacity
        refusal a 503 (retriable at another peer); either way the donor's
        copy stays authoritative."""
        from . import kvtransfer

        p = self.predictors.get(name)
        if p is None:
            h._send(404, {"error": f"model {name!r} not found"})
            return
        if not getattr(p, "kv_import", None):
            h._send(400, {"error": f"model {name!r} does not accept KV "
                                   "imports"})
            return
        if not p.ready or self.draining:
            h._send(503, {"error": f"model {name!r} not ready"
                          if not p.ready else "server draining"},
                    extra_headers={"Retry-After": "1"})
            return
        raw = h.rfile.read(int(h.headers.get("Content-Length", 0)))
        try:
            result = p.kv_import(raw)
        except kvtransfer.TransferCorrupt as e:
            h._send(400, {"error": str(e), "corrupt": True})
            return
        except (kvtransfer.TransferError, ValueError) as e:
            h._send(400, {"error": str(e)})
            return
        except EngineOverloaded as e:
            h._send(503, {"error": str(e)},
                    extra_headers=self._retry_after(e))
            return
        except Exception as e:
            h._send(500, {"error": str(e)})
            return
        h._send(200, result)

    def _handle_migrate(self, h, name: str) -> None:
        """Push this model's in-flight requests to a peer
        (``?peer=URL&reason=drain``): 200 with the {moved, failed, pages}
        stats; a failed transfer is a degrade, never an HTTP error."""
        p = self.predictors.get(name)
        if p is None:
            h._send(404, {"error": f"model {name!r} not found"})
            return
        if not getattr(p, "migrate_to", None):
            h._send(400, {"error": f"model {name!r} does not support "
                                   "migration"})
            return
        q = parse_qs(urlsplit(h.path).query)
        peer = (q.get("peer") or [""])[0]
        reason = (q.get("reason") or ["manual"])[0]
        if not peer:
            h._send(400, {"error": "peer=URL is required"})
            return
        try:
            stats = p.migrate_to(peer, reason=reason)
        except ValueError as e:
            h._send(400, {"error": str(e)})
            return
        except Exception as e:
            h._send(500, {"error": str(e)})
            return
        h._send(200, stats)

    def _handle_kvpeers(self, h, name: str) -> None:
        """Replace this replica's decode-peer URL set (body: JSON list),
        pushed every reconcile: peer ports change on respawn."""
        p = self.predictors.get(name)
        if p is None:
            h._send(404, {"error": f"model {name!r} not found"})
            return
        if not getattr(p, "set_kv_peers", None):
            h._send(400, {"error": f"model {name!r} does not support KV "
                                   "peers"})
            return
        try:
            n = int(h.headers.get("Content-Length", 0))
            p.set_kv_peers(json.loads(h.rfile.read(n).decode() or "[]"))
        except (ValueError, UnicodeDecodeError) as e:
            h._send(400, {"error": str(e)})
            return
        h._send(200, {"peers": len(p.kv_peers)})

    def _handle_evict(self, h, name: str) -> None:
        """Operator scale-to-zero push: drop an idle pooled model's weight
        slot (body: {"model": name}). Best-effort: a slot held by in-flight
        requests (or the pinned default) stays resident and the answer
        says so, for the operator to retry on its next reconcile."""
        p = self.predictors.get(name)
        if p is None:
            h._send(404, {"error": f"model {name!r} not found"})
            return
        if not getattr(p, "pooled_models", lambda: {})():
            h._send(400, {"error": f"model {name!r} does not host a "
                                   "weight pool"})
            return
        try:
            n = int(h.headers.get("Content-Length", 0))
            body = json.loads(h.rfile.read(n).decode() or "{}")
            target = body.get("model", "")
        except (ValueError, UnicodeDecodeError, AttributeError) as e:
            h._send(400, {"error": str(e)})
            return
        if not isinstance(target, str) or not target:
            h._send(400, {"error": "body must carry a model name"})
            return
        h._send(200, {"model": target,
                      "evicted": bool(p.evict_model(target))})

    def _send_sse(self, h, events) -> None:
        """Stream SSE events over a chunked HTTP/1.1 response. The
        predictor validated and submitted before handing over the
        iterator, so admission failures reach the client as a 400/503
        above; once headers are out, failures ride the in-band ``event:
        error`` frame. A client hangup just ends the relay (the engine
        request completes on its own)."""
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

    # -- flight recorder ----------------------------------------------------
    def _flight_payloads(self, attr: str) -> Dict[str, Any]:
        """{model: payload} of each predictor's ``attr`` (flight_snapshot
        or flight_requests) that has a recorder."""
        out = {}
        for name, p in self.predictors.items():
            fn = getattr(p, attr, None)
            payload = fn() if fn is not None else None
            if payload is not None:
                out[name] = payload
        return out

    def _maybe_snapshot_flight(self) -> None:
        """Persist the newest flight snapshot to
        ``$KFX_WORKDIR/flight/<KFX_COMPONENT>-<pid>.json`` (atomic
        replace), at most once every KFX_FLIGHT_SNAP_S seconds (default 1;
        "0" disables): the file a crash-reap bundles when the replica died
        without answering HTTP."""
        workdir = os.environ.get("KFX_WORKDIR", "")
        if not workdir:
            return
        try:
            period = float(os.environ.get("KFX_FLIGHT_SNAP_S", "1"))
        except ValueError:
            period = 1.0
        if period <= 0:
            return
        now = time.monotonic()
        if now - self._flight_snap_ts < period:
            return
        self._flight_snap_ts = now
        snaps = self._flight_payloads("flight_snapshot")
        if not snaps:
            return
        comp = os.environ.get("KFX_COMPONENT", "server")
        d = os.path.join(workdir, "flight")
        path = os.path.join(d, f"{comp}-{os.getpid()}.json")
        try:
            os.makedirs(d, exist_ok=True)
            tmp = f"{path}.tmp"
            with open(tmp, "w") as f:
                json.dump({"models": snaps, "pid": os.getpid()}, f)
            os.replace(tmp, path)
        except OSError:
            pass  # snapshotting must never fail the probe

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "ModelServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="kfx-modelserver")
        self._thread.start()
        return self

    def stop(self) -> None:
        for b in self.batchers.values():
            b.close()
        self.httpd.shutdown()
        self.httpd.server_close()


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="kfx model server (GPU)")
    p.add_argument("--model-dir", required=True,
                   help="export directory (storageUri)")
    p.add_argument("--name", default="model")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max-batch-size", type=int, default=None,
                   help="classifiers default 64 (request bucketing); LMs "
                        "default 8 (the decode engine's slots)")
    p.add_argument("--device", default="auto",
                   choices=["auto", "default", "cuda", "cpu"],
                   help="auto/default mean cuda")
    p.add_argument("--batcher-max-latency-ms", type=float, default=0.0,
                   help=">0 enables the micro-batcher")
    p.add_argument("--batcher-reply-timeout-s", type=float, default=60.0)
    p.add_argument("--batcher-workers", type=int, default=1,
                   help=">1 lets a batch dispatch while another is in "
                        "flight")
    p.add_argument("--framework", default="auto",
                   choices=["auto", "jax", "pytorch", "tensorflow",
                            "sklearn", "lm"],
                   help="predict backend; auto sniffs the export format")
    args = p.parse_args(argv)

    from .export import CONFIG_FILE
    from .lm_server import LMPredictor, is_lm_export
    from .sklearn_server import SKLearnPredictor, is_sklearn_export
    from .tf_server import TFPredictor, is_tf_export
    from .torch_server import TorchPredictor, is_torch_export

    sniff = {"lm": is_lm_export, "pytorch": is_torch_export,
             "tensorflow": is_tf_export, "sklearn": is_sklearn_export,
             "jax": lambda d: os.path.exists(os.path.join(d, CONFIG_FILE))}
    framework = args.framework
    if framework == "auto":
        framework = next((fw for fw, has in sniff.items()
                          if has(args.model_dir)), "jax")
    if not sniff[framework](args.model_dir):
        print(f"error: {args.model_dir} holds no export"
              + ("" if args.framework == "auto"
                 else f" for --framework {framework}"), file=sys.stderr)
        return 2
    if framework in ("tensorflow", "sklearn") and args.device not in (
            "auto", "cpu"):
        print(f"warning: --device={args.device} ignored ({framework} "
              f"backend runs CPU here)", flush=True)
    if args.max_batch_size is None:
        args.max_batch_size = 8 if framework == "lm" else 64
    if framework == "lm":
        predictor = LMPredictor(args.model_dir, name=args.name,
                                max_batch_size=args.max_batch_size,
                                device=args.device)
    elif framework == "pytorch":
        predictor = TorchPredictor(args.model_dir, name=args.name,
                                   max_batch_size=args.max_batch_size,
                                   device=args.device)
    elif framework == "tensorflow":
        predictor = TFPredictor(args.model_dir, name=args.name,
                                max_batch_size=args.max_batch_size)
    elif framework == "sklearn":
        predictor = SKLearnPredictor(args.model_dir, name=args.name,
                                     max_batch_size=args.max_batch_size)
    else:
        predictor = JaxPredictor(args.model_dir, name=args.name,
                                 max_batch_size=args.max_batch_size,
                                 device=args.device)
    t0 = time.time()
    predictor.load()
    server = ModelServer(port=args.port)
    batcher = None
    if args.batcher_max_latency_ms > 0:
        batcher = {"maxBatchSize": args.max_batch_size,
                   "maxLatencyMs": args.batcher_max_latency_ms,
                   "replyTimeoutS": args.batcher_reply_timeout_s,
                   "workers": args.batcher_workers}
    server.register(predictor, batcher)
    server.start()
    line = (f"server_ready name={args.name} port={server.port} "
            f"framework={framework} "
            f"load_seconds={time.time() - t0:.1f} "
            f"device={predictor.device} ")
    if framework == "lm":
        engine = predictor.engine
        line += (f"engine={'on' if engine is not None else 'off'} "
                 f"spec={'on' if engine is not None and engine.spec else 'off'}")
    else:
        line += (f"placement="
                 f"{json.dumps(getattr(predictor, 'placement', {}))} "
                 f"probe_ms={json.dumps(getattr(predictor, 'probe_ms', {}))}")
    print(line, flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()
        close = getattr(predictor, "close", None)
        if close is not None:
            close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
