"""LM serving: text generation behind the model server — port of
``kubeflow_tpu/serving/lm_server.py``.

Export format (``export_lm``): ``lm_config.json`` (the TransformerConfig,
dtypes as names) + ``params.msgpack`` (the reference's flax param tree in
flax's msgpack layout). Each package reads the other's exports. The
predictor serves a ``:generate`` verb:

    POST /v1/models/{m}:generate
    {"prompt_tokens": [[1,2,3], ...], "max_new_tokens": 32,
     "temperature": 0.7, "top_k": 40, "seed": 1}
    -> {"generated_tokens": [[...], ...], "tokens_per_second": ...}

``KFX_LM_ENGINE`` (default "1", as in the reference) serves through the
continuous-batching DecodeEngine (serving/engine.py: paged KV pool,
prefix cache, chunked prefill, preemption, speculative decoding, usage
metering), configured by
``KFX_LM_ENGINE_CHUNK`` (decode steps a chunk, 8), ``KFX_LM_KV_PAGE_SIZE``
(32), ``KFX_LM_KV_PAGES`` (0 = the dense layout's memory),
``KFX_LM_PREFIX_CACHE`` (1), ``KFX_LM_PREFILL_CHUNK`` (256; 0 =
monolithic) and ``KFX_LM_STALL_S`` (10, the /healthz wedge threshold);
``max_batch_size`` is its slot count and the body field ``stop_token``
is legal. ``KFX_LM_ENGINE=0`` serves the ONE-SHOT path instead — the
LMGenerator (models/generate.py), run to completion per request, the
greedy-parity oracle the engine is held to — where ``stop_token`` is a
400, as in the reference.

Speculative decoding is on by default, as in the reference, for LMs of 2
or more layers: ``KFX_LM_SPEC`` (default "1"; "0" turns it off), a draft
of ``KFX_LM_SPEC_LAYERS`` layers (0 = ``max(1, n_layers // 4)``, capped
at ``n_layers - 1``) proposing ``KFX_LM_SPEC_TOKENS`` tokens (4) from a
pool of ``KFX_LM_SPEC_PAGES`` pages (0 = the target's page count); greedy
output is the same either way. Every engine keeps the per-tenant usage
ledger, and the predictor seeds the default tenant's row, so
``kfx_tenant_requests_total`` and ``kfx_tenant_tokens_total`` show before
any traffic; the body field ``tenant`` names the billable tenant and
``stream_skip`` is not billed again.

The flight recorder is on by default, as in the reference
(``KFX_FLIGHT``, "0" turns it off; ``KFX_FLIGHT_RING``,
``KFX_FLIGHT_RECENT``): each ``:generate`` answer carries a ``timing``
list (one ``{queue_wait_s, prefill_s, decode_s, stalled_s, spec_accept}``
per prompt; the server folds the first into the ``X-Kfx-Timing``
header), each streamed ``done`` event its request's ``timing``, and the
server answers ``/debug/flight`` and ``/debug/requests``. With the
one-shot path or the recorder off there is no ``timing``.

Quantization, as in the reference: ``export_lm(..., quantize="int8")``
writes int8 kernels with per-output-channel f32 scales and
``config.quant = "int8"``. ``KFX_LM_QUANT`` empty follows the export,
``int8`` quantizes a full-precision export at load, ``0`` dequantizes an
int8 export and serves full precision; ``KFX_LM_KV_QUANT=int8`` stores
the engine's paged KV as int8 (the one-shot path keeps its dense
full-precision cache); ``KFX_LM_QUANT_DRAFT=int8`` quantizes only the
speculative draft. ``KFX_CHAOS`` activates the chaos points (``chaos``).

Multi-tenant LoRA, as in the reference: ``KFX_LM_ADAPTERS`` is a JSON
object ``{name: artifact URI}`` (serving/export.py ``export_adapter``)
served over the base export by the engine's adapter pool, sized by
``KFX_LM_ADAPTER_SLOTS`` (8) and ``KFX_LM_ADAPTER_RANK`` (0 = the largest
rank the artifacts declare); ``KFX_LM_ADAPTER_DEFAULT`` applies when a
body names none and ``KFX_LM_ADAPTER_FALLBACK`` ("base" or "error") is
the load-failure policy. The body field ``adapter`` selects one: absent
means the default, "" the base; an unknown name or a non-string is a
400, and so is any ``adapter`` on the one-shot path.

The request plane, as in the reference: ``KFX_LM_QOS_DEFAULT``
("interactive" or "batch"), ``KFX_LM_DEADLINE_MS`` (0 = none),
``KFX_LM_RATE_LIMITS`` (a JSON object ``{adapter tenant: tokens/s}``, ""
the base) and ``KFX_LM_RATE_BURST_S`` (2); the body fields ``qos`` and
``deadline_ms`` (the server merges the ``X-KFX-Deadline-Ms`` header into
the latter) override them per request, and a request's deadline is also
its result-wait clock (under the router's 60 s backend timeout).

The KV transfer plane (serving/kvtransfer.py): ``KFX_LM_ROLE``
("prefill" ships each finished prompt's pages to a decode peer, "decode"
receives them, "mixed" does both locally), ``KFX_LM_KV_PEERS`` (a JSON
list of peer base URLs; the server's ``:kvpeers`` verb replaces it) and
``KFX_LM_KV_OFFLOAD_PAGES`` (0 = no host-RAM offload tier). ``kv_import``
adopts a migrated generation and indexes it by its resume key, so the
re-dispatched ``:generate`` body attaches to it instead of recomputing;
``migrate_to`` pushes every in-flight generation to a peer.

The multi-model weight pool (serving/weights.py), as in the reference:
``KFX_LM_MODELS`` is a JSON object ``{name: LM export URI}`` of
same-architecture checkpoints time-sharing the engine,
``KFX_LM_MODEL_DEFAULT`` names the resident one (the model ``model_dir``
points at; required with ``KFX_LM_MODELS``), ``KFX_LM_WEIGHT_SLOTS`` sizes
the slot pool (0 = one slot a model) and ``KFX_LM_WEIGHT_IDLE_S`` > 0
evicts models idle that long (the default stays warm). Speculation is
off with a pool. The body field ``model`` selects one (absent = the
default; unknown or non-string = 400; one-shot path 400); a failed swap
(the ``weights.load`` chaos point included) answers 503 + Retry-After.

Tokenization is caller-side.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue as _queue
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.transformer import (TransformerConfig, dequantize_params_int8,
                                  quantize_params_int8)
from ..obs.metrics import default_registry
from . import _msgpack
from . import kvtransfer
from .engine import DecodeEngine, EngineOverloaded, RequestMigrated
from .export import FORMAT_VERSION, _sorted
from .server import Predictor

CONFIG_FILE = "lm_config.json"
PARAMS_FILE = "params.msgpack"

# The router's backend timeout: a request's result wait stays under it, so
# a queue-starved request fails with an engine error, never a router 502.
_BACKEND_TIMEOUT_S = 60.0
_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32"}


def export_lm(directory: str, cfg: TransformerConfig, params,
              quantize: str = "") -> str:
    """Write a servable LM export from a config and the reference's param
    tree (nested dicts of numpy arrays; ``models.convert.params_to_jax``
    makes one from a ``state_dict``). ``quantize="int8"`` rewrites the
    attention, FFN and lm_head kernels to int8 with per-output-channel
    scales (``quantize_params_int8``), sets the exported config's
    ``quant`` and adds the ``quant`` block."""
    if quantize not in ("", "int8"):
        raise ValueError(
            f"unknown quantize {quantize!r} (expected '' or 'int8')")
    os.makedirs(directory, exist_ok=True)
    if quantize == "int8" and cfg.quant != "int8":
        params = quantize_params_int8(params)
        cfg = dataclasses.replace(cfg, quant="int8")
    d = dataclasses.asdict(cfg)
    d["dtype"] = _DTYPE_NAMES[cfg.dtype]
    d["param_dtype"] = _DTYPE_NAMES[cfg.param_dtype]
    meta: Dict[str, Any] = {"framework": "lm",
                            "format_version": FORMAT_VERSION, "config": d}
    if cfg.quant == "int8":
        meta["quant"] = {"weights": "int8",
                         "scheme": "per_channel_symmetric"}
    with open(os.path.join(directory, CONFIG_FILE), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(directory, PARAMS_FILE), "wb") as f:
        _msgpack.dump(_sorted(params), f)
    return directory


def load_lm(directory: str):
    """Load an LM export -> (TransformerConfig, param tree). v1 exports
    (no ``format_version``, no quant knobs) load with the config's
    defaults; an int8 export's config keeps ``quant="int8"``, so the
    model expects its int8 kernels and scales."""
    with open(os.path.join(directory, CONFIG_FILE)) as f:
        meta = json.load(f)
    d = dict(meta["config"])
    d.setdefault("dtype", "bfloat16")
    d.setdefault("param_dtype", "float32")
    cfg = TransformerConfig(**d)
    params = _msgpack.load(os.path.join(directory, PARAMS_FILE))
    return cfg, params


def is_lm_export(model_dir: str) -> bool:
    return os.path.exists(os.path.join(model_dir, CONFIG_FILE))


class _RateWindow:
    """Sliding-window token-rate tracker: ``kfx_lm_tokens_per_second``
    is tokens counted over the trailing window, not the last call's
    instantaneous ratio."""

    def __init__(self, window_s: float = 30.0):
        self.window_s = window_s
        self._lock = threading.Lock()
        self._events: "deque[tuple]" = deque()  # (monotonic ts, tokens)

    def record(self, n_tokens: int) -> None:
        with self._lock:
            self._events.append((time.monotonic(), n_tokens))

    def rate(self) -> float:
        now = time.monotonic()
        with self._lock:
            while self._events and self._events[0][0] < now - self.window_s:
                self._events.popleft()
            if not self._events:
                return 0.0
            total = sum(n for _, n in self._events)
            span = now - self._events[0][0]
        # Normalize by the span actually covered (floored at 1s so a
        # single fresh burst doesn't explode, capped at the window).
        return total / min(max(span, 1.0), self.window_s)


class LMPredictor(Predictor):
    """Generate-only predictor on one device (``:predict`` does not
    apply; the server routes ``:generate`` here). ``device`` is "cuda"
    by default ("auto" and "default" mean "cuda") or "cpu".

    ``KFX_LM_ENGINE`` (default on) selects the continuous-batching
    DecodeEngine with ``n_slots = max_batch_size``; with the engine the
    one-shot path's hard batch rejection becomes bounded queueing
    (``engine.max_queue``). ``=0`` serves the one-shot LMGenerator
    oracle."""

    def __init__(self, model_dir: str, name: str = "",
                 max_batch_size: int = 8, device: str = "cuda",
                 warm_buckets: Optional[Sequence[int]] = None):
        env = os.environ.get
        self.model_dir = model_dir
        self.name = name or "model"
        self.max_batch_size = max_batch_size
        self.device = "cuda" if device in ("auto", "default") else device
        self.use_engine = env("KFX_LM_ENGINE", "1") != "0"
        self.chunk_tokens = int(env("KFX_LM_ENGINE_CHUNK", "8"))
        # Paged-KV knobs: page size in tokens; pool size in pages (0 = the
        # dense layout's memory, n_slots x max_seq_len tokens — shrink to
        # cap KV memory and let admission gate on pages); prefix cache.
        self.kv_page_size = int(env("KFX_LM_KV_PAGE_SIZE", "32"))
        self.kv_pages = int(env("KFX_LM_KV_PAGES", "0"))
        self.prefix_cache = env("KFX_LM_PREFIX_CACHE", "1") != "0"
        # Chunked prefill: prompt tails longer than this admit in
        # page-multiple chunks, one per engine iteration (0 disables).
        self.prefill_chunk = int(env("KFX_LM_PREFILL_CHUNK", "256"))
        # Seconds of decode-loop stall (while busy) before the heartbeat
        # reads wedged and /healthz fails the probe.
        self.stall_threshold_s = float(env("KFX_LM_STALL_S", "10.0"))
        # Speculative decoding, on by default as in the reference (the
        # engine degrades a slot when its draft cannot help; greedy
        # output is the same either way). Layers 0 = auto (n_layers // 4,
        # at least 1); tokens = proposals a verify window; pages 0 = the
        # target pool's count.
        self.spec = env("KFX_LM_SPEC", "1") != "0"
        self.spec_layers = int(env("KFX_LM_SPEC_LAYERS", "0"))
        self.spec_tokens = int(env("KFX_LM_SPEC_TOKENS", "4"))
        self.spec_pages = int(env("KFX_LM_SPEC_PAGES", "0"))
        # Quantization: KFX_LM_QUANT "" follows the export, "int8"
        # quantizes a full-precision export at load, "0" dequantizes an
        # int8 export; KFX_LM_KV_QUANT / KFX_LM_QUANT_DRAFT "int8" (engine
        # only) store the paged KV as int8 / quantize the draft.
        self.quant = env("KFX_LM_QUANT", "")
        self.kv_quant = env("KFX_LM_KV_QUANT", "")
        self.draft_quant = env("KFX_LM_QUANT_DRAFT", "")
        # Multi-tenant LoRA: {name: artifact URI}; the default adapter of
        # a body that names none; the pool's slots; its stack rank (0 =
        # the largest the artifacts declare); the load-failure policy.
        try:
            self.adapters = json.loads(env("KFX_LM_ADAPTERS", "") or "{}")
        except ValueError as e:
            raise ValueError(
                f"KFX_LM_ADAPTERS is not valid JSON: {e}") from e
        self.adapter_default = env("KFX_LM_ADAPTER_DEFAULT", "")
        self.adapter_slots = int(env("KFX_LM_ADAPTER_SLOTS", "8"))
        self.adapter_rank = int(env("KFX_LM_ADAPTER_RANK", "0"))
        self.adapter_fallback = env("KFX_LM_ADAPTER_FALLBACK", "base")
        # Request plane: the QoS class default (the body's "qos"
        # overrides), the default deadline in ms (0 = none; the body's
        # "deadline_ms" or the X-KFX-Deadline-Ms header overrides), and
        # per-tenant token-weighted rate budgets {adapter: tokens/s} with
        # a burst window.
        self.qos_default = env("KFX_LM_QOS_DEFAULT", "interactive")
        self.deadline_default_ms = float(env("KFX_LM_DEADLINE_MS", "0"))
        try:
            self.rate_limits = json.loads(
                env("KFX_LM_RATE_LIMITS", "") or "{}")
        except ValueError as e:
            raise ValueError(
                f"KFX_LM_RATE_LIMITS is not valid JSON: {e}") from e
        self.rate_burst_s = float(env("KFX_LM_RATE_BURST_S", "2.0"))
        # KV transfer plane: this replica's disaggregation role, the
        # decode peers (a JSON list of base URLs, replaced live by
        # :kvpeers) and the host-RAM offload tier's pages (0 = none).
        self.role = env("KFX_LM_ROLE", "mixed")
        try:
            self.kv_peers = json.loads(env("KFX_LM_KV_PEERS", "") or "[]")
        except ValueError as e:
            raise ValueError(
                f"KFX_LM_KV_PEERS is not valid JSON: {e}") from e
        if not isinstance(self.kv_peers, list) or any(
                not isinstance(p, str) for p in self.kv_peers):
            raise ValueError("KFX_LM_KV_PEERS must be a JSON list of URLs")
        self.kv_offload_pages = int(env("KFX_LM_KV_OFFLOAD_PAGES", "0"))
        self.set_kv_peers(self.kv_peers)
        # Multi-model weight pool: {name: LM export URI} of checkpoints
        # time-sharing this engine (a body selects one with "model"); the
        # resident default (the model model_dir points at); the slot count
        # (0 = one slot a model); the idle eviction window (0 = never).
        try:
            self.models = json.loads(env("KFX_LM_MODELS", "") or "{}")
        except ValueError as e:
            raise ValueError(
                f"KFX_LM_MODELS is not valid JSON: {e}") from e
        if not isinstance(self.models, dict) or any(
                not isinstance(k, str) or not isinstance(v, str)
                for k, v in self.models.items()):
            raise ValueError(
                "KFX_LM_MODELS must be a JSON object "
                "{name: LM export dir}")
        self.model_default = env("KFX_LM_MODEL_DEFAULT", "")
        self.weight_slots = int(env("KFX_LM_WEIGHT_SLOTS", "0"))
        self.model_idle_s = float(env("KFX_LM_WEIGHT_IDLE_S", "0"))
        # The adopted generations by resume key.
        self._resume: Dict[str, Dict[str, Any]] = {}
        self._resume_lock = threading.Lock()
        for name, value in (("KFX_LM_QUANT", self.quant),
                            ("KFX_LM_KV_QUANT", self.kv_quant),
                            ("KFX_LM_QUANT_DRAFT", self.draft_quant)):
            if value not in ("", "0", "int8"):
                raise ValueError(
                    f"{name}={value!r}: expected '', '0' or 'int8'")
        self.warm_buckets = list(warm_buckets) if warm_buckets else None
        self._gen = None
        self._engine = None
        self._warm_thread: Optional[threading.Thread] = None
        self._rate = _RateWindow()
        self._warm_count = 0
        self.vocab_size = 0
        # Replaced with the hosting ModelServer's registry at register()
        # time so decode throughput shows up on that server's /metrics.
        self.metrics = default_registry()

    @property
    def engine(self):
        """The DecodeEngine (None on the one-shot path)."""
        return self._engine

    def load(self) -> None:
        cfg, params = load_lm(self.model_dir)
        if self.quant == "int8" and cfg.quant != "int8":
            params = quantize_params_int8(params)
            cfg = dataclasses.replace(cfg, quant="int8")
        elif self.quant == "0" and cfg.quant == "int8":
            params = dequantize_params_int8(params)
            cfg = dataclasses.replace(cfg, quant="")
        self.vocab_size = cfg.vocab_size
        if self.use_engine:
            # Draft depth: KFX_LM_SPEC_LAYERS, else a quarter of the
            # target (at least 1), always shallower than the target: a
            # 1-layer model has nothing to truncate, so it runs without.
            draft = 0
            if self.spec and cfg.n_layers > 1 and not self.models:
                # A weight pool excludes speculation (the draft derives
                # from one checkpoint): off rather than a failed start.
                draft = self.spec_layers or max(1, cfg.n_layers // 4)
                draft = min(draft, cfg.n_layers - 1)
            # registry as a thunk: register() swaps self.metrics for the
            # hosting server's registry AFTER load; the engine follows it.
            self._engine = DecodeEngine(
                cfg, params, n_slots=self.max_batch_size,
                chunk_tokens=self.chunk_tokens, name=self.name,
                registry=lambda: self.metrics,
                kv_page_size=self.kv_page_size,
                kv_pages=self.kv_pages or None,
                prefix_cache=self.prefix_cache,
                stall_threshold_s=self.stall_threshold_s,
                prefill_chunk_tokens=max(0, self.prefill_chunk),
                draft_layers=draft,
                propose_tokens=max(1, self.spec_tokens),
                draft_kv_pages=self.spec_pages or None,
                kv_quant="int8" if self.kv_quant == "int8" else "",
                draft_quant="int8" if self.draft_quant == "int8" else "",
                device=self.device,
                adapters=self.adapters or None,
                adapter_slots=self.adapter_slots,
                adapter_rank=self.adapter_rank,
                adapter_default=self.adapter_default,
                adapter_fallback=self.adapter_fallback,
                qos_default=self.qos_default,
                deadline_default_s=self.deadline_default_ms / 1000.0,
                rate_limits=self.rate_limits or None,
                rate_burst_s=self.rate_burst_s,
                role=self.role,
                # A prefill-role replica always gets a sender, even before
                # the first :kvpeers push: an empty list raises
                # TransferError and the hand-off decodes locally.
                kv_peer_send=(self._kv_send
                              if (self.kv_peers or self.role == "prefill")
                              else None),
                kv_offload_pages=max(0, self.kv_offload_pages),
                models=self.models or None,
                weight_slots=(max(0, self.weight_slots)
                              if self.models else 0),
                model_default=(self.model_default if self.models else ""),
                model_idle_s=max(0.0, self.model_idle_s))
            self._attach_usage()
            buckets = self.warm_buckets or self._engine.prompt_buckets
            # The first bucket and a decode step warm synchronously
            # (ready = one request served without a first-call stall);
            # the rest warm on a background thread, observable through
            # the kfx_lm_warm_buckets gauge.
            self._engine.warm(buckets[:1])
            self._set_warm(1)
            self.ready = True
            self._warm_thread = threading.Thread(
                target=self._warm_rest, args=(buckets[1:],), daemon=True,
                name=f"kfx-lm-warm-{self.name}")
            self._warm_thread.start()
            return
        from ..models.generate import LMGenerator

        self._gen = LMGenerator(cfg, params, device=self.device)
        L = self._gen.cfg.max_seq_len
        buckets = [b for b in (8, 16, 32, 64, 128, 256, 512, 1024, 2048)
                   if b <= max(8, L // 2)]
        # The reference compiles one program per prompt bucket and warms
        # the rest on a background thread. Eager PyTorch compiles nothing
        # per bucket, so one generate on the first bucket proves the whole
        # path before readiness, and every bucket counts as warm.
        self._gen.generate([[0] * buckets[0]], max_new_tokens=8)
        self._set_warm(len(buckets))
        self.ready = True

    def _warm_rest(self, buckets) -> None:
        done = 1
        for b in buckets:
            try:
                self._engine.warm([b])
            except Exception:
                continue  # a failed warm costs the first request, only
            done += 1
            self._set_warm(done)

    def _set_warm(self, n: int) -> None:
        self._warm_count = n
        self.metrics.gauge(
            "kfx_lm_warm_buckets",
            "Prompt buckets with compiled decode paths.").set(
                n, model=self.name)

    def on_metrics_attached(self) -> None:
        """ModelServer.register swapped ``self.metrics``: re-seed the
        load-time gauges (warm buckets, the engine's slots and pool) onto
        the new registry so a scrape before the first request sees
        them."""
        if self._warm_count:
            self._set_warm(self._warm_count)
        if self._engine is not None:
            self._engine._touch_gauges()
        self._attach_usage()

    def _attach_usage(self) -> None:
        """Project the engine's tenant ledger into the CURRENT registry (a
        collector: the ledger owns the truth), seeding the default
        tenant's zero row (the default adapter's, else the base's) so a
        scrape before any traffic already shows both ``kfx_tenant_*``
        families."""
        if self._engine is None or self._engine.usage is None:
            return
        ledger = self._engine.usage
        tenant = self.adapter_default or "base"
        ledger.seed(tenant, self.qos_default, tenant)
        self.metrics.add_collector(ledger.collect)

    def engine_heartbeat(self) -> Optional[Dict[str, Any]]:
        """Decode-loop liveness snapshot (None on the one-shot path, which
        has no persistent loop to wedge) — what turns the hosting
        server's /healthz into a real liveness probe."""
        if self._engine is None:
            return None
        return self._engine.heartbeat()

    def flight_snapshot(self) -> Optional[Dict[str, Any]]:
        """The /debug/flight payload: the engine's flight ring plus the
        current heartbeat (None without an engine or with the recorder
        off). Safe from any HTTP thread: the ring is a deque the loop
        appends to atomically."""
        if self._engine is None or self._engine.flight is None:
            return None
        return self._engine.flight.snapshot(
            heartbeat=self._engine.heartbeat())

    def flight_requests(self) -> Optional[Dict[str, Any]]:
        """The /debug/requests payload: recently retired requests with
        their latency breakdowns (None when recording is off)."""
        if self._engine is None or self._engine.flight is None:
            return None
        return self._engine.flight.requests()

    def pooled_models(self) -> Dict[str, bool]:
        """{model name: resident?} over the weight pool's full source set
        (empty without a pool). A name mapped to False is "pooled but
        unloaded": servable after one measured swap, so readiness reports
        it available rather than missing."""
        if self._engine is None:
            return {}
        return self._engine.pooled_models()

    def weight_stats(self) -> Optional[Dict[str, Any]]:
        """Weight-pool occupancy counters (None on the one-shot path)."""
        if self._engine is None:
            return None
        return self._engine.weight_stats()

    def evict_model(self, name: str) -> bool:
        """Operator scale-to-zero push: drop ``name``'s weight slot if it
        is idle (refcount 0, not the pinned default). False when unknown,
        not resident, or held by in-flight requests."""
        if self._engine is None:
            return False
        return self._engine.evict_model(name)

    def drain(self, wait_s: float = 0.0) -> bool:
        """Stop admitting and wait up to ``wait_s`` for in-flight
        generations to finish. Trivially drained on the one-shot path
        (its calls are synchronous)."""
        if self._engine is None:
            return True
        return self._engine.drain(wait_s)

    # -- KV transfer plane ----------------------------------------------------
    _RESUME_TTL_S = 120.0

    def kv_import(self, raw: bytes) -> Dict[str, Any]:
        """Adopt a migrated in-flight generation: hand the page stream to
        the engine (verify, allocate, scatter, resume) and index the live
        Request by its resume key, so the re-dispatched ``:generate``
        body claims it here instead of recomputing."""
        if self._engine is None:
            raise kvtransfer.TransferError(
                "KV import requires the engine path (KFX_LM_ENGINE=1)")
        header = kvtransfer.peek(raw)
        key = str(header.get("resume", ""))
        q: "_queue.Queue[Optional[int]]" = _queue.Queue()
        req = self._engine.kv_import(raw, on_token=q.put)
        if key:
            with self._resume_lock:
                self._prune_resume_locked()
                self._resume[key] = {"req": req, "q": q,
                                     "imported": len(req.tokens),
                                     "t": time.monotonic()}
        self.metrics.counter(
            "kfx_lm_kv_migrations_total",
            "In-flight requests migrated to a peer replica, by "
            "reason.").inc(1, model=self.name, reason="adopted")
        return {"resume": key, "tokens": len(req.tokens),
                "pages": len(header.get("blocks", []))}

    def migrate_to(self, peer: str,
                   reason: str = "manual") -> Dict[str, int]:
        """Push every in-flight generation to ``peer`` (the operator's
        migrate-before-kill hook, and the rebalancing verb). Failed
        transfers keep running here; the stats say how many moved."""
        if self._engine is None:
            return {"moved": 0, "failed": 0, "pages": 0}
        return self._engine.migrate_out(
            reason=reason, send=lambda payload: kvtransfer.post_pages(
                peer, self.name, payload))

    def _kv_send(self, payload: bytes) -> str:
        """The engine's ``kv_peer_send``: round-robin over the CURRENT peer
        list (``set_kv_peers`` replaces the sender whole), falling through
        the rest on refusal; with no peer it raises TransferError and the
        donor keeps the request."""
        sender = self._sender
        if sender is None:
            raise kvtransfer.TransferError(
                "no decode peers configured (no :kvpeers push yet)")
        return sender(payload)

    def set_kv_peers(self, peers: List[str]) -> None:
        """Replace the decode-peer URL set (live state: peer ports change
        on respawn)."""
        if not isinstance(peers, list) or any(
                not isinstance(p, str) for p in peers):
            raise ValueError("peers must be a JSON list of URLs")
        self.kv_peers = [p for p in peers if p]
        self._sender = (kvtransfer.round_robin_sender(self.kv_peers,
                                                      self.name)
                        if self.kv_peers else None)

    def _prune_resume_locked(self) -> None:
        now = time.monotonic()
        for key in [k for k, e in self._resume.items()
                    if now - e["t"] > self._RESUME_TTL_S]:
            del self._resume[key]  # an unclaimed adoption idles out

    def _claim_resume(self, key: str) -> Optional[Dict[str, Any]]:
        with self._resume_lock:
            self._prune_resume_locked()
            return self._resume.pop(key, None)

    def _resume_key_for(self, p: Dict[str, Any]) -> str:
        """The resume key of a parsed single-prompt body, with the
        engine's adapter-default resolution, so donor and receiver agree
        without a side channel."""
        adapter = p["adapter"]
        if adapter is None:
            adapter = getattr(self._engine, "adapter_default", "")
        kw = p["kw"]
        return kvtransfer.resume_key(
            p["prompts"][0], kw["max_new_tokens"], kw["temperature"],
            kw["top_k"], kw["seed"],
            -1 if p["stop"] is None else int(p["stop"]),
            str(adapter or ""))

    def close(self) -> None:
        if self._engine is not None:
            self._engine.close()

    def predict(self, instances, probabilities: bool = False
                ) -> Dict[str, Any]:
        raise NotImplementedError(
            "LM models serve :generate, not :predict")

    def _parse_generate(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """Request validation shared by the buffered and streaming paths.
        Every defect here is a client mistake (ValueError -> 400)."""
        prompts = body.get("prompt_tokens")
        if not prompts or not isinstance(prompts, list):
            raise ValueError("prompt_tokens (list of token-id lists) "
                             "is required")
        if isinstance(prompts[0], int):  # single prompt convenience
            prompts = [prompts]
        if self._engine is not None:
            if len(prompts) > self._engine.max_queue:
                raise ValueError(f"batch {len(prompts)} exceeds queue "
                                 f"capacity {self._engine.max_queue}")
        elif len(prompts) > self.max_batch_size:
            raise ValueError(f"batch {len(prompts)} exceeds max_batch_size "
                             f"{self.max_batch_size}")
        for p in prompts:
            arr = np.asarray(p)
            if arr.size == 0 or arr.min() < 0 or \
                    arr.max() >= self.vocab_size:
                raise ValueError(
                    f"prompt token ids must be in [0, {self.vocab_size})")
        stop = body.get("stop_token")
        if stop is not None:
            stop = int(stop)
            if self._engine is None:
                # The reference's one-shot path answers 400.
                raise ValueError("stop_token requires the engine path "
                                 "(KFX_LM_ENGINE=1)")
        # Per-request adapter: absent = the default adapter, "" = the
        # base; the engine answers an unknown name with a 400.
        for field, what in (("adapter", "adapter name"),
                            ("model", "model name")):
            v = body.get(field)
            if v is not None and not isinstance(v, str):
                raise ValueError(f"{field} must be a string {what}")
            if v is not None and self._engine is None:
                raise ValueError(f"{field} selection requires the engine "
                                 "path (KFX_LM_ENGINE=1)")
        qos = body.get("qos")
        if qos is not None and not isinstance(qos, str):
            raise ValueError("qos must be a string class name")
        tenant = body.get("tenant")
        if tenant is not None and not isinstance(tenant, str):
            raise ValueError("tenant must be a string")
        deadline_ms = body.get("deadline_ms")
        if deadline_ms is not None:
            if isinstance(deadline_ms, bool) \
                    or not isinstance(deadline_ms, (int, float)):
                raise ValueError("deadline_ms must be a number")
            if deadline_ms <= 0:
                raise ValueError("deadline_ms must be > 0")
        return {
            "prompts": [list(map(int, p)) for p in prompts],
            "stop": stop,
            "tenant": tenant or None,
            "adapter": body.get("adapter"),
            "model": body.get("model"),
            "qos": qos,
            "deadline_s": (float(deadline_ms) / 1000.0
                           if deadline_ms is not None else None),
            "kw": dict(
                max_new_tokens=int(body.get("max_new_tokens", 32)),
                temperature=float(body.get("temperature", 0.0)),
                top_k=int(body.get("top_k", 0)),
                seed=int(body.get("seed", 0))),
        }

    def _wait_budget_s(self, deadline_s: Optional[float]) -> float:
        """The result-wait clock: the request's own deadline when it has
        one, else the engine's ``request_timeout_s``; either way under the
        router's backend timeout."""
        cap = _BACKEND_TIMEOUT_S - 2.0
        if deadline_s is not None:
            return min(deadline_s, cap)
        return min(self._engine.request_timeout_s, cap) \
            if self._engine is not None else cap

    def _record_generate(self, n_tokens: int, elapsed: float) -> None:
        self._rate.record(n_tokens)
        if self._engine is None:
            # The engine counts emitted tokens itself, per chunk.
            self.metrics.counter(
                "kfx_lm_generated_tokens_total",
                "Tokens generated since startup.").inc(n_tokens,
                                                       model=self.name)
        self.metrics.gauge(
            "kfx_lm_tokens_per_second",
            "Decode throughput over the trailing 30s window.").set(
                round(self._rate.rate(), 2), model=self.name)
        self.metrics.histogram(
            "kfx_lm_generate_seconds",
            "Wall time of generate calls.").observe(elapsed,
                                                    model=self.name)

    def _run(self, p: Dict[str, Any]
             ) -> Tuple[List[List[int]], float, Optional[list]]:
        """Generate for the parsed body: the token lists, the seconds, and
        the engine's Request handles (None on the one-shot path), which
        the flight recorder's timing reads."""
        t0 = time.perf_counter()
        reqs = None
        if self._engine is not None:
            # A re-dispatched body whose generation migrated HERE attaches
            # to the adopted request instead of recomputing.
            entry = (self._claim_resume(self._resume_key_for(p))
                     if len(p["prompts"]) == 1 else None)
            if entry is not None:
                reqs = [entry["req"]]
            else:
                reqs = self._engine.submit_batch(
                    p["prompts"], stop_token=p["stop"], tenant=p["tenant"],
                    adapter=p["adapter"], qos=p["qos"],
                    deadline_s=p["deadline_s"], model=p["model"],
                    **p["kw"])
            deadline = time.monotonic() + self._wait_budget_s(
                p["deadline_s"])
            out = [r.result(max(0.001, deadline - time.monotonic()))
                   for r in reqs]
        else:
            out = self._gen.generate(p["prompts"], **p["kw"])
        elapsed = time.perf_counter() - t0
        self._record_generate(sum(len(ids) for ids in out), elapsed)
        return out, elapsed, reqs

    def generate(self, body: Dict[str, Any]) -> Dict[str, Any]:
        out, elapsed, reqs = self._run(self._parse_generate(body))
        n_tokens = sum(len(ids) for ids in out)
        tps = n_tokens / elapsed if elapsed > 0 else 0.0
        result = {"generated_tokens": out,
                  "tokens_per_second": round(tps, 2)}
        if reqs is not None and self._engine.flight is not None:
            # One latency breakdown per prompt, in order; the server folds
            # the first into the X-Kfx-Timing header.
            flight = self._engine.flight
            result["timing"] = [flight.timing(r) for r in reqs]
        return result

    def generate_stream(self, body: Dict[str, Any]) -> Iterator[bytes]:
        """SSE token streaming. Validates and SUBMITS synchronously —
        ValueError / EngineOverloaded raise here, before any bytes stream,
        so the server still answers a clean 400/503 — then returns an
        iterator of events:

            data: {"index": i, "token": t}\\n\\n      per token
            data: {"done": true, "n_tokens": N, ...}\\n\\n

        On the engine each token is sent as the loop emits it; the
        one-shot path generates fully, then replays the tokens (same wire
        contract). ``stream_skip`` suppresses the first N tokens (the
        router's mid-stream recovery knob); indices keep counting from
        0. A mid-stream engine failure sends an ``event: error`` frame
        and ends the stream."""
        p = self._parse_generate(body)
        if len(p["prompts"]) != 1:
            raise ValueError("streaming serves exactly one prompt "
                             "per request")
        skip = body.get("stream_skip", 0)
        if isinstance(skip, bool) or not isinstance(skip, int) \
                or skip < 0:
            raise ValueError("stream_skip must be an int >= 0")
        if self._engine is None:
            out, elapsed, _ = self._run(p)
            return iter(self._replay_events(out[0], skip, elapsed))
        budget_s = self._wait_budget_s(p["deadline_s"])
        # A re-dispatched stream whose generation migrated HERE attaches to
        # the adopted request: the tokens that traveled with the pages
        # replay first, then the adoption's queue delivers the rest.
        entry = self._claim_resume(self._resume_key_for(p))
        if entry is not None:
            return self._stream_events(entry["req"], entry["q"], skip,
                                       budget_s, prefix=entry["imported"])
        q: "_queue.Queue[Optional[int]]" = _queue.Queue()
        req = self._engine.submit(p["prompts"][0], stop_token=p["stop"],
                                  on_token=q.put, tenant=p["tenant"],
                                  meter_skip=skip, adapter=p["adapter"],
                                  qos=p["qos"], deadline_s=p["deadline_s"],
                                  model=p["model"], **p["kw"])
        return self._stream_events(req, q, skip, budget_s)

    @staticmethod
    def _sse(obj: Dict[str, Any], event: str = "") -> bytes:
        head = f"event: {event}\n" if event else ""
        return (head + "data: " + json.dumps(obj)
                + "\n\n").encode("utf-8")

    def _replay_events(self, tokens, skip: int, elapsed: float):
        for i, t in enumerate(tokens):
            if i >= skip:
                yield self._sse({"index": i, "token": int(t)})
        tps = len(tokens) / elapsed if elapsed > 0 else 0.0
        yield self._sse({"done": True, "n_tokens": len(tokens),
                         "tokens_per_second": round(tps, 2)})

    def _stream_events(self, req, q, skip: int, budget_s: float,
                       prefix: int = 0) -> Iterator[bytes]:
        t0 = time.perf_counter()
        deadline = time.monotonic() + budget_s
        seen = 0
        # An adopted generation's first ``prefix`` tokens were produced
        # before the queue attached: replay them by engine index, honoring
        # the same skip window.
        for i in range(prefix):
            if i >= skip:
                yield self._sse({"index": i, "token": int(req.tokens[i])})
            seen = i + 1
        while True:
            try:
                tok = q.get(timeout=min(
                    0.25, max(0.001, deadline - time.monotonic())))
            except _queue.Empty:
                if time.monotonic() >= deadline:
                    yield self._sse(
                        {"error": "engine did not complete the "
                                  f"request within {budget_s}s",
                         "code": 503}, event="error")
                    return
                continue
            if tok is None:
                break
            if seen >= skip:
                yield self._sse({"index": seen, "token": tok})
            seen += 1
        if req.error is not None:
            if isinstance(req.error, RequestMigrated):
                # Mid-stream migration: sever instead of erroring. The
                # server turns the iterator's exception into a hard cut,
                # the truncated stream a router's mid-stream recovery
                # retries (stream_skip = tokens relayed), and the retry
                # claims the adopted generation on the peer.
                raise ConnectionResetError(str(req.error))
            code = 503 if isinstance(req.error, EngineOverloaded) else 500
            yield self._sse({"error": str(req.error), "code": code},
                            event="error")
            return
        # Tokens notified between the last get and the sentinel are in
        # req.tokens already: emit any not streamed yet (exactly once).
        for i in range(seen, len(req.tokens)):
            if i >= skip:
                yield self._sse({"index": i, "token": req.tokens[i]})
        elapsed = time.perf_counter() - t0
        n = len(req.tokens)
        self._record_generate(n, elapsed)
        tps = n / elapsed if elapsed > 0 else 0.0
        done = {"done": True, "n_tokens": n,
                "tokens_per_second": round(tps, 2)}
        if self._engine.flight is not None:
            done["timing"] = self._engine.flight.timing(req)
        yield self._sse(done)
