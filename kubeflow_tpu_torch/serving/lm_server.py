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

The port serves the reference's ONE-SHOT path: the LMGenerator
(models/generate.py), run to completion per request — what the
reference runs with ``KFX_LM_ENGINE=0`` and the greedy-parity oracle its
engine is held to. The reference's default is the continuous-batching
DecodeEngine; the port does not have it yet (ROADMAP.md Queue A 5), so
with ``KFX_LM_ENGINE`` unset it serves one-shot, and every engine-only
knob that is set explicitly (``KFX_LM_ENGINE`` other than 0,
``KFX_LM_ADAPTERS``, ``KFX_LM_MODELS``, ``KFX_LM_QUANT`` / ``_KV_QUANT``
other than 0, ``KFX_LM_ROLE`` other than mixed, ``KFX_LM_KV_PEERS``)
raises ``NotImplementedError`` rather than being ignored. So does an
int8 export, and the body fields ``stop_token``, ``adapter`` and
``model`` are a 400, as on the reference's one-shot path.

Tokenization is caller-side.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

from ..models.transformer import TransformerConfig
from ..obs.metrics import default_registry
from . import _msgpack
from .export import FORMAT_VERSION
from .server import Predictor

CONFIG_FILE = "lm_config.json"
PARAMS_FILE = "params.msgpack"

_ENGINE = "ROADMAP.md Queue A 5, the engine"
_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32"}


def _sorted(tree):
    """The tree with every dict's keys in sorted order: the order
    ``jax.device_get`` leaves a flax tree in, so the port's file is the
    reference's byte for byte."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def export_lm(directory: str, cfg: TransformerConfig, params,
              quantize: str = "") -> str:
    """Write a servable LM export from a config and the reference's param
    tree (nested dicts of numpy arrays; ``models.convert.params_to_jax``
    makes one from a ``state_dict``)."""
    if quantize not in ("", "int8"):
        raise ValueError(
            f"unknown quantize {quantize!r} (expected '' or 'int8')")
    if quantize:
        raise NotImplementedError(
            f"int8 LM exports are not ported yet ({_ENGINE})")
    os.makedirs(directory, exist_ok=True)
    d = dataclasses.asdict(cfg)
    d["dtype"] = _DTYPE_NAMES[cfg.dtype]
    d["param_dtype"] = _DTYPE_NAMES[cfg.param_dtype]
    meta = {"framework": "lm", "format_version": FORMAT_VERSION,
            "config": d}
    with open(os.path.join(directory, CONFIG_FILE), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(directory, PARAMS_FILE), "wb") as f:
        _msgpack.dump(_sorted(params), f)
    return directory


def load_lm(directory: str):
    """Load an LM export -> (TransformerConfig, param tree). v1 exports
    (no ``format_version``, no quant knobs) load with the config's
    defaults; an int8 export is refused before its params are read."""
    with open(os.path.join(directory, CONFIG_FILE)) as f:
        meta = json.load(f)
    d = dict(meta["config"])
    if meta.get("quant") or d.get("quant"):
        raise NotImplementedError(
            f"{directory} is an int8 (quant) LM export; serving int8 "
            f"weights is not ported yet ({_ENGINE})")
    d.setdefault("dtype", "bfloat16")
    d.setdefault("param_dtype", "float32")
    cfg = TransformerConfig(**d)
    params = _msgpack.load(os.path.join(directory, PARAMS_FILE))
    return cfg, params


def is_lm_export(model_dir: str) -> bool:
    return os.path.exists(os.path.join(model_dir, CONFIG_FILE))


def _refuse_engine_knobs() -> None:
    """Raise on an explicitly set knob that only the engine reads."""
    env = os.environ.get
    knobs = (
        ("KFX_LM_ENGINE", env("KFX_LM_ENGINE", "0") != "0"),
        ("KFX_LM_ADAPTERS", bool(env("KFX_LM_ADAPTERS", ""))),
        ("KFX_LM_MODELS", bool(env("KFX_LM_MODELS", ""))),
        ("KFX_LM_QUANT", env("KFX_LM_QUANT", "0") not in ("", "0")),
        ("KFX_LM_KV_QUANT", env("KFX_LM_KV_QUANT", "0") not in ("", "0")),
        ("KFX_LM_ROLE", env("KFX_LM_ROLE", "mixed") != "mixed"),
        ("KFX_LM_KV_PEERS", bool(env("KFX_LM_KV_PEERS", ""))),
    )
    for name, set_ in knobs:
        if set_:
            raise NotImplementedError(
                f"{name}={env(name)!r} needs the continuous-batching "
                f"decode engine, which is not ported yet ({_ENGINE}); "
                "the port serves the one-shot path (unset it, or "
                "KFX_LM_ENGINE=0)")


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
    by default ("auto" and "default" mean "cuda") or "cpu"."""

    def __init__(self, model_dir: str, name: str = "",
                 max_batch_size: int = 8, device: str = "cuda"):
        _refuse_engine_knobs()
        self.model_dir = model_dir
        self.name = name or "model"
        self.max_batch_size = max_batch_size
        self.device = "cuda" if device in ("auto", "default") else device
        self._gen = None
        self._rate = _RateWindow()
        self._warm_count = 0
        self.vocab_size = 0
        # Replaced with the hosting ModelServer's registry at register()
        # time so decode throughput shows up on that server's /metrics.
        self.metrics = default_registry()

    def load(self) -> None:
        from ..models.generate import LMGenerator

        cfg, params = load_lm(self.model_dir)
        self.vocab_size = cfg.vocab_size
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

    def _set_warm(self, n: int) -> None:
        self._warm_count = n
        self.metrics.gauge(
            "kfx_lm_warm_buckets",
            "Prompt buckets with compiled decode paths.").set(
                n, model=self.name)

    def on_metrics_attached(self) -> None:
        """ModelServer.register swapped ``self.metrics``: re-seed the
        load-time gauge onto the new registry so a scrape before the
        first request sees it."""
        if self._warm_count:
            self._set_warm(self._warm_count)

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
        if len(prompts) > self.max_batch_size:
            raise ValueError(f"batch {len(prompts)} exceeds max_batch_size "
                             f"{self.max_batch_size}")
        for p in prompts:
            arr = np.asarray(p)
            if arr.size == 0 or arr.min() < 0 or \
                    arr.max() >= self.vocab_size:
                raise ValueError(
                    f"prompt token ids must be in [0, {self.vocab_size})")
        # Engine-only fields: the reference's one-shot path answers 400.
        if body.get("stop_token") is not None:
            int(body["stop_token"])
            raise ValueError("stop_token requires the engine path "
                             "(KFX_LM_ENGINE=1)")
        for field, what in (("adapter", "adapter name"),
                            ("model", "model name")):
            v = body.get(field)
            if v is not None and not isinstance(v, str):
                raise ValueError(f"{field} must be a string {what}")
            if v is not None:
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
            "kw": dict(
                max_new_tokens=int(body.get("max_new_tokens", 32)),
                temperature=float(body.get("temperature", 0.0)),
                top_k=int(body.get("top_k", 0)),
                seed=int(body.get("seed", 0))),
        }

    def _record_generate(self, n_tokens: int, elapsed: float) -> None:
        self._rate.record(n_tokens)
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

    def _run(self, p: Dict[str, Any]) -> Tuple[List[List[int]], float]:
        t0 = time.perf_counter()
        out = self._gen.generate(p["prompts"], **p["kw"])
        elapsed = time.perf_counter() - t0
        self._record_generate(sum(len(ids) for ids in out), elapsed)
        return out, elapsed

    def generate(self, body: Dict[str, Any]) -> Dict[str, Any]:
        out, elapsed = self._run(self._parse_generate(body))
        n_tokens = sum(len(ids) for ids in out)
        tps = n_tokens / elapsed if elapsed > 0 else 0.0
        return {"generated_tokens": out,
                "tokens_per_second": round(tps, 2)}

    def generate_stream(self, body: Dict[str, Any]) -> Iterator[bytes]:
        """SSE token streaming, the reference's one-shot form: validate,
        generate fully, then replay the tokens as events (same wire
        contract as the engine's stream, no incremental delivery):

            data: {"index": i, "token": t}\\n\\n      per token
            data: {"done": true, "n_tokens": N, ...}\\n\\n

        ``stream_skip`` suppresses the first N tokens (the router's
        mid-stream recovery knob); indices keep counting from 0."""
        p = self._parse_generate(body)
        if len(p["prompts"]) != 1:
            raise ValueError("streaming serves exactly one prompt "
                             "per request")
        skip = body.get("stream_skip", 0)
        if isinstance(skip, bool) or not isinstance(skip, int) \
                or skip < 0:
            raise ValueError("stream_skip must be an int >= 0")
        out, elapsed = self._run(p)
        return iter(self._replay_events(out[0], skip, elapsed))

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
