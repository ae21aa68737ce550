"""Drives the port's serving path: ``DecodeEngine.submit`` of
``kubeflow_tpu_torch/serving/engine.py``, the engine
``serving/lm_server.py`` wraps, under a closed loop of clients.

Set-up draws the weights from the seed on the card in the served dtype,
builds the engine with the configuration's settings, runs its ``warm``
at the prompt buckets this mix can reach, and starts the clients. Each
client sends its next request (greedy, from the stream of the mix's
generator, ``generators/<kind>.py``) when the previous one completes and
stamps each token as the engine's streaming sink hands it over. The
window opens once every client has its first token, so that every slot
is decoding (a decode step costs the same whatever the requests'
lengths: it gathers each slot's whole ``max_seq_len`` view), and lasts
``--seconds``.
After it the clients go on until every request submitted in the window
has its first token and tokens have reached a client after the close
(at most ``DRAIN_S`` more); then the engine closes.

The comparison takes, of the requests the window finished, the longest
and a seeded sample of the others, and runs the reference over each
prompt with its served tokens, in float32 from the same weights, once the
engine is freed.
"""

from __future__ import annotations

import dataclasses
import gc
import glob
import json
import math
import os
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from kfxbench.core import bench, compare, traffic, weights
from kfxbench.core.devtrace import DeviceTrace
from kfxbench.reference import lm as ref_lm

# Seconds past the window's close that a request submitted in it may
# take to its first token, and the engine to its next delivery.
DRAIN_S = 60.0
# Seconds of the window's end the profiler covers in a traced run.
TRACE_S = 6.0
# Requests the window finished that the comparison reads: the longest and
# a seeded sample.
CHECK_REQUESTS = 6
# Seconds the clients may take to their first tokens.
OPEN_LIMIT_S = 240.0


@dataclasses.dataclass
class Record:
    """One request as its client saw it (``time.monotonic`` stamps)."""

    client: int
    prompt: List[int]
    t_submit: float
    times: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    t_done: float = 0.0
    error: Optional[str] = None
    t_error: float = 0.0
    error_in_run: bool = False


def model_config(cfg: dict):
    from kubeflow_tpu_torch.models.transformer import TransformerConfig

    port = cfg["port"]
    return TransformerConfig(
        vocab_size=cfg["vocab_size"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"], head_dim=weights.head_dim(cfg),
        n_layers=cfg["num_hidden_layers"], d_ff=cfg["intermediate_size"],
        max_seq_len=cfg["max_position_embeddings"], dtype=port["dtype"],
        param_dtype=port["param_dtype"])


def build(ctx, w):
    from kubeflow_tpu_torch.obs.metrics import MetricsRegistry
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    return DecodeEngine(model_config(ctx.config), w, device=ctx.device,
                        name=ctx.config["name"], registry=MetricsRegistry(),
                        **ctx.config["port"]["engine"])


def warm_buckets(lo: int, hi: int, max_len: int) -> List[int]:
    """The power-of-two prefill buckets that prompt tails of ``lo`` to
    ``hi`` tokens reach."""
    out, b = [], 8
    while b < lo:
        b *= 2
    while True:
        out.append(min(b, max_len))
        if b >= hi or b >= max_len:
            return out
        b *= 2


class Clients:
    """The closed loop: one thread a client."""

    def __init__(self, engine, loop):
        self.engine = engine
        self.loop = loop
        self.records: List[Record] = []
        self.lock = threading.Lock()
        self.stop = threading.Event()
        self.threads = [threading.Thread(target=self._client, args=(c,),
                                         daemon=True)
                        for c in range(loop.clients)]

    def start(self) -> None:
        for t in self.threads:
            t.start()

    def _client(self, c: int) -> None:
        for prompt, max_new in self.loop.stream(c):
            if self.stop.is_set():
                return
            rec = Record(c, prompt, time.monotonic())

            def sink(tok, rec=rec):
                if tok is not None:
                    rec.times.append(time.monotonic())

            with self.lock:
                self.records.append(rec)
            try:
                req = self.engine.submit(prompt, max_new, temperature=0.0,
                                         on_token=sink)
                rec.tokens = req.result()
                rec.t_done = time.monotonic()
            except Exception as e:  # a failed request is counted, not fatal
                rec.error = f"{type(e).__name__}: {e}"
                rec.t_error = time.monotonic()

    def join(self, timeout: float = 30.0) -> None:
        for t in self.threads:
            t.join(timeout)


def sample(records: List[Record], seed: int, t_open: float,
           t_close: float) -> List[Record]:
    done = [r for r in records if r.error is None and r.tokens
            and t_open <= r.t_done <= t_close]
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: len(done[i].tokens))
    rest = [i for i in range(len(done)) if i != longest]
    rng = np.random.default_rng([traffic.seed64(seed), 7])
    pick = rng.choice(len(rest), size=min(CHECK_REQUESTS - 1, len(rest)),
                      replace=False) if rest else []
    return [done[longest]] + [done[rest[i]] for i in pick]


def reference_gaps(w, picked: List[Record], precision: str = "f32"
                   ) -> dict:
    """The reference's logits over the picked requests, the program's
    widest served-token gap and, with ``precision`` other than f32, the
    widest gap of the tokens that precision puts first."""
    if not picked:
        return {"logit_gap": math.inf}
    ref_lm.no_tf32()
    seqs = [(r.prompt, r.tokens) for r in picked]
    ref = ref_lm.served_logits(w, seqs, ref_lm.Matmul("f32"))
    out = {"logit_gap": max(ref_lm.served_gaps(ref, [r.tokens
                                                     for r in picked]))}
    if precision != "f32":
        low = ref_lm.served_logits(w, seqs, ref_lm.Matmul(precision))
        firsts = [lg.argmax(-1).tolist() for lg in low]
        out["control_gap"] = max(ref_lm.served_gaps(ref, firsts))
    return out


def window_summary(records: List[Record], t_open: float,
                   t_close: float) -> dict:
    """The run's requests and tokens, as the metrics read them."""
    rows = [{"n_prompt": len(r.prompt), "t_submit": r.t_submit,
             "times": list(r.times), "t_done": r.t_done,
             "failed": r.error_in_run} for r in records]
    return {"t_open": t_open, "t_close": t_close, "requests": rows}


def chunk_spans(wall_open: float, wall_close: float) -> List[dict]:
    """The ``engine.chunk`` spans this process wrote that started in the
    window (``obs/trace.py``'s sink under ``KFX_WORKDIR``), as (start,
    seconds, decode steps)."""
    out = []
    workdir = os.environ.get("KFX_WORKDIR", "")
    if not workdir:
        return out
    for path in glob.glob(os.path.join(workdir, "spans",
                                       f"*-{os.getpid()}*.jsonl")):
        with open(path) as f:
            for line in f:
                sp = json.loads(line)
                if sp["name"] == "engine.chunk" and \
                        wall_open <= sp["ts"] < wall_close:
                    out.append({"ts": sp["ts"], "dur": sp["dur"],
                                "steps": int(sp["attrs"]["k"])})
    return out


def run(ctx, precision: str = "f32") -> dict:
    cfg, mix = ctx.config, ctx.traffic
    cuda = ctx.device.type == "cuda"
    w = weights.make(cfg, ctx.seed, getattr(torch, cfg["port"]["param_dtype"]),
                     ctx.device)
    t_weights = time.perf_counter()
    engine = build(ctx, w)
    loop = bench.generator(mix["kind"]).requests(mix, cfg["vocab_size"],
                                                 ctx.seed)
    engine.warm(warm_buckets(*loop.prefill_range(),
                             cfg["max_position_embeddings"]))
    t_warm = time.perf_counter()
    clients = Clients(engine, loop)
    clients.start()
    give_up = time.monotonic() + OPEN_LIMIT_S
    while True:
        with clients.lock:
            started = len({r.client for r in clients.records if r.times})
        if started == loop.clients:
            break
        if time.monotonic() > give_up:
            raise RuntimeError(
                f"{started} of {loop.clients} clients had a first token "
                f"after {OPEN_LIMIT_S} s: the window cannot open")
        time.sleep(0.01)
    t_open = time.monotonic()
    wall_open = time.time()
    setup_s = time.perf_counter() - ctx.t0
    prefix0 = engine.prefix_stats()
    t_close = t_open + ctx.seconds
    tracer = DeviceTrace(ctx.tmpdir) if ctx.trace and cuda else None
    if tracer is not None:
        time.sleep(max(0.0, t_close - TRACE_S - time.monotonic()))
        tracer.start()
    time.sleep(max(0.0, t_close - time.monotonic()))
    prefix1 = engine.prefix_stats()
    wall_close = time.time()
    if tracer is not None:
        tracer.stop()
    deadline = t_close + DRAIN_S
    while time.monotonic() < deadline:
        with clients.lock:
            waiting = any(t_open <= r.t_submit < t_close and not r.times
                          and r.error is None for r in clients.records)
            delivered = any(r.times and r.times[-1] > t_close
                            for r in clients.records)
        if delivered and not waiting:
            break
        time.sleep(0.05)
    clients.stop.set()
    t_engine_close = time.monotonic()
    pages = engine.page_stats()
    engine.close()
    clients.join()
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    with clients.lock:
        records = list(clients.records)
    for r in records:
        r.error_in_run = r.error is not None and r.t_error < t_engine_close
    chunks = chunk_spans(wall_open, wall_close)
    picked = sample(records, ctx.seed, t_open, t_close)
    del engine, clients
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    gaps = reference_gaps(w, picked, precision)
    window = window_summary(records, t_open, t_close)
    in_window = [q for q in window["requests"]
                 if t_open <= q["t_submit"] < t_close]
    notes = {"weights_s": t_weights - ctx.t0,
             "engine_warm_s": t_warm - t_weights,
             "first_requests_s": setup_s - (t_warm - ctx.t0),
             "submitted_in_window": len(in_window),
             "first_tokens_in_window": sum(1 for q in in_window
                                           if q["times"]),
             "completed_in_window": sum(1 for q in window["requests"]
                                        if t_open <= q["t_done"] <= t_close),
             "chunks_in_window": len(chunks), "pages": pages,
             "checked_requests": len(picked),
             "checked_tokens": sum(len(r.tokens) for r in picked),
             "reference_s": time.perf_counter() - t_ref}
    return {
        "notes": notes,
        "setup_s": setup_s, "window_s": t_close - t_open,
        "attempted": len(in_window),
        "failed": sum(q["failed"] for q in in_window),
        "checks": compare.checks({"logit_gap": gaps["logit_gap"]},
                                 ctx.limits),
        "control_gap": gaps.get("control_gap"),
        "memory_peak_bytes": peak,
        "trace": tracer.summary() if tracer is not None else None,
        "serve": dict(window, wall_open=wall_open, wall_close=wall_close,
                      prefix=(prefix0, prefix1), config=cfg, chunks=chunks),
    }
