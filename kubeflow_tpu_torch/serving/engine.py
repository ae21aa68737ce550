"""Continuous-batching LM decode engine — port of the core of
``kubeflow_tpu/serving/engine.py`` ``DecodeEngine``: paged KV cache plus
in-flight admission (Orca-style iteration-level scheduling; vLLM's block
manager in a fixed-shape form) with content-hashed shared-prefix reuse.

The one-shot path (models/generate.LMGenerator) runs each request to
completion, so concurrent single-prompt traffic serializes. The engine
owns ONE global pool of ``kv_pages`` pages of ``kv_page_size`` tokens
(``models/transformer.PagedKVCache``) and a per-slot block table mapping
logical blocks to physical pages:

  * pages are allocated at prefill and chunk boundaries, so a request
    holds pages only for tokens it has produced;
  * admission is gated on free pages, at iteration boundaries;
    ``n_slots`` is just the max concurrency;
  * retirement returns pages to the free list; a recycled page's
    position ids are invalidated in one batched scatter before reuse;
  * a content-hashed prefix cache keeps retired prompt pages: a request
    whose prompt starts with a cached prefix points its table at the
    refcounted pages and skips that much prefill (a partially-filled
    boundary page is shared by a device copy-on-write); cache pages are
    reclaimed LRU when the pool needs them;
  * chunked prefill (``prefill_chunk_tokens > 0``): a prompt tail longer
    than a chunk admits without a dispatch and advances by at most one
    page-multiple chunk per iteration, bounding the stall a long prompt
    puts on active decode slots;
  * when the pool runs dry mid-decode the youngest slot is preempted and
    re-queued as a recompute continuation; a request nothing in flight
    can make room for fails with ``PageAllocError`` (503 + Retry-After).

Exactness: attention masks by cached position id, and decode writes land
at the dense-equivalent location (prompt bucket + step), so greedy tokens
equal the one-shot oracle's (``KFX_LM_ENGINE=0``).

Speculative decoding (``draft_layers > 0``, Leviathan et al. ICML'23): a
layer-truncated DRAFT (``models/transformer.truncate_layers``: the
target's first ``draft_layers`` layers, sharing embed, ln_f and lm_head)
proposes ``propose_tokens`` tokens a slot from its OWN page pool (a
second BlockManager with the target's block geometry), and the target
scores the pending token and the k proposals as ONE [n_slots, k+1]
verify window. One iteration (``_spec_launch``): the pending token
(sampled from the prefill logits for a fresh slot), k masked draft
steps, the verify, the vectorised accept (accept d_i with probability
min(1, p_i(d_i)/q_i(d_i)); the first rejection samples the normalised
residual max(p - q, 0), and the bonus after k accepts samples p, the
q == 0 case of the same rule), the rollback of the rejected window
entries in both pools (position -1 stamped with the writes' location
math) and a masked draft catch-up step. Greedy acceptance is the
temperature-0 limit (one-hot p and q: an exact argmax match), so greedy
output stays the oracle's. Draft-pool exhaustion degrades THAT SLOT to
one token an iteration through the same window; target-pool exhaustion
preempts the youngest slot, freeing both pools. The reference also
degrades a slot whose draft prefill DISPATCH fails; here only a
``PageAllocError`` degrades, and a failed draft dispatch fails the
in-flight requests as every other failed dispatch does, so a device
fault is never hidden behind a lower accept rate.

What PyTorch changes: the reference compiles a prefill per prompt-tail
bucket and one ``lax.scan`` decode chunk; here the same work runs eagerly
on the loop thread. A decode chunk is ``chunk_tokens`` steps over every
slot at fixed shapes ([n_slots, 1] feed, [n_slots, L/P] tables), with the
per-slot state (position, location, active, produced count) kept on the
device for the whole chunk: the host uploads the state once and reads
the tokens and the state back once per chunk, never inside it; a
speculative iteration likewise (fixed shapes per sampling mode, one
upload, one packed read-back). Sampling is counter-based
(``sample_slots``): each slot's uniforms are a hash of (request seed,
token index, vocab id, stream), so a request's stream depends on neither
its slot nor its batch mates and survives preemption, at one set of
launches per step whatever ``n_slots`` is. Speculation draws its
proposals, accept uniforms and residual/bonus tokens from three more
streams, each indexed by the token it decides; a preempted speculating
request re-enters with its last token as the pending token (the
reference re-samples it), so its windows realign and its sampled output
is the uninterrupted run's. The streams cannot match the reference's
threefry ones; they are deterministic per seed and follow the same
distribution (greedy at T <= 0; ties at the k-th value kept).

Usage metering: every engine keeps a ``TenantLedger``
(``serving/metering.py``) billed once at first admission (prompt tokens)
and once at retirement (generated tokens less ``meter_skip``).

Flight recorder (``obs/flightrec.py``, on unless ``KFX_FLIGHT=0``, as in
the reference): one record of host state at the end of every iteration
(slots, free pages in both pools, spec counters, stall, queue depth,
preemptions) and a per-request trail (admit, prefill_chunk, preempt,
first_token, retire) folded into a latency breakdown at retirement. It
reads no tensor, so it adds no device sync to the iteration.

Quantization: a ``cfg.quant="int8"`` target serves int8 weights
(``models/transformer.QuantDense``); ``kv_quant="int8"`` stores both
pools' K/V as int8 with per-token scale planes (quantize on write,
dequantize after the gather); ``draft_quant="int8"`` quantizes only the
draft's weights (its layers truncated from the tree, then
``quantize_params_int8``), which risks nothing but the accept rate.
``quant_mode`` ("w8", "kv8", "d8" joined with "+", or "f32") and
``kv_bytes_per_token`` feed the ``kfx_lm_quant_mode`` and
``kfx_lm_kv_bytes_per_token`` gauges.

Chaos points (``chaos``), each a host-side draw that adds no device sync:
``engine.admit`` fails the admitted request; ``engine.kv_alloc`` fails a
page allocation with ``PageAllocError`` (503 + Retry-After);
``engine.wedge`` stalls the loop with work in flight (``delay`` seconds,
default 30) after recording the in-flight iteration to the flight ring;
``engine.spec_verify`` runs a full-rejection verify wave (outputs stay
exact); ``engine.kv_quant`` zeroes both int8 pools' scale planes and
drops the prefix cache.

Multi-tenant LoRA adapters (``adapters``, serving/adapters.py): an
``AdapterPool`` of ``[n_layers, adapter_slots, ...]`` A/B stacks with LRU
paging from the artifact store; each slot's adapter id ([n_slots] ints, -1
= the base) rides every prefill, decode chunk and verify window, where
``models/transformer.lora_gather_delta`` gathers each row's factors, so
one launch sequence serves a batch in which every slot wears a different
adapter and a base row is exactly the adapterless engine's. The draft
wears the same adapter through the pool's truncated stacks. The prefix
cache chains from the resolved adapter's name (cached pages hold adapter
KV), admission is fair per adapter tenant (``FairQueue``), and a failed
adapter load (the ``engine.adapter_load`` chaos point included) follows
``adapter_fallback``: "base" serves the base model and counts it,
"error" fails the request with ``AdapterLoadError`` (503 + Retry-After).

Request plane, as in the reference: each request has a QoS class
(``QOS_CLASSES``; ``qos_default``) and an optional deadline
(``deadline_default_s``, stored absolute so queue time counts). Admission
policy runs at enqueue, all or nothing and before any prefill: per-tenant
token buckets (``rate_limits`` tokens/s of prompt + max_new weight, a
``rate_burst_s`` burst; an empty budget sheds ``RateLimited`` with the
deficit as Retry-After), deadline feasibility against the trailing
queue-wait EWMA (``DeadlineInfeasible``), and batch-first shedding (queued
batch requests make room for interactive arrivals). A deadline that
expires while queued sheds at the slot boundary, before prefill; batch
slots are the first preemption victims; the ledger bills each request's
class.

KV transfer plane (``serving/kvtransfer.py``): ``migrate_out`` exports
in-flight slots (mid-decode or mid-prefill-cursor) and ships them to a
peer, detaching the local copy only after the peer's acknowledgement;
``kv_import`` verifies a page stream, checks its geometry leaf for leaf,
and installs it all or nothing in a free slot; ``role="prefill"`` hands
every freshly prefilled slot to ``kv_peer_send`` before its first decode
step (a failed hand-off decodes locally); ``kv_offload_pages`` demotes
evicted prefix pages into a host-RAM tier and promotes them back on a
chain-hash match. Slot state stays loop-thread only: every export,
import and detach runs as a control job at an iteration boundary
(``_run_on_loop``). The wire is the reference's byte for byte: a page
frame is every cache leaf's rows in the reference's flatten order
(``cached_key``, ``cached_pos``, ``cached_value``, then the int8 scale
planes), the sink page never ships, and page ids remap on import. The
``rng`` field is null: a port stream is a function of (seed, token
index), which the header carries, so a port-to-port resume needs no
stash, and an imported threefry stash is ignored.

Not in this slice (ROADMAP.md Queue A 5b.8): the weight pool.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import chaos
from ..device import resolve_device
from ..models.convert import params_to_jax
from ..models.generate import decode_config, load_decode_model, pow2_bucket
from ..models.transformer import (PagedKVCache, quantize_params_int8,
                                  truncate_layers)
from ..obs import flightrec
from ..obs import trace as obs_trace
from ..obs.metrics import MetricsRegistry, default_registry
from . import kvtransfer
from .metering import TenantLedger
from .prefix import chain_hash as _chain_hash

# Admission wait buckets (seconds): a healthy engine admits within one
# chunk; the tail is queueing behind a full pool.
QUEUE_WAIT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0)


def quant_mode_string(weights: str, kv: str) -> str:
    """The `kfx top` Q-column string from the ``kfx_lm_quant_mode``
    gauge's label values (``int8`` / ``draft-int8`` / ``f32``): one
    mapping shared by ``DecodeEngine.quant_mode`` and the server's JSON
    engine block."""
    parts = []
    if weights == "int8":
        parts.append("w8")
    elif weights == "draft-int8":
        parts.append("d8")
    if kv == "int8":
        parts.append("kv8")
    return "+".join(parts) or "f32"


def _draft_params(params, n_layers: int):
    """The first ``n_layers`` layers of ``params`` (a reference-layout
    tree or a port ``state_dict``) as a reference-layout tree: the stacked
    leaves under ``layers`` sliced, embed/ln_f/lm_head kept."""
    tree = params if any(isinstance(v, dict) for v in params.values()) \
        else params_to_jax(params)

    def cut(node):
        if isinstance(node, dict):
            return {k: cut(v) for k, v in node.items()}
        return node[:n_layers]

    return {k: cut(v) if k == "layers" else v for k, v in tree.items()}


QOS_CLASSES = frozenset({"interactive", "batch"})

# Wire names of the pool's dtypes (the reference's numpy names; bfloat16
# crosses as raw bytes, no numpy bfloat16 needed).
_WIRE_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.int8: "int8",
                torch.int32: "int32"}


class EngineOverloaded(RuntimeError):
    """Admission queue full — bounded queueing. The server maps this to
    503 + Retry-After (shed load, don't 400 a well-formed request)."""


class EngineDraining(EngineOverloaded):
    """The engine is in drain mode: it stops admitting, finishes the slots
    already decoding, and resolves queued requests with THIS error (503 +
    Retry-After; another replica can serve them)."""


class RequestMigrated(EngineOverloaded):
    """The request's KV pages were exported to a peer replica
    (serving/kvtransfer.py) and the peer is already decoding it. The
    server answers 503 with a near-zero Retry-After and an
    ``X-Kfx-Migrated`` peer hint; the re-dispatched body attaches to the
    peer's adopted generation by its resume key, or degrades to a plain
    seeded recompute where the adoption is gone."""

    def __init__(self, msg: str, peer: str = "",
                 retry_after_s: float = 0.05):
        super().__init__(msg)
        self.peer = peer
        self.retry_after_s = retry_after_s


class PageAllocError(EngineOverloaded):
    """KV page pool exhausted for a request that nothing in flight can
    unblock (the 503 + Retry-After shed contract)."""


class AdapterSlotError(PageAllocError):
    """Every adapter slot is pinned by an in-flight request: pool pressure
    like KV-page exhaustion (admission requeues behind in-flight work; a
    lone unplaceable request sheds with 503 + Retry-After), handled on
    the same code path."""


class AdapterLoadError(EngineOverloaded):
    """An adapter artifact failed to page in (unknown name, unreadable or
    mismatched artifact, or the ``engine.adapter_load`` chaos point). The
    engine's ``adapter_fallback`` serves the base instead ("base") or
    fails the request with this error ("error": 503 + Retry-After)."""


class DeadlineInfeasible(EngineOverloaded):
    """The request's deadline cannot be met, judged BEFORE prefill (at
    enqueue against the trailing queue-wait estimate, or at the slot
    boundary once it has expired): the request sheds instead of burning a
    prefill and timing out after (503 + Retry-After)."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class RateLimited(EngineOverloaded):
    """A tenant exhausted its token-weighted rate budget (``rate_limits``
    tokens/s of prompt + max_new weight, ``rate_burst_s`` of burst): 503
    with a Retry-After derived from the deficit."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class Request:
    """One in-flight generation: token budget, sampling knobs, and a
    completion event the submitting thread waits on. ``tokens`` doubles
    as the recompute-continuation state: a preempted request re-enters
    the queue with its generated ids intact and prefills
    prompt+generated on re-admission (its sampling stream is indexed by
    ``len(tokens)``, so it resumes exactly)."""

    __slots__ = ("prompt", "max_new", "temperature", "top_k", "seed",
                 "stop", "tokens", "error", "t_enqueue", "t_admitted",
                 "t_first", "t_done", "counted", "trace_id", "span_id",
                 "rid", "preempts", "on_token", "tenant", "meter_skip",
                 "events", "stall_s", "spec_prop", "spec_acc", "_flight",
                 "_usage", "_event", "adapter", "qos", "deadline")

    _rid_counter = itertools.count(1)

    def __init__(self, prompt: List[int], max_new: int, temperature: float,
                 top_k: int, seed: int, stop: int, adapter: str = "",
                 qos: str = "interactive",
                 deadline: Optional[float] = None):
        self.prompt = prompt
        self.adapter = adapter        # "" = the base model (tenant key)
        # QoS class: batch slots are the first preemption victims and
        # batch requests the first shed under queue pressure.
        self.qos = qos
        # Absolute monotonic deadline (None = none), checked BEFORE
        # prefill: an infeasible request sheds, never times out.
        self.deadline = deadline
        self.max_new = max_new
        self.temperature = temperature
        self.top_k = top_k
        self.seed = seed
        self.stop = stop              # -1 = no stop token
        # Streaming sink: called with each generated token id on the LOOP
        # thread as it lands, then with None at retirement. Recompute
        # re-prefills and never re-emits, so a token streams once.
        self.on_token: Optional[Callable[[Optional[int]], None]] = None
        self.tokens: List[int] = []   # generated ids, filled by the loop
        # Admission stats count once, at the FIRST admission: a requeued
        # preempt is recompute, not a new client admission.
        self.counted = False
        self.error: Optional[BaseException] = None
        self.t_enqueue = time.monotonic()
        self.t_admitted = 0.0
        self.t_first = 0.0            # first generated token landed
        self.t_done = 0.0
        # Captured on the submitting thread so the loop's admit/chunk
        # spans join the request's trace tree.
        self.trace_id = obs_trace.current_trace_id()
        self.span_id = obs_trace.current_span_id()
        self.rid = next(Request._rid_counter)
        self.preempts = 0
        # Flight-recorder trail: a small event list (the loop appends) and
        # the attribution counters folded into the latency breakdown at
        # retirement. ``_flight`` is the engine's recorder (None when
        # recording is off: every hook is skipped).
        self.events: List[dict] = []
        self.stall_s = 0.0            # stall seconds while active
        self.spec_prop = 0            # draft tokens proposed for us
        self.spec_acc = 0             # ...and accepted
        self._flight: Optional[flightrec.FlightRecorder] = None
        # Usage metering (serving/metering.py): the billable tenant (the
        # adapter's tenant unless the client named one), the ledger to bill
        # (None = metering off), and how many leading generated tokens a
        # recovery re-dispatch regenerated (``stream_skip``): billed once
        # fleet-wide, by the replica that streamed them.
        self.tenant = adapter or "base"
        self.meter_skip = 0
        self._usage: Optional[TenantLedger] = None
        self._event = threading.Event()

    def done(self) -> bool:
        return self._event.is_set()

    def _notify(self, token: Optional[int]) -> None:
        """Fire the streaming sink (loop thread). A broken sink is dropped,
        never propagated: one disconnected stream must not kill the loop
        serving everyone else."""
        cb = self.on_token
        if cb is None:
            return
        try:
            cb(token)
        except Exception:
            self.on_token = None

    def _finish(self, error: Optional[BaseException] = None) -> None:
        self.error = error
        self.t_done = time.monotonic()
        # Retirement billing: every outcome passes here once, ``tokens``
        # only grows, and only an ADMITTED request billed its prompt (a
        # request shed before admission leaves no ledger row).
        if self._usage is not None and self.counted:
            self._usage.retire(self.tenant, self.qos,
                               self.adapter or "base",
                               len(self.tokens) - self.meter_skip)
        if self._flight is not None:
            self._flight.event(self, "retire",
                               err=type(error).__name__ if error else None)
            self._flight.retire(self)
        # End-of-stream marker BEFORE the event: a streamer that woke on
        # the sentinel can rely on result() returning immediately.
        self._notify(None)
        self._event.set()

    def result(self, timeout: Optional[float] = None) -> List[int]:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"engine did not complete the request within {timeout}s")
        if self.error is not None:
            raise self.error
        return self.tokens


class BlockManager:
    """Host-side page-pool bookkeeping: a free list plus per-page
    refcounts (a page shared by k block tables — slots and/or the prefix
    cache — carries ref k and returns to the free list only when the last
    holder releases it). Freed pages are remembered as ``dirty`` until
    their cached position ids are invalidated on the device (the engine
    batches that into one scatter per reuse)."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1 or page_size < 1:
            raise ValueError("n_pages and page_size must be >= 1")
        self.n_pages = n_pages
        self.page_size = page_size
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self.ref = np.zeros((n_pages,), np.int32)
        self.dirty: set = set()

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` pages (ref 1 each). All-or-nothing: raises
        PageAllocError without side effects when the free list is short
        (the caller reclaims prefix-cache pages first)."""
        if n > len(self._free):
            raise PageAllocError(
                f"KV page pool exhausted ({len(self._free)} free, "
                f"{n} needed, {self.n_pages} total)")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self.ref[p] = 1
        return pages

    def incref(self, page: int) -> None:
        assert self.ref[page] > 0, f"incref of free page {page}"
        self.ref[page] += 1

    def decref(self, pages: Sequence[int]) -> List[int]:
        """Release one reference per page; pages hitting zero return to
        the free list (marked dirty) and are listed back."""
        freed = []
        for p in pages:
            assert self.ref[p] > 0, f"decref of free page {p}"
            self.ref[p] -= 1
            if self.ref[p] == 0:
                self._free.append(p)
                self.dirty.add(p)
                freed.append(p)
        return freed


class _PrefixEntry:
    __slots__ = ("key", "parent", "page", "tokens", "partial",
                 "nchildren", "root")

    def __init__(self, key: bytes, parent: bytes, page: int,
                 tokens: Tuple[int, ...], partial: bool,
                 root: bytes = b""):
        self.key = key          # lru/map key (chain hash; partial: parent)
        self.parent = parent
        self.page = page
        self.tokens = tokens    # partial entries: the page's real tokens
        self.partial = partial
        self.nchildren = 0      # cached entries extending this one
        self.root = root        # chain seed


class PrefixCache:
    """Content-hashed prompt-page cache over the shared pool.

    Full pages are keyed by the CHAIN hash of their content (page i's key
    folds page i-1's key, so a match is a match of the whole prefix). At
    most one PARTIAL entry per parent key remembers a request's last,
    partially-filled prompt page — matched by exact token comparison and
    shared via device copy-on-write (the copy drops everything past the
    matched tokens, so a stale tail can never leak). The cache holds one
    pool ref per entry; eviction is LRU over childless entries whose page
    no live slot still uses (ref == 1)."""

    def __init__(self, manager: BlockManager):
        self.mgr = manager
        self.full: Dict[bytes, _PrefixEntry] = {}
        self.partial: Dict[bytes, _PrefixEntry] = {}
        self._lru: "OrderedDict[Tuple[bool, bytes], _PrefixEntry]" = \
            OrderedDict()
        self.hits = 0
        self.tokens_reused = 0

    def __len__(self) -> int:
        return len(self._lru)

    def _touch(self, e: _PrefixEntry) -> None:
        self._lru.move_to_end((e.partial, e.key))

    def match(self, tokens: Sequence[int], max_reuse: int,
              root: bytes = b""
              ) -> Tuple[List[int], Optional[Tuple[int, int]], int, bytes]:
        """Longest cached prefix of ``tokens`` reusable within
        ``max_reuse`` (the caller caps at len-1: the last prompt token
        must run through the model for its logits). Returns (full_pages,
        cow, matched_tokens, chain_key) where ``cow`` is (source_page,
        n_tokens) when a partial boundary page extends the match via
        copy-on-write. ``root`` seeds the chain."""
        ps = self.mgr.page_size
        pages: List[int] = []
        key, matched = root, 0
        while matched + ps <= max_reuse:
            nxt = _chain_hash(key, tokens[matched:matched + ps])
            e = self.full.get(nxt)
            if e is None:
                break
            pages.append(e.page)
            key, matched = nxt, matched + ps
            self._touch(e)
        cow = None
        pe = self.partial.get(key)
        if pe is not None:
            # Longest agreeing prefix of the boundary page (the COW copy
            # keeps exactly this many token slots valid).
            cap = min(len(pe.tokens), max_reuse - matched)
            extra = 0
            while extra < cap and \
                    tokens[matched + extra] == pe.tokens[extra]:
                extra += 1
            if extra > 0:
                cow = (pe.page, extra)
                matched += extra
                self._touch(pe)
        return pages, cow, matched, key

    def insert_full(self, parent: bytes, page_tokens: Sequence[int],
                    page: int, root: bytes = b"") -> bytes:
        """Register one full prompt page; returns its chain key. A
        pre-existing identical entry is refreshed, not duplicated."""
        key = _chain_hash(parent, page_tokens)
        e = self.full.get(key)
        if e is not None:
            self._touch(e)
            return key
        e = _PrefixEntry(key, parent, page, (), False, root=root)
        self.mgr.incref(page)
        self.full[key] = e
        self._lru[(False, key)] = e
        pe = self.full.get(parent)
        if pe is not None:
            pe.nchildren += 1
        return key

    def insert_partial(self, parent: bytes, tokens: Sequence[int],
                       page: int, root: bytes = b"") -> None:
        """Register a partially-filled boundary page (first writer wins
        per parent — replacing a hot partial with an equivalent one would
        only churn refcounts)."""
        if not tokens or parent in self.partial:
            return
        e = _PrefixEntry(parent, parent, page, tuple(tokens), True,
                         root=root)
        self.mgr.incref(page)
        self.partial[parent] = e
        self._lru[(True, parent)] = e
        pe = self.full.get(parent)
        if pe is not None:
            pe.nchildren += 1

    def _drop(self, e: _PrefixEntry) -> List[int]:
        del (self.partial if e.partial else self.full)[e.key]
        del self._lru[(e.partial, e.key)]
        pe = self.full.get(e.parent)
        if pe is not None:
            pe.nchildren -= 1
        return self.mgr.decref([e.page])

    def evict_one(self, spill: Optional[Callable[["_PrefixEntry"],
                                                 None]] = None) -> bool:
        """Reclaim the least-recently-used childless entry whose page no
        slot is still reading (pool ref == 1). Returns whether a page went
        back to the free list. ``spill`` sees the entry BEFORE it drops:
        the host-RAM offload tier's demotion reads the page there, which
        the selection rule makes safe (no live slot reads it)."""
        for e in list(self._lru.values()):
            if e.nchildren == 0 and self.mgr.ref[e.page] == 1:
                if spill is not None:
                    spill(e)
                self._drop(e)
                return True
        return False

    def drop_all(self) -> List[int]:
        """Drop every entry, releasing the cache's page refs (a page a live
        slot still reads survives until that slot retires). Returns the
        pages that went back to the free list."""
        freed: List[int] = []
        for e in list(self._lru.values()):
            freed += self._drop(e)
        return freed


class _WRRBand:
    """One weighted-round-robin rotation over per-tenant FIFO queues (the
    FairQueue building block; a FairQueue holds one band per QoS class).
    The rotation serves up to ``weights[tenant]`` (default 1) requests per
    visit before moving on, so a trickling tenant's next request is at
    most one rotation away instead of behind another tenant's burst."""

    def __init__(self, weights: Dict[str, int]):
        self._qs: "OrderedDict[str, deque]" = OrderedDict()
        self._weights = weights
        self._rr: deque = deque()   # tenant rotation
        self._credit = 0

    def push(self, req) -> None:
        tenant = getattr(req, "adapter", "") or ""
        q = self._qs.get(tenant)
        if q is None:
            q = self._qs[tenant] = deque()
            self._rr.append(tenant)
        q.append(req)

    def pop(self):
        for _ in range(len(self._rr)):
            tenant = self._rr[0]
            q = self._qs.get(tenant)
            if not q:
                self._rr.rotate(-1)
                self._credit = 0
                continue
            if self._credit <= 0:
                self._credit = max(1, int(self._weights.get(tenant, 1)))
            self._credit -= 1
            req = q.popleft()
            if self._credit <= 0 or not q:
                self._rr.rotate(-1)
                self._credit = 0
            return req
        return None

    def shed_newest(self):
        """Remove and return the NEWEST queued request (None when empty):
        sheds cost the least-progressed work."""
        victim, vq = None, None
        for q in self._qs.values():
            if q and (victim is None
                      or q[-1].t_enqueue > victim.t_enqueue):
                victim, vq = q[-1], q
        if vq is not None:
            vq.pop()
        return victim

    def drain(self) -> List[Any]:
        out: List[Any] = []
        for q in self._qs.values():
            out.extend(q)
            q.clear()
        self._credit = 0
        return out


class FairQueue:
    """Per-tenant FIFO queues with weighted round-robin pop, split into
    QoS class bands — the port's copy of ``kubeflow_tpu/serving/
    adapters.py`` ``FairQueue`` (``serving/adapters.py`` re-exports it).
    The tenant key is the request's ``adapter`` attribute ("" = base
    traffic); the band is its ``qos`` attribute (interactive unless
    set). Pop order: the ``push_front`` recompute-continuation lane
    (preempt requeues, absolute priority), then the ``interactive``
    band's rotation, then ``batch``. Not thread-safe: the engine
    serializes access under its condition lock."""

    def __init__(self, weights: Optional[Dict[str, int]] = None):
        self._weights = dict(weights or {})
        self._front: deque = deque()
        self._bands = {"interactive": _WRRBand(self._weights),
                       "batch": _WRRBand(self._weights)}
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def push(self, req) -> None:
        cls = getattr(req, "qos", "") or "interactive"
        self._bands.get(cls, self._bands["interactive"]).push(req)
        self._len += 1

    def push_front(self, req) -> None:
        self._front.appendleft(req)
        self._len += 1

    def pop(self):
        """Next request (None when empty): front lane, then interactive
        WRR, then batch WRR."""
        if self._front:
            self._len -= 1
            return self._front.popleft()
        for cls in ("interactive", "batch"):
            req = self._bands[cls].pop()
            if req is not None:
                self._len -= 1
                return req
        return None

    def shed_batch(self, n: int) -> List[Any]:
        """Remove up to ``n`` queued BATCH-class requests (newest first);
        never touches interactive requests or the recompute lane."""
        out = []
        while len(out) < n:
            victim = self._bands["batch"].shed_newest()
            if victim is None:
                break
            self._len -= 1
            out.append(victim)
        return out

    def drain_all(self) -> List[Any]:
        """Every queued request (front lane first), clearing the queue."""
        out = list(self._front)
        self._front.clear()
        out.extend(self._bands["interactive"].drain())
        out.extend(self._bands["batch"].drain())
        self._len = 0
        return out


# -- counter-based per-slot sampling -----------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32) and a 32-bit
    constant, in two 16-bit halves so no product leaves int64."""
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (hi + (x & 0xFFFF) * c) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer (a bijection that avalanches)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def seed32(seed: int) -> int:
    """A request seed (any Python int) folded to 32 bits."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (s ^ (s >> 32)) & _M32


# Sampling streams: the plain next-token draw (0), and speculation's
# draft proposals, accept uniforms and residual/bonus draws. Each stream
# is indexed by the token index its draw decides.
STREAM_TOKEN, STREAM_DRAFT, STREAM_ACCEPT, STREAM_BONUS = 0, 1, 2, 3


def slot_uniforms(seeds: torch.Tensor, counters: torch.Tensor,
                  vocab: int, stream: int = STREAM_TOKEN) -> torch.Tensor:
    """[B, vocab] float32 uniforms in (0, 1), a pure function of each
    row's (32-bit seed, token index), the vocab id and ``stream``: the
    same request draws the same numbers whatever slot it sits in and
    whoever shares the batch, and the streams are independent."""
    row = _fmix32(_fmix32(seeds & _M32)
                  ^ _mul32((counters + 1) & _M32, 0x9E3779B9))
    if stream:
        row = _fmix32(row ^ _mul32(torch.full_like(row, stream), 0x85157AF5))
    col = _mul32(torch.arange(1, vocab + 1, device=seeds.device),
                 0x27D4EB2F)
    h = _fmix32(_fmix32(row[:, None] ^ col[None, :]) ^ row[:, None])
    # 23 bits: (2**23 - 0.5) / 2**23 is exact in float32, so u < 1 and
    # the Gumbel noise -log(-log(u)) stays finite.
    return ((h >> 9).to(torch.float32) + 0.5) * (1.0 / (1 << 23))


def sample_slots(logits: torch.Tensor, temp: torch.Tensor,
                 topk: torch.Tensor, seeds: torch.Tensor,
                 counters: torch.Tensor, sampled: bool = True,
                 with_topk: bool = True,
                 stream: int = STREAM_TOKEN) -> torch.Tensor:
    """logits [B, V] f32 -> token ids [B] int64, each row with its own
    knobs: ``temp <= 0`` is greedy (the first argmax); otherwise
    Gumbel-max over ``logits / max(T, 1e-6)`` with every logit below the
    k-th largest (``srt[V - top_k]`` of an ascending sort, so ties at the
    k-th value survive) masked where ``top_k > 0`` — the rule of
    ``models/generate._sample`` — drawn from ``slot_uniforms``.
    ``sampled``/``with_topk`` say (host-side) whether any row samples or
    uses top-k, so an all-greedy batch runs one argmax and no hash."""
    greedy = torch.argmax(logits, dim=-1)
    if not sampled:
        return greedy
    V = logits.shape[-1]
    scaled = logits / temp.clamp_min(1e-6)[:, None]
    if with_topk:
        srt = torch.sort(scaled, dim=-1).values
        kth = srt.gather(1, (V - topk).clamp(0, V - 1)[:, None].long())
        scaled = scaled.masked_fill((topk[:, None] > 0) & (scaled < kth),
                                    float("-inf"))
    u = slot_uniforms(seeds, counters, V, stream)
    drawn = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
    return torch.where(temp > 0, drawn, greedy)


def warp_probs(logits: torch.Tensor, temp: torch.Tensor,
               topk: torch.Tensor, with_topk: bool = True) -> torch.Tensor:
    """logits [B, S, V] f32 -> the distributions ``sample_slots`` draws
    from, [B, S, V]: softmax of ``logits / max(T, 1e-6)`` under the
    row's top-k mask, and one-hot on the first argmax where ``T <= 0``
    (the greedy limit, which makes greedy acceptance an exact match)."""
    V = logits.shape[-1]
    greedy = (torch.arange(V, device=logits.device)
              == torch.argmax(logits, -1, keepdim=True)).float()
    scaled = logits / temp.clamp_min(1e-6)[:, None, None]
    if with_topk:
        srt = torch.sort(scaled, dim=-1).values
        idx = (V - topk).clamp(0, V - 1).long()[:, None, None]
        kth = srt.gather(-1, idx.expand(*scaled.shape[:-1], 1))
        scaled = scaled.masked_fill(
            (topk[:, None, None] > 0) & (scaled < kth), float("-inf"))
    probs = torch.softmax(scaled, -1)
    return torch.where((temp <= 0)[:, None, None], greedy, probs)


# -- the engine ---------------------------------------------------------------

class DecodeEngine:
    """Owns the paged KV pool, the block tables, the prefix cache, the
    decode-mode model and the decode-loop thread. One instance per served
    LM. ``device`` is "cuda" unless the caller asks for "cpu"."""

    def __init__(self, cfg, params, n_slots: int = 8,
                 chunk_tokens: int = 8, max_queue: Optional[int] = None,
                 name: str = "model",
                 registry: Union[MetricsRegistry,
                                 Callable[[], MetricsRegistry],
                                 None] = None,
                 request_timeout_s: float = 50.0,
                 kv_page_size: int = 32,
                 kv_pages: Optional[int] = None,
                 prefix_cache: bool = True,
                 stall_threshold_s: float = 10.0,
                 prefill_chunk_tokens: int = 0,
                 draft_layers: int = 0,
                 propose_tokens: int = 4,
                 draft_kv_pages: Optional[int] = None,
                 kv_quant: str = "",
                 draft_quant: str = "",
                 device: Union[str, torch.device] = "cuda",
                 adapters: Optional[Dict[str, str]] = None,
                 adapter_slots: int = 8,
                 adapter_rank: int = 0,
                 adapter_default: str = "",
                 adapter_fallback: str = "base",
                 qos_default: str = "interactive",
                 deadline_default_s: float = 0.0,
                 rate_limits: Optional[Dict[str, float]] = None,
                 rate_burst_s: float = 2.0,
                 role: str = "mixed",
                 kv_peer_send: Optional[Callable[[bytes], str]] = None,
                 kv_offload_pages: int = 0):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if chunk_tokens < 1:
            raise ValueError("chunk_tokens must be >= 1")
        if draft_layers < 0:
            raise ValueError("draft_layers must be >= 0 (0 = no "
                             "speculative decoding)")
        if draft_layers > 0 and propose_tokens < 1:
            raise ValueError("propose_tokens must be >= 1")
        if kv_quant not in ("", "int8"):
            raise ValueError(
                f"unknown kv_quant {kv_quant!r} (expected '' or 'int8')")
        if draft_quant not in ("", "int8"):
            raise ValueError(
                f"unknown draft_quant {draft_quant!r} "
                "(expected '' or 'int8')")
        if adapter_fallback not in ("base", "error"):
            raise ValueError(
                f"unknown adapter_fallback {adapter_fallback!r} "
                "(expected 'base' or 'error')")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # The loop thread selects the device itself; pin the index of
            # the creating thread's current device.
            self.device = torch.device("cuda", torch.cuda.current_device())
        base = decode_config(cfg)
        L = base.max_seq_len
        ps = min(int(kv_page_size), L)
        if ps < 1:
            raise ValueError(f"kv_page_size must be >= 1, got {ps}")
        while L % ps:
            # The gathered view must tile max_seq_len exactly; fall back
            # to the largest divisor at or below the request.
            ps -= 1
        self.page_size = ps
        self.n_blocks = L // ps
        # Default pool = the dense layout's memory (n_slots full rows);
        # shrink kv_pages to cap KV memory below that — admission then
        # gates on pages, and n_slots is just max concurrency.
        self.n_pages = int(kv_pages) if kv_pages else n_slots * self.n_blocks
        if self.n_pages < self.n_blocks:
            # One request must always be placeable.
            raise ValueError(
                f"kv_pages {self.n_pages} < blocks per max-length "
                f"request {self.n_blocks}")
        # int8 paged KV is independent of the weights' quantization; the
        # draft's pool follows it (its config derives from this one).
        self.cfg = dataclasses.replace(base, kv_page_size=ps,
                                       kv_pages=self.n_pages,
                                       kv_quant=kv_quant or base.kv_quant)
        self.name = name
        self.n_slots = n_slots
        self.chunk_tokens = chunk_tokens
        # Chunked prefill: 0 = monolithic; any other value rounds UP to a
        # whole number of pages so chunk and page boundaries coincide.
        if prefill_chunk_tokens < 0:
            raise ValueError("prefill_chunk_tokens must be >= 0 "
                             "(0 = monolithic prefill)")
        if prefill_chunk_tokens:
            prefill_chunk_tokens = -(-int(prefill_chunk_tokens) // ps) * ps
        self.prefill_chunk_tokens = prefill_chunk_tokens
        if draft_layers >= base.n_layers:
            raise ValueError(
                f"draft_layers {draft_layers} must be < the target's "
                f"n_layers {base.n_layers} (a draft as deep as the "
                "target proposes at the target's cost)")
        self.spec = draft_layers > 0
        self.draft_layers = draft_layers
        self.propose_tokens = propose_tokens
        self.max_queue = max_queue if max_queue is not None else 4 * n_slots
        self.request_timeout_s = request_timeout_s
        # -- request-plane policy: the QoS class default, the deadline
        # default and the per-tenant token-weighted rate budgets.
        if qos_default not in QOS_CLASSES:
            raise ValueError(
                f"unknown qos_default {qos_default!r} "
                f"(expected one of {sorted(QOS_CLASSES)})")
        self.qos_default = qos_default
        if deadline_default_s < 0:
            raise ValueError("deadline_default_s must be >= 0 "
                             "(0 = no default deadline)")
        self.deadline_default_s = float(deadline_default_s)
        self.rate_limits = {str(k): float(v)
                            for k, v in (rate_limits or {}).items()}
        for tenant, rate in self.rate_limits.items():
            if rate <= 0:
                raise ValueError(
                    f"rate_limits[{tenant!r}] must be > 0 tokens/s")
        self.rate_burst_s = max(float(rate_burst_s), 0.1)
        # Tenant -> [budget_tokens, last_refill] (under _cond). Overdraw
        # model: a request is admitted while its tenant's budget is
        # positive and debits its whole prompt + max_new weight, so a
        # burst runs the budget negative and the deficit / rate is the
        # next request's Retry-After.
        self._rate_buckets: Dict[str, List[float]] = {}
        # Trailing queue-wait estimate (EWMA of first-admission waits):
        # the deadline feasibility check's input.
        self._qwait_ewma = 0.0
        # -- KV transfer plane (serving/kvtransfer.py): the replica's
        # disaggregation role, the peer sender exports ship through, and
        # the host-RAM tier cold prefix pages demote into.
        if role not in ("prefill", "decode", "mixed"):
            raise ValueError(
                f"unknown role {role!r} (expected prefill, decode or "
                "mixed)")
        self.role = role
        self._peer_send = kv_peer_send
        if kv_offload_pages < 0:
            raise ValueError("kv_offload_pages must be >= 0 "
                             "(0 = no host-RAM offload tier)")
        self._offload: Optional[kvtransfer.HostOffloadTier] = \
            kvtransfer.HostOffloadTier(kv_offload_pages) \
            if kv_offload_pages else None
        # rids a prefill-role engine must not hand off (again): the
        # transfer is in flight, or it failed and the slot decodes
        # locally. Cleared wholesale past 4096 entries: a stale rid costs
        # one redundant skip check, never correctness.
        self._handoff_skip: set = set()
        # Cross-thread control jobs for the loop thread (export snapshots,
        # import installs, detaches): slot state is loop-thread only, so
        # other threads post a thunk and wait (_run_on_loop).
        self._control: "deque[Callable[[], None]]" = deque()
        self._registry = registry
        self.model = load_decode_model(self.cfg, params, self.device)

        self.prompt_buckets: List[int] = []
        b = 8
        while b <= max(8, L // 2):
            self.prompt_buckets.append(min(b, L))
            b *= 2

        # -- pool bookkeeping (touched only by the loop thread)
        self._mgr = BlockManager(self.n_pages, ps)
        self._prefix: Optional[PrefixCache] = \
            PrefixCache(self._mgr) if prefix_cache else None
        self._prompt_tokens = 0  # prompt tokens admitted (for skip frac)

        # -- device state (touched only by the loop thread after start)
        self._cache = PagedKVCache.allocate(self.cfg, self.device)
        self._logbuf = torch.zeros(n_slots, self.cfg.vocab_size,
                                   dtype=torch.float32, device=self.device)
        # -- speculative decoding: the draft shares the target's modules
        # and block geometry but proposes from its OWN pool, so draft KV
        # never competes with target KV for a page (a draft shortfall
        # degrades the slot, never the admission).
        self.draft_model = self._draft_cache = self._draft_mgr = None
        self.draft_n_pages = 0
        if self.spec:
            self.draft_n_pages = int(draft_kv_pages) if draft_kv_pages \
                else self.n_pages
            if self.draft_n_pages < 1:
                raise ValueError("draft_kv_pages must be >= 1")
            if draft_quant == "int8" and self.cfg.quant != "int8":
                # A draft of its own with int8 weights (the target's are
                # full precision, so it cannot share their modules).
                dcfg = dataclasses.replace(
                    self.cfg, n_layers=draft_layers, quant="int8",
                    kv_pages=self.draft_n_pages)
                self.draft_model = load_decode_model(
                    dcfg, quantize_params_int8(
                        _draft_params(params, draft_layers)), self.device)
            else:
                self.draft_model = truncate_layers(
                    self.model, draft_layers, kv_pages=self.draft_n_pages)
            self._draft_cache = PagedKVCache.allocate(self.draft_model.cfg,
                                                      self.device)
            self._draft_mgr = BlockManager(self.draft_n_pages, ps)
        # -- multi-tenant LoRA adapters (serving/adapters.py): the slot
        # pool's stacks ride every hot launch as the model's ``lora``
        # argument, with the per-slot adapter ids; enabled iff
        # ``adapters`` (name -> artifact URI) is non-empty.
        self.adapter_fallback = adapter_fallback
        self.adapter_default = adapter_default or ""
        self._apool = None
        if adapters:
            from .adapters import AdapterPool

            self._apool = AdapterPool(
                self.cfg, n_slots=adapter_slots, sources=adapters,
                rank=adapter_rank, draft_layers=draft_layers, name=name,
                registry=self._reg, device=self.device)
        if self.adapter_default and (
                self._apool is None
                or not self._apool.known(self.adapter_default)):
            raise ValueError(
                f"adapter_default {self.adapter_default!r} is not a "
                "configured adapter")
        # Cumulative spec counters (host truth; the registry counters
        # mirror them) and the trailing accept-rate window (read from
        # server threads, appended by the loop: locked).
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_degraded = 0
        self._spec_lock = threading.Lock()
        self._spec_window: "deque[Tuple[float, int, int]]" = deque()
        # Per-tenant usage ledger, billed on the admission and
        # retirement funnel (None would turn every hook off).
        self.usage: Optional[TenantLedger] = TenantLedger()
        # -- host slot state (uploaded and read back once per chunk)
        B = n_slots
        self._tables = np.full((B, self.n_blocks), -1, np.int32)
        self._slot_pages: List[List[int]] = [[] for _ in range(B)]
        self._pos = np.zeros((B,), np.int64)       # next decode position
        self._loc = np.zeros((B,), np.int64)       # next decode write loc
        self._max_loc = np.zeros((B,), np.int64)   # last writable loc
        self._active = np.zeros((B,), np.bool_)
        self._produced = np.zeros((B,), np.int64)
        self._seeds = np.zeros((B,), np.int64)
        self._temp = np.zeros((B,), np.float32)
        self._topk = np.zeros((B,), np.int64)
        self._stop = np.full((B,), -1, np.int64)
        self._max_new = np.zeros((B,), np.int64)
        self._slots: List[Optional[Request]] = [None] * B
        # Per-slot speculative state: the draft block-table row and pages,
        # whether the slot speculates (a draft-pool shortfall turns it off
        # for the slot's life), and the PENDING token: emitted to the
        # client, in neither pool yet; the next verify window writes it
        # first. -1 = none yet (the iteration samples it from _logbuf).
        self._draft_tables = np.full((B, self.n_blocks), -1, np.int32)
        self._draft_slot_pages: List[List[int]] = [[] for _ in range(B)]
        self._spec_ok = np.zeros((B,), np.bool_)
        self._pending = np.full((B,), -1, np.int64)
        # Per-slot adapter ids (-1 = the base), uploaded with the slot
        # state; a slot holds one AdapterPool pin per id >= 0.
        self._aids = np.full((B,), -1, np.int64)
        # Chunked-prefill cursors: slot -> {"req", "full", "n", "next"
        # (absolute index of the next chunk's first token), "key"/
        # "reg_block" (incremental prefix registration), "bucket",
        # "remaining", "fresh"}. A slot with a cursor holds its request
        # (in ``_slots``: drain/occupancy/heartbeat count it) but is NOT
        # ``_active``: the decode dispatch masks it until it completes.
        self._prefilling: Dict[int, Dict[str, Any]] = {}
        # Seconds of prefill dispatch that active decode slots waited on
        # this iteration (the kfx_lm_decode_stall_seconds histogram).
        self._iter_stall = 0.0

        # -- heartbeat + drain mode: a wedged loop leaves
        # ``_last_progress`` stale while slots are active, which /healthz
        # reports; drain stops admitting and lets in-flight work finish.
        self.stall_threshold_s = float(stall_threshold_s)
        self._iterations = 0
        self._last_progress = time.monotonic()
        self._draining = False
        # Cumulative preemption count (loop thread), mirrored into every
        # flight record.
        self._preempts = 0
        # Flight recorder (obs/flightrec.py): a bounded ring of
        # per-iteration host state plus a recent-requests ring, built
        # before the loop starts; KFX_FLIGHT=0 leaves it None and every
        # hook is skipped.
        self.flight: Optional[flightrec.FlightRecorder] = \
            flightrec.FlightRecorder() if flightrec.enabled_from_env() \
            else None

        self._cond = threading.Condition()
        self._queue = FairQueue()
        # The request inside _admit (popped, not yet in a slot): without
        # it drain()/heartbeat() would read an admitting engine as empty.
        self._admitting: Optional[Request] = None
        self._stopped = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"kfx-engine-{name}")
        self._thread.start()
        self._touch_gauges()

    # -- metrics -------------------------------------------------------------
    def _reg(self) -> MetricsRegistry:
        r = self._registry
        if callable(r):
            return r()
        return r if r is not None else default_registry()

    @property
    def draft_cfg(self):
        """The draft's config (None without a draft)."""
        return self.draft_model.cfg if self.spec else None

    @property
    def kv_bytes_per_token(self) -> int:
        """KV bytes per cached token, as the pool stores them: 2 (K+V) x
        layers x heads x head_dim x entry bytes (1 under int8 KV), the
        int8 pool's two f32 scale words a layer, and the position-id word
        (4 bytes a layer). The reference counts one position-id word for
        all layers."""
        c = self.cfg
        if c.kv_quant == "int8":
            return (2 * c.n_layers * c.n_heads * c.head_dim
                    + 2 * c.n_layers * 4 + 4 * c.n_layers)
        item = torch.empty((), dtype=c.dtype).element_size()
        return (2 * c.n_layers * c.n_heads * c.head_dim * item
                + 4 * c.n_layers)

    def _quant_labels(self) -> Tuple[str, str]:
        """(weights, kv) label values of the ``kfx_lm_quant_mode`` info
        gauge: ``int8``, ``draft-int8`` (only the draft's weights) or
        ``f32``."""
        if self.cfg.quant == "int8":
            weights = "int8"
        elif self.spec and self.draft_cfg.quant == "int8":
            weights = "draft-int8"
        else:
            weights = "f32"
        return weights, self.cfg.kv_quant or "f32"

    @property
    def quant_mode(self) -> str:
        """"w8" (int8 weights), "kv8" (int8 paged KV), "d8" (int8 draft
        only), joined with "+", or "f32": the server's JSON ``quant``."""
        return quant_mode_string(*self._quant_labels())

    @property
    def pool_bytes(self) -> int:
        """Device bytes of the KV pool (sink page included)."""
        return self._cache.nbytes

    @property
    def draft_pool_bytes(self) -> int:
        """Device bytes of the draft's KV pool (0 without a draft)."""
        return self._draft_cache.nbytes if self.spec else 0

    def spec_stats(self) -> Dict[str, int]:
        """Cumulative speculative-decode counters (zeros with the draft
        off): draft tokens proposed, proposals the target accepted, and
        slots degraded to non-speculative on draft-pool exhaustion."""
        return {"proposed": self._spec_proposed,
                "accepted": self._spec_accepted,
                "degraded": self._spec_degraded}

    def _spec_accept_rate(self, window_s: float = 30.0) -> float:
        """Accepted over proposed in the trailing window (0 when idle or
        without a draft): a gauge, so a stale burst decays."""
        now = time.monotonic()
        with self._spec_lock:
            while self._spec_window and \
                    self._spec_window[0][0] < now - window_s:
                self._spec_window.popleft()
            prop = sum(p for _, p, _ in self._spec_window)
            acc = sum(a for _, _, a in self._spec_window)
        return acc / prop if prop else 0.0

    def adapter_stats(self) -> Dict[str, int]:
        """Cumulative adapter-pool counters (zeros without a pool):
        artifact loads, LRU evictions, slot capacity and free slots."""
        if self._apool is None:
            return {"loads": 0, "evictions": 0, "slots": 0, "free": 0}
        return {"loads": self._apool.loads,
                "evictions": self._apool.evictions,
                "slots": self._apool.n_slots,
                "free": self._apool.n_free}

    def hbm_bytes(self) -> Dict[str, int]:
        """Device bytes by owner, counted from the tensors: the target's
        weights, the KV pool (entries, scale planes, position ids), the
        logits buffer, the draft (its pool, and its weights where it has
        its own: an int8 draft; a truncated draft shares the target's),
        and the adapter stacks. ``total`` over a base-only engine's is
        the multi-tenant HBM ratio."""
        def weights(model):
            return sum(t.numel() * t.element_size()
                       for t in model.state_dict().values())

        draft = 0
        if self.spec:
            draft = self._draft_cache.nbytes
            if self.draft_model.layers[0] is not self.model.layers[0]:
                draft += weights(self.draft_model)
        out = {"params": weights(self.model),
               "kv_pool": self._cache.nbytes,
               "logits": self._logbuf.numel() * self._logbuf.element_size(),
               "draft": draft,
               "adapters": self._apool.nbytes()
               if self._apool is not None else 0}
        out["total"] = sum(out.values())
        return out

    def prefix_stats(self) -> Dict[str, int]:
        """Cumulative prefix-cache counters (zeros while the cache is
        off): cache hits, prompt tokens admitted and tokens served from
        cached pages."""
        if self._prefix is None:
            return {"hits": 0, "tokens_reused": 0,
                    "prompt_tokens": self._prompt_tokens}
        return {"hits": self._prefix.hits,
                "tokens_reused": self._prefix.tokens_reused,
                "prompt_tokens": self._prompt_tokens}

    def page_stats(self) -> Dict[str, int]:
        """Pool accounting: pages, free pages, pages the prefix cache
        holds, cumulative preemptions. With nothing in flight, free +
        cached == pages (no leak)."""
        return {"pages": self.n_pages, "free": self._mgr.n_free,
                "cached": len(self._prefix) if self._prefix is not None
                else 0,
                "preemptions": self._preempts}

    def _occupancy(self) -> float:
        """Token-weighted occupancy: slot capacity scaled by the pool
        fraction active slots' DISTINCT pages pin (prefix-shared pages
        appear in every sharer's list but pin one physical page)."""
        held = len({pg for i, r in enumerate(self._slots)
                    if r is not None for pg in self._slot_pages[i]})
        return self.n_slots * held / float(self.n_pages)

    def _touch_gauges(self) -> None:
        reg = self._reg()
        reg.gauge("kfx_lm_slots",
                  "Decode-engine request slots (max concurrency).").set(
                      self.n_slots, model=self.name)
        reg.gauge("kfx_lm_slot_occupancy",
                  "Token-weighted engine load: slot capacity scaled by "
                  "the KV-page fraction active slots hold.").set(
                      round(self._occupancy(), 4), model=self.name)
        reg.gauge("kfx_lm_queue_depth",
                  "Requests waiting for a decode-engine slot.").set(
                      len(self._queue), model=self.name)
        # In-flight slots by QoS class, both classes set so the idle value
        # is an explicit 0.
        by_cls = {"interactive": 0, "batch": 0}
        for r in self._slots:
            if r is not None:
                by_cls[r.qos] = by_cls.get(r.qos, 0) + 1
        for cls, cnt in by_cls.items():
            reg.gauge("kfx_lm_class_active",
                      "In-flight engine slots by QoS class "
                      "(interactive/batch).").set(
                          cnt, model=self.name, qos=cls)
        # Request-plane shed counters, seeded before any traffic.
        for family, help_text in self._SHED_HELP.items():
            reg.counter(family, help_text).inc(0, model=self.name)
        reg.gauge("kfx_lm_kv_pages",
                  "KV cache pages in the engine's pool.").set(
                      self.n_pages, model=self.name)
        reg.gauge("kfx_lm_kv_pages_free",
                  "KV cache pages on the free list.").set(
                      self._mgr.n_free, model=self.name)
        # KV transfer-plane families, seeded before the first migration:
        # migrations by reason, pages shipped or adopted, the host offload
        # tier's occupancy and the end-to-end transfer timer.
        reg.counter("kfx_lm_kv_migrations_total",
                    "In-flight requests migrated to a peer replica, "
                    "by reason.").inc(0, model=self.name, reason="drain")
        reg.counter("kfx_lm_kv_pages_transferred_total",
                    "KV pages shipped to or adopted from peer "
                    "replicas.").inc(0, model=self.name)
        reg.gauge("kfx_lm_kv_offload_pages",
                  "Prefix-cache pages held per KV offload tier.").set(
                      len(self._offload) if self._offload is not None
                      else 0, model=self.name, tier="host")
        reg.histogram("kfx_lm_kv_transfer_seconds",
                      "End-to-end KV transfer time (export snapshot to "
                      "peer acknowledgement).",
                      buckets=QUEUE_WAIT_BUCKETS).observe(
                          0.0, n=0, model=self.name)
        reg.gauge("kfx_lm_kv_bytes_per_token",
                  "KV-cache bytes per cached token (entries + "
                  "quantization scales + position id).").set(
                      self.kv_bytes_per_token, model=self.name)
        # Info-style gauge: constant 1, the mode rides the labels.
        wmode, kvmode = self._quant_labels()
        reg.gauge("kfx_lm_quant_mode",
                  "Quantization mode info gauge (value is constant 1; "
                  "weights/kv labels carry the mode).").set(
                      1, model=self.name, weights=wmode, kv=kvmode)
        reg.counter("kfx_lm_prefix_cache_hits_total",
                    "Admissions that reused cached prefix pages.").inc(
                        0, model=self.name)
        st = self.prefix_stats()
        reg.gauge("kfx_lm_prefix_tokens_reused",
                  "Prompt tokens served from cached prefix pages "
                  "(cumulative).").set(st["tokens_reused"], model=self.name)
        reg.gauge("kfx_lm_prompt_tokens_admitted",
                  "Prompt tokens admitted (cumulative; denominator of "
                  "the prefill-skipped fraction).").set(
                      st["prompt_tokens"], model=self.name)
        reg.counter("kfx_lm_prefill_chunks_total",
                    "Prompt-chunk prefill dispatches (chunked "
                    "admission).").inc(0, model=self.name)
        reg.counter("kfx_lm_kv_preemptions_total",
                    "Slots preempted (recompute-requeued) on pool "
                    "exhaustion.").inc(0, model=self.name)
        reg.histogram("kfx_lm_decode_stall_seconds",
                      "Seconds active decode slots waited on a prefill "
                      "dispatch, per engine iteration.",
                      buckets=QUEUE_WAIT_BUCKETS).observe(
                          0.0, n=0, model=self.name)
        # Speculative families are seeded iff the engine HAS a draft:
        # their absence is the signal (the server's JSON engine block then
        # omits spec_accept_rate rather than show a 0 indistinguishable
        # from a draft accepting nothing).
        if self.spec:
            reg.counter("kfx_lm_spec_proposed_total",
                        "Draft tokens proposed to the verify dispatch."
                        ).inc(0, model=self.name)
            reg.counter("kfx_lm_spec_accepted_total",
                        "Draft proposals the target model accepted."
                        ).inc(0, model=self.name)
            reg.gauge("kfx_lm_spec_accept_rate",
                      "Draft acceptance rate over the trailing 30s "
                      "window (0 when idle).").set(
                          round(self._spec_accept_rate(), 4),
                          model=self.name)
        # Adapter families, seeded iff the engine HAS an adapter pool (their
        # absence marks a base-only engine, as with the spec families).
        if self._apool is not None:
            reg.gauge("kfx_lm_adapter_slots",
                      "HBM adapter slots (stacked LoRA A/B capacity)."
                      ).set(self._apool.n_slots, model=self.name)
            reg.gauge("kfx_lm_adapter_slots_free",
                      "Adapter slots not pinned by in-flight requests "
                      "(free + loaded-but-idle LRU candidates).").set(
                          self._apool.n_free, model=self.name)
            reg.counter("kfx_lm_adapter_loads_total",
                        "Adapters paged into HBM slots from the "
                        "artifact store.").inc(0, model=self.name)
            reg.counter("kfx_lm_adapter_evictions_total",
                        "Adapters evicted from HBM slots (LRU paging)."
                        ).inc(0, model=self.name)
            reg.counter("kfx_lm_adapter_fallbacks_total",
                        "Requests degraded to base-only after an "
                        "adapter load failure (adapters.fallback="
                        "base).").inc(0, model=self.name)
            reg.counter("kfx_lm_adapter_requests_total",
                        "Admitted client requests by adapter tenant."
                        ).inc(0, model=self.name, adapter="base")
        if self.flight is not None:
            reg.gauge("kfx_lm_flight_ring_records",
                      "Iteration records currently held in the flight "
                      "recorder ring.").set(len(self.flight),
                                            model=self.name)

    def _active_count(self) -> int:
        return sum(1 for r in self._slots if r is not None)

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    # -- liveness / drain ----------------------------------------------------
    def heartbeat(self) -> Dict[str, Any]:
        """Decode-loop progress snapshot (the server's /healthz input):
        iteration counter, seconds since the loop last completed an
        iteration, whether there is work it SHOULD be advancing, and the
        derived ``wedged`` verdict — stale progress while busy. An idle
        engine is never wedged: ``_enqueue`` re-stamps progress when it
        wakes a parked loop."""
        now = time.monotonic()
        with self._cond:
            busy = (self._active_count() > 0 or len(self._queue) > 0
                    or self._admitting is not None)
        stalled_s = now - self._last_progress
        return {
            "iterations": self._iterations,
            "stalled_s": round(stalled_s, 3),
            "busy": busy,
            "draining": self._draining,
            "wedged": busy and stalled_s > self.stall_threshold_s,
        }

    def drain(self, wait_s: float = 0.0) -> bool:
        """Enter drain mode: stop admitting (submit raises EngineDraining
        -> 503 + Retry-After), resolve every QUEUED request with the same
        retriable error, and let in-flight slots run to completion.
        Blocks up to ``wait_s`` for them; returns True when the engine is
        empty. One-way."""
        with self._cond:
            self._draining = True
            queued = self._queue.drain_all()
            self._cond.notify_all()
        err = EngineDraining(
            f"engine {self.name} is draining; retry another replica")
        for req in queued:
            req._finish(err)
        self._touch_gauges()
        deadline = time.monotonic() + max(wait_s, 0.0)
        while True:
            with self._cond:
                # A preempt re-queued mid-drain and a request mid-admission
                # are in-flight work, not new admissions.
                empty = (self._active_count() == 0 and not self._queue
                         and self._admitting is None)
            if empty or time.monotonic() >= deadline:
                return empty
            time.sleep(0.02)

    @property
    def draining(self) -> bool:
        return self._draining

    def _maybe_wedge(self) -> None:
        """Chaos point ``engine.wedge``: stall the loop with work in flight
        (drawn only then, so the budget is spent on a stall liveness can
        see) for ``delay`` seconds (default 30), without touching the
        heartbeat. The in-flight iteration is recorded to the flight ring
        first, so its last record (``it`` equal to the frozen counter)
        shows what was in flight when the loop hung. ``close()`` still
        wins: the stall polls ``_stopped``."""
        inj = chaos.draw("engine.wedge", target=self.name)
        if inj is None:
            return
        if self.flight is not None:
            self._record_flight()
        deadline = time.monotonic() + (inj.delay if inj.delay > 0
                                       else 30.0)
        while time.monotonic() < deadline and not self._stopped:
            time.sleep(0.05)

    def _maybe_kv_quant_chaos(self) -> None:
        """Chaos point ``engine.kv_quant``, drawn once a hot iteration on
        an int8 pool: a hit zeroes the scale planes of both pools (one
        device op each, no sync), so every cached entry dequantizes to 0,
        and drops the prefix cache (a cached page is never rewritten while
        cached, so it would carry the fault past its budget). Positions,
        tables and refcounts are untouched: quality degrades, nothing
        leaks, and entries written later carry fresh scales."""
        if self.cfg.kv_quant != "int8":
            return
        inj = chaos.draw("engine.kv_quant", target=self.name)
        if inj is None:
            return
        if inj.delay > 0:
            time.sleep(inj.delay)
        if inj.mode == "delay":
            return
        for cache in (self._cache, self._draft_cache):
            for plane in cache.scales if cache is not None else ():
                plane.zero_()
        if self._prefix is not None:
            self._prefix.drop_all()

    # -- device operations (loop thread, except warm) -----------------------
    def _lora(self, draft: bool = False):
        """The adapter stacks' per-layer views every launch takes as the
        model's ``lora`` argument (the draft's truncated ones with
        ``draft``); None without a pool, so an adapterless engine runs
        the pre-adapter forward."""
        if self._apool is None:
            return None
        return self._apool.draft_layers_views if draft \
            else self._apool.layers

    def _prefill(self, tokens: Sequence[int], start: int,
                 table: np.ndarray, draft: bool = False,
                 aid: int = -1) -> torch.Tensor:
        """Run the prompt tail ``tokens`` (absolute positions from
        ``start``; earlier positions are read from the pages ``table``
        maps) right-padded to its power-of-two bucket, writing its K/V
        straight into the pool through ``table`` [L/P] (the draft's pool
        with ``draft``), wearing adapter slot ``aid`` (-1 = the base:
        prompt KV is adapter KV). Pads carry position -1: their writes go
        to the sink and they are masked out of every attention. Returns
        the last real token's logits [V]."""
        n = len(tokens)
        P = pow2_bucket(n, self.cfg.max_seq_len)
        tok = np.zeros((1, P), np.int64)
        tok[0, :n] = tokens
        ar = np.arange(P)
        pos = np.where(ar < n, start + ar, -1).astype(np.int32)[None]
        dev = self.device
        model, cache = (self.draft_model, self._draft_cache) if draft \
            else (self.model, self._cache)
        lora = self._lora(draft)
        aids = torch.full((1,), aid, dtype=torch.int64, device=dev) \
            if lora else None
        logits = model(torch.from_numpy(tok).to(dev),
                       torch.from_numpy(pos).to(dev), cache,
                       torch.from_numpy(table[None]).to(dev),
                       lora=lora, adapter_ids=aids)
        return logits[0, n - 1]

    def warm(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Run one decode step and the prefill at each prompt bucket in
        ``buckets`` (default: every configured bucket), all against an
        empty block table: every write lands in the sink page and every
        read is masked, so no slot's state changes (safe from a background
        thread). Eager PyTorch compiles nothing; this takes each shape's
        first-call cost (allocator growth, library heuristics) off the
        first request."""
        empty = np.full((self.n_blocks,), -1, np.int32)
        B, dev = self.n_slots, self.device
        tables = torch.from_numpy(np.tile(empty, (B, 1))).to(dev)
        # A speculative engine's hot shapes: the verify window through the
        # target and one-token steps through the draft.
        S = self.propose_tokens + 1 if self.spec else 1
        with torch.inference_mode():
            self.model(torch.zeros(B, S, dtype=torch.int64, device=dev),
                       torch.zeros(B, S, dtype=torch.int32, device=dev),
                       self._cache, tables, lora=self._lora())
            if self.spec:
                self.draft_model(
                    torch.zeros(B, 1, dtype=torch.int64, device=dev),
                    torch.zeros(B, 1, dtype=torch.int32, device=dev),
                    self._draft_cache, tables, lora=self._lora(True))
            for b in buckets if buckets is not None else self.prompt_buckets:
                self._prefill([0] * int(b), 0, empty)
                if self.spec:
                    self._prefill([0] * int(b), 0, empty, draft=True)

    def _invalidate_dirty(self, mgr: BlockManager,
                          cache: PagedKVCache) -> None:
        """Stamp position -1 over every page of ``mgr`` recycled in
        ``cache`` (all layers, one scatter) before it is handed out: a new
        tenant can never attend a previous request's KV."""
        if mgr.dirty:
            idx = torch.tensor(sorted(mgr.dirty), dtype=torch.int64,
                               device=self.device)
            cache.pos[:, idx] = -1
            mgr.dirty.clear()

    def _copy_page(self, dst: int, src: int, keep: int) -> None:
        """Copy-on-write: clone page ``src`` into ``dst`` in every layer,
        keeping only the first ``keep`` token slots valid (positions past
        the matched prefix are stamped -1, so the source's later tokens
        can never leak into the borrowing request)."""
        c = self._cache
        for t in (c.key, c.value, *c.scales):
            t[:, dst] = t[:, src]
        valid = torch.arange(self.page_size, device=self.device) < keep
        c.pos[:, dst] = torch.where(valid, c.pos[:, src], -1)

    def _decode_chunk(self) -> Tuple[np.ndarray, np.ndarray]:
        """One decode chunk: ``_chunk_launch`` then ``_chunk_collect``.
        Returns (toks, emits), each [k, n_slots]."""
        return self._chunk_collect(self._chunk_launch())

    def _chunk_launch(self) -> torch.Tensor:
        """Enqueue ``chunk_tokens`` decode steps over every slot at fixed
        shapes. Each step: sample -> stop/emit/active gating -> one token
        for every slot, inactive slots as a masked dummy (position -1,
        location -1, so their writes go to the sink) -> the logits carry
        gated per ACTIVE row (an inactive row's dummy logits must never
        replace its pending next-token logits) -> writes at the
        dense-equivalent location. The state is uploaded once and nothing
        here waits for the device. Returns the packed device result
        ([k] tokens, [k] emits, position, location, active, produced)."""
        dev, k = self.device, self.chunk_tokens
        live = self._active
        sampled = bool((self._temp[live] > 0).any())
        with_topk = sampled and bool((self._topk[live] > 0).any())
        state = torch.from_numpy(np.stack([
            self._pos, self._loc, self._active.astype(np.int64),
            self._produced, self._topk, self._stop, self._max_new,
            self._seeds, self._aids])).to(dev)
        pos, loc, active, produced, topk, stop, max_new, seeds, aids = state
        lora = self._lora()
        active = active.bool()
        temp = torch.from_numpy(self._temp).to(dev)
        tables = torch.from_numpy(self._tables).to(dev)
        logits = self._logbuf
        toks, emits = [], []
        for _ in range(k):
            tok = sample_slots(logits, temp, topk, seeds, produced,
                               sampled, with_topk)
            is_stop = (stop >= 0) & (tok == stop)
            # The stop token itself is never emitted: the slot retires and
            # the request returns the tokens before it.
            emit = active & ~is_stop
            produced = produced + emit.long()
            feed = torch.where(active, tok, 0)
            eff_pos = torch.where(active, pos, -1).int()
            eff_loc = torch.where(active, loc, -1).int()
            out = self.model(feed[:, None], eff_pos[:, None], self._cache,
                             tables, eff_loc[:, None], lora=lora,
                             adapter_ids=aids)[:, 0]
            logits = torch.where(active[:, None], out, logits)
            pos = torch.where(active, pos + 1, pos)
            loc = torch.where(active, loc + 1, loc)
            active = emit & (produced < max_new)
            toks.append(tok)
            emits.append(emit)
        self._logbuf = logits
        return torch.cat([torch.stack(toks), torch.stack(emits).long(),
                          torch.stack([pos, loc, active.long(), produced])])

    def _chunk_collect(self, packed: torch.Tensor
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """The chunk's one read-back: copy the packed result to the host
        (waiting for the device) and adopt the advanced slot state."""
        k = self.chunk_tokens
        host = packed.cpu().numpy()
        self._pos, self._loc = host[2 * k].copy(), host[2 * k + 1].copy()
        self._active = host[2 * k + 2].astype(np.bool_)
        self._produced = host[2 * k + 3].copy()
        return host[:k], host[k:2 * k].astype(np.bool_)

    # -- submission ----------------------------------------------------------
    def _make_request(self, prompt: Sequence[int], max_new_tokens: int,
                      temperature: float, top_k: int, seed: int,
                      stop_token: Optional[int],
                      tenant: Optional[str] = None,
                      adapter: Optional[str] = None,
                      qos: Optional[str] = None,
                      deadline_s: Optional[float] = None) -> Request:
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("prompt must be non-empty")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if min(prompt) < 0 or max(prompt) >= self.cfg.vocab_size:
            # An out-of-range id would fault the embedding gather on the
            # card (the reference's gather clamps instead).
            raise ValueError(
                f"prompt token ids must be in [0, {self.cfg.vocab_size})")
        L = self.cfg.max_seq_len
        if len(prompt) + max_new_tokens > L:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the cache capacity {L}")
        # Adapter selection: the named adapter, else the engine's default;
        # "" is the base. An unknown name is a client mistake (ValueError
        # -> 400), never a 503.
        name = str((adapter if adapter is not None
                    else self.adapter_default) or "")
        if name and (self._apool is None or not self._apool.known(name)):
            raise ValueError(
                f"unknown adapter {name!r} (configured: "
                f"{sorted(self._apool.sources) if self._apool else []})")
        # QoS class: the request's, else the engine default; an unknown
        # class is a client mistake (-> 400).
        cls = qos if qos is not None else self.qos_default
        if cls not in QOS_CLASSES:
            raise ValueError(
                f"unknown qos {cls!r} (expected one of "
                f"{sorted(QOS_CLASSES)})")
        # Deadline: the request's, else the engine default (0 = none),
        # stored absolute so queue time counts against it.
        if deadline_s is None:
            deadline_s = self.deadline_default_s or None
        deadline = None
        if deadline_s is not None:
            deadline_s = float(deadline_s)
            if deadline_s <= 0:
                raise ValueError("deadline_s must be > 0")
            deadline = time.monotonic() + deadline_s
        req = Request(prompt, int(max_new_tokens), float(temperature),
                      int(top_k), int(seed),
                      -1 if stop_token is None else int(stop_token),
                      adapter=name, qos=cls, deadline=deadline)
        # Billable tenant: the client's explicit key, else the adapter's
        # tenant ("" counts as absent).
        if tenant:
            req.tenant = str(tenant)
        req._usage = self.usage
        req._flight = self.flight
        return req

    def _check_rate_locked(self, reqs: List[Request],
                           now: float) -> Optional[RateLimited]:
        """Token-bucket admission for limited tenants (under _cond). Cost
        = prompt + max_new tokens. A tenant is admitted while its budget
        is positive and debits the full cost (overdraw: the negative
        budget paces the NEXT burst, and the deficit converts into
        Retry-After seconds). The batch debits all or nothing. The bucket
        key is the adapter tenant ("" = the base)."""
        if not self.rate_limits:
            return None
        costs: Dict[str, float] = {}
        for r in reqs:
            tenant = r.adapter or ""
            if tenant in self.rate_limits:
                costs[tenant] = costs.get(tenant, 0.0) \
                    + len(r.prompt) + r.max_new
        for tenant, cost in costs.items():
            rate = self.rate_limits[tenant]
            burst = rate * self.rate_burst_s
            bucket = self._rate_buckets.get(tenant)
            if bucket is None:
                bucket = self._rate_buckets[tenant] = [burst, now]
            bucket[0] = min(burst, bucket[0] + rate * (now - bucket[1]))
            bucket[1] = now
            if bucket[0] <= 0.0:
                retry = min(30.0, (cost - bucket[0]) / rate)
                return RateLimited(
                    f"tenant {tenant or 'base'!r} is over its "
                    f"{rate:g} tokens/s budget "
                    f"(deficit {-bucket[0]:.0f} tokens)",
                    retry_after_s=max(retry, 0.1))
        for tenant, cost in costs.items():
            self._rate_buckets[tenant][0] -= cost
        return None

    _SHED_HELP = {
        "kfx_lm_deadline_shed_total":
            "Requests shed before prefill as deadline-infeasible "
            "(503 + Retry-After).",
        "kfx_lm_rate_limited_total":
            "Requests shed by a tenant's token-weighted rate budget "
            "(503 + Retry-After).",
    }

    def _count_shed(self, family: str, n: int = 1) -> None:
        self._reg().counter(family, self._SHED_HELP[family]).inc(
            n, model=self.name)

    def _enqueue(self, reqs: List[Request]) -> None:
        """All-or-nothing enqueue: a batch that does not fit the bounded
        queue is rejected WHOLE — partial admission would orphan the
        admitted fraction exactly when the engine is most loaded. The
        admission policy runs here, before any prefill: the tenants' rate
        budgets, deadline feasibility against the trailing queue-wait
        estimate, then batch-first shedding (queued batch requests are
        evicted, newest first, to make room for interactive arrivals)."""
        shed_err: Optional[EngineOverloaded] = None
        shed_family = ""
        shed_victims: List[Request] = []
        with self._cond:
            if self._stopped:
                raise RuntimeError("engine is closed")
            if self._draining:
                raise EngineDraining(
                    f"engine {self.name} is draining; retry another "
                    "replica")
            now = time.monotonic()
            shed_err = self._check_rate_locked(reqs, now)
            if shed_err is not None:
                shed_family = "kfx_lm_rate_limited_total"
            else:
                # Feasibility with the queue state in hand; an empty queue
                # skips the estimate (a stale EWMA must not shed an idle
                # engine's traffic).
                est = self._qwait_ewma if len(self._queue) else 0.0
                for r in reqs:
                    if r.deadline is not None and r.deadline - now <= est:
                        shed_err = DeadlineInfeasible(
                            f"deadline {max(r.deadline - now, 0):.2f}s "
                            f"away but trailing queue wait is "
                            f"{est:.2f}s", retry_after_s=1.0)
                        shed_family = "kfx_lm_deadline_shed_total"
                        break
            if shed_err is None \
                    and len(self._queue) + len(reqs) > self.max_queue:
                overflow = len(self._queue) + len(reqs) - self.max_queue
                if all(r.qos == "interactive" for r in reqs):
                    shed_victims = self._queue.shed_batch(overflow)
                if len(self._queue) + len(reqs) > self.max_queue:
                    shed_err = EngineOverloaded(
                        f"admission queue full ({len(self._queue)} "
                        f"waiting, {len(reqs)} arriving, cap "
                        f"{self.max_queue})")
            if shed_err is None:
                if self._active_count() == 0 and not self._queue \
                        and self._admitting is None:
                    # Waking an idle loop: the parked interval is not a
                    # stall.
                    self._last_progress = time.monotonic()
                for r in reqs:
                    self._queue.push(r)
            depth = len(self._queue)
            self._cond.notify()
        if shed_victims:
            evict = EngineOverloaded(
                f"batch request shed for interactive admission "
                f"(engine {self.name} under queue pressure)")
            for v in shed_victims:
                v._finish(evict)
        self._reg().gauge("kfx_lm_queue_depth",
                          "Requests waiting for a decode-engine slot."
                          ).set(depth, model=self.name)
        if shed_err is not None:
            if shed_family:
                self._count_shed(shed_family)
            raise shed_err

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               temperature: float = 0.0, top_k: int = 0, seed: int = 0,
               stop_token: Optional[int] = None,
               on_token: Optional[Callable[[Optional[int]], None]] = None,
               tenant: Optional[str] = None, meter_skip: int = 0,
               adapter: Optional[str] = None, qos: Optional[str] = None,
               deadline_s: Optional[float] = None) -> Request:
        """Enqueue one prompt; returns the request handle (wait with
        ``.result(timeout)``). ``on_token`` is the streaming sink, called
        on the loop thread with each token id as it lands, then None at
        retirement; ``tenant`` is the billable tenant (None = the
        adapter's) and ``meter_skip`` the leading tokens a recovery
        re-dispatch regenerates, billed by the replica that streamed
        them; ``adapter`` names a configured LoRA adapter (None = the
        engine's default, "" = the base); ``qos`` overrides the engine's
        class default and ``deadline_s`` its deadline default. Raises
        EngineOverloaded when the bounded admission queue is full, and
        its DeadlineInfeasible / RateLimited subclasses when admission
        policy sheds the request."""
        req = self._make_request(prompt, max_new_tokens, temperature,
                                 top_k, seed, stop_token, tenant, adapter,
                                 qos=qos, deadline_s=deadline_s)
        # Set before enqueue: even an instant retirement bills it right.
        req.meter_skip = max(int(meter_skip), 0)
        req.on_token = on_token
        self._enqueue([req])
        return req

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 32, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0,
                 stop_token: Optional[int] = None,
                 tenant: Optional[str] = None,
                 adapter: Optional[str] = None, qos: Optional[str] = None,
                 deadline_s: Optional[float] = None) -> List[List[int]]:
        """Blocking convenience mirroring LMGenerator.generate: one
        request per prompt (seeded seed+i), results in prompt order; one
        deadline covers the whole batch: ``deadline_s`` when given, else
        ``request_timeout_s``."""
        reqs = self.submit_batch(prompts, max_new_tokens, temperature,
                                 top_k, seed, stop_token, tenant, adapter,
                                 qos=qos, deadline_s=deadline_s)
        wait_s = deadline_s if deadline_s else self.request_timeout_s
        deadline = time.monotonic() + wait_s
        return [r.result(max(0.001, deadline - time.monotonic()))
                for r in reqs]

    def submit_batch(self, prompts: Sequence[Sequence[int]],
                     max_new_tokens: int = 32, temperature: float = 0.0,
                     top_k: int = 0, seed: int = 0,
                     stop_token: Optional[int] = None,
                     tenant: Optional[str] = None,
                     adapter: Optional[str] = None,
                     qos: Optional[str] = None,
                     deadline_s: Optional[float] = None) -> List[Request]:
        """``generate`` minus the blocking wait: one request per prompt
        (seeded seed+i), enqueued atomically, handles returned."""
        reqs = [self._make_request(p, max_new_tokens, temperature, top_k,
                                   seed + i, stop_token, tenant, adapter,
                                   qos=qos, deadline_s=deadline_s)
                for i, p in enumerate(prompts)]
        self._enqueue(reqs)
        return reqs

    # -- page allocation -----------------------------------------------------
    def _alloc_pages(self, n: int) -> List[int]:
        """Take ``n`` pages, reclaiming LRU prefix-cache pages when the
        free list is short, and invalidating recycled pages' position ids
        before handing them out. The ``engine.kv_alloc`` chaos point forces
        the failure."""
        chaos.fail_or_delay("engine.kv_alloc", PageAllocError, self.name,
                            target=self.name)
        spill = self._spill_page if self._offload is not None else None
        while self._mgr.n_free < n:
            if self._prefix is None or not self._prefix.evict_one(spill):
                break  # alloc() raises with the honest numbers
        pages = self._mgr.alloc(n)
        self._invalidate_dirty(self._mgr, self._cache)
        return pages

    def _alloc_draft_pages(self, n: int) -> List[int]:
        """Take ``n`` pages from the DRAFT pool (no prefix cache to
        reclaim from). A shortfall raises PageAllocError, which the
        caller turns into a degraded slot, never a failure."""
        pages = self._draft_mgr.alloc(n)
        self._invalidate_dirty(self._draft_mgr, self._draft_cache)
        return pages

    def _release_slot(self, slot: int) -> None:
        """Return a slot's page references to the pool (pages still pinned
        by the prefix cache or other slots survive; the rest go back to
        the free list, invalidated before reuse)."""
        self._mgr.decref(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self._tables[slot, :] = -1
        self._active[slot] = False
        self._release_draft(slot)
        self._pending[slot] = -1
        aid = int(self._aids[slot])
        if aid >= 0 and self._apool is not None:
            # Unpin the slot's adapter; its factors stay resident (LRU
            # pages out only under slot pressure).
            self._apool.release(aid)
        self._aids[slot] = -1

    def _release_draft(self, slot: int) -> None:
        """Return a slot's draft pages (slot-private: they free whole)
        and stop it speculating."""
        if self._draft_slot_pages[slot]:
            self._draft_mgr.decref(self._draft_slot_pages[slot])
        self._draft_slot_pages[slot] = []
        self._draft_tables[slot, :] = -1
        self._spec_ok[slot] = False

    # -- KV transfer plane (serving/kvtransfer.py) ---------------------------
    # Slot state is loop-thread only, so every transfer operation that
    # touches it (export snapshot, import install, detach) runs as a control
    # job at an iteration boundary. The network leg never holds the loop:
    # migrate_out snapshots on the loop, ships from the caller's thread, and
    # detaches only after the peer's acknowledgement, so a severed transfer
    # leaves the donor's copy authoritative and running.

    def _run_on_loop(self, fn: Callable[[], Any],
                     timeout: float = 30.0) -> Any:
        """Run ``fn`` on the loop thread at the next iteration boundary and
        return its result (its exception propagates to the caller). On
        the loop thread itself it runs inline."""
        if threading.current_thread() is self._thread:
            return fn()
        box: Dict[str, Any] = {}
        done = threading.Event()

        def job() -> None:
            try:
                box["r"] = fn()
            except BaseException as e:  # noqa: BLE001 — relayed below
                box["e"] = e
            finally:
                done.set()

        with self._cond:
            if self._stopped:
                raise RuntimeError(f"engine {self.name} is closed")
            self._control.append(job)
            self._cond.notify()
        deadline = time.monotonic() + timeout
        while not done.wait(0.05):
            if self._stopped and not done.is_set():
                raise RuntimeError(
                    f"engine {self.name} closed before the control job "
                    "ran")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"engine {self.name} loop did not service the control "
                    f"job within {timeout}s")
        if "e" in box:
            raise box["e"]
        return box.get("r")

    def _service_control(self) -> None:
        """Run the pending control jobs (loop thread, iteration start). A
        job's exception lands in its waiter's box: a refused import fails
        the TRANSFER, never the engine."""
        while True:
            with self._cond:
                if not self._control:
                    return
                job = self._control.popleft()
            job()

    def _cache_leaves(self) -> List[Tuple[str, torch.Tensor]]:
        """(leaf name, pool tensor) of every cache leaf in the reference's
        flatten order (flax flattens the cache dict by sorted key). Each
        tensor is [n_layers, N + 1, ...]: the page axis is 1."""
        c = self._cache
        leaves = [("cached_key", c.key), ("cached_pos", c.pos),
                  ("cached_value", c.value)]
        if c.key_scale is not None:
            leaves += [("key_scale", c.key_scale),
                       ("value_scale", c.value_scale)]
        return leaves

    def _leaf_descriptors(self) -> List[Dict[str, Any]]:
        """Wire geometry: the reference's (path, per-page shape, dtype)
        descriptor of every cache leaf in flatten order. The receiver
        requires leaf-for-leaf identity before scattering a page, so an
        f32 donor can never feed an int8 receiver."""
        return [{"path": f"['layers']['attn']['{name}']",
                 "shape": [int(t.shape[0]), 1] + [int(d)
                                                  for d in t.shape[2:]],
                 "dtype": _WIRE_DTYPES[t.dtype]}
                for name, t in self._cache_leaves()]

    @property
    def page_bytes(self) -> int:
        """Wire bytes of one page frame: every leaf's rows of the page in
        all layers."""
        return sum(t[:, 0].numel() * t.element_size()
                   for _, t in self._cache_leaves())

    def _gather_pages(self, pages: Sequence[int]) -> np.ndarray:
        """The wire frames of ``pages`` as one host array [n, page_bytes]
        (row i = page i's frame): one index gather per leaf on the device,
        the page axis moved first, byte views concatenated, one copy to the
        host. Never writes the pool."""
        n = len(pages)
        if not n:
            return np.zeros((0, self.page_bytes), np.uint8)
        idx = torch.tensor(list(pages), dtype=torch.int64,
                           device=self.device)
        parts = [t.index_select(1, idx).transpose(0, 1).reshape(n, -1)
                 .view(torch.uint8) for _, t in self._cache_leaves()]
        return torch.cat(parts, 1).cpu().numpy()

    def _page_payload(self, page: int) -> bytes:
        """One page's wire payload (loop thread only)."""
        return self._gather_pages([page])[0].tobytes()

    def _unpack_pages(self, frames: Sequence[bytes]) -> np.ndarray:
        """Parse page frames into one host array [n, page_bytes]. A size
        mismatch raises TransferError: geometry drift must never scatter
        garbage into the pool."""
        pb = self.page_bytes
        for i, f in enumerate(frames):
            if len(f) != pb:
                raise kvtransfer.TransferError(
                    f"page payload size mismatch (frame {i}: {len(f)} "
                    f"bytes, geometry says {pb})")
        buf = bytearray().join(frames)   # writable: torch takes it as is
        return np.frombuffer(buf, np.uint8).reshape(len(frames), pb)

    def _scatter_pages(self, rows: np.ndarray, pages: Sequence[int]) -> None:
        """Write frames ``rows`` [n, page_bytes] into ``pages`` of the pool:
        one copy to the device, then one index copy per leaf."""
        n = len(pages)
        if not n:
            return
        x = torch.from_numpy(rows).to(self.device)
        idx = torch.tensor(list(pages), dtype=torch.int64,
                           device=self.device)
        off = 0
        for _, t in self._cache_leaves():
            per = t[:, 0].numel() * t.element_size()
            col = x[:, off:off + per].contiguous().view(t.dtype)
            t.index_copy_(1, idx, col.reshape(
                n, t.shape[0], *t.shape[2:]).transpose(0, 1))
            off += per

    def _export_slot(self, slot: int) -> Tuple[Request, bytes, int]:
        """Snapshot one slot's in-flight request as a kvtransfer payload
        (loop thread only): pin the slot's pages for the gather, copy them
        to host bytes, and pack them with the resume state — prompt and
        generated tokens, sampling knobs, and the pending-logits row
        (mid-decode) or the prefill cursor (mid-chunking). The slot keeps
        running; the caller decides whether to detach it."""
        req = self._slots[slot]
        assert req is not None, f"export of empty slot {slot}"
        cur = self._prefilling.get(slot)
        blocks = [b for b in range(self.n_blocks)
                  if self._tables[slot, b] >= 0]
        phys = [int(self._tables[slot, b]) for b in blocks]
        with obs_trace.span("engine.kv_export", trace_id=req.trace_id,
                            parent_id=req.span_id, model=self.name,
                            slot=str(slot), pages=str(len(blocks))):
            for pg in phys:
                self._mgr.incref(pg)  # pinned for the gather window
            try:
                frames = [r.tobytes() for r in self._gather_pages(phys)]
            finally:
                self._mgr.decref(phys)
            rd = req.deadline
            header: Dict[str, Any] = {
                "format": 1,
                "model": self.name,
                "page_size": self.page_size,
                "max_seq_len": int(self.cfg.max_seq_len),
                "vocab": int(self.cfg.vocab_size),
                "leaves": self._leaf_descriptors(),
                "blocks": blocks,
                "resume": kvtransfer.resume_key(
                    req.prompt, req.max_new, req.temperature, req.top_k,
                    req.seed, req.stop, req.adapter),
                "req": {
                    "prompt": req.prompt,
                    "tokens": list(req.tokens),
                    "max_new": req.max_new,
                    "temperature": req.temperature,
                    "top_k": req.top_k,
                    "seed": req.seed,
                    "stop": req.stop,
                    "adapter": req.adapter or "",
                    "qos": req.qos,
                    "tenant": req.tenant,
                    "deadline_s": (max(rd - time.monotonic(), 0.001)
                                   if rd is not None else 0.0),
                },
                # A port stream is a function of (seed, token index).
                "rng": None,
            }
            if cur is not None:
                # Mid-prefill: the receiver resumes chunking at ``next``.
                # ``n`` (the cursor's token count) is the port's own field:
                # it tells a plain continuation from a speculating one.
                header["phase"] = "prefill"
                header["cursor"] = {"next": int(cur["next"]),
                                    "bucket": int(cur["bucket"]),
                                    "remaining": int(cur["remaining"]),
                                    "fresh": bool(cur["fresh"]),
                                    "n": int(cur["n"])}
            else:
                header["phase"] = "decode"
                header["slot_state"] = {
                    "pos": int(self._pos[slot]),
                    "loc": int(self._loc[slot]),
                    "max_loc": int(self._max_loc[slot]),
                    "pending": int(self._pending[slot]),
                }
                # The next decode step samples from the slot's last logits
                # row: it is state, shipped as the AUX frame.
                logrow = self._logbuf[slot].float().cpu().numpy()
                header["aux"] = {"dtype": "float32",
                                 "shape": [int(d) for d in logrow.shape]}
                frames.append(logrow.tobytes())
            payload = kvtransfer.encode(header, frames)
        return req, payload, len(blocks)

    def migrate_out(self, reason: str = "manual",
                    send: Optional[Callable[[bytes], str]] = None,
                    rids: Optional[Sequence[int]] = None
                    ) -> Dict[str, int]:
        """Live migration: export every in-flight request (optionally only
        ``rids``), ship each through ``send`` (default: the engine's peer
        sender), and finish the local copy with RequestMigrated once the
        peer acknowledged. The local copy keeps decoding until then, so a
        severed transfer (the ``kv.transfer`` chaos point) loses nothing.
        Returns {"moved", "failed", "pages"}."""
        send = send if send is not None else self._peer_send
        if send is None:
            raise ValueError(
                f"engine {self.name} has no KV transfer peer configured")
        wanted = set(rids) if rids is not None else None

        def snap() -> List[Tuple[Request, bytes, int]]:
            return [self._export_slot(slot)
                    for slot, req in enumerate(self._slots)
                    if req is not None
                    and (wanted is None or req.rid in wanted)]

        moved = failed = pages = 0
        for req, payload, npages in self._run_on_loop(snap):
            t0 = time.monotonic()
            try:
                chaos.fail_or_delay("kv.transfer", kvtransfer.TransferError,
                                    self.name, target=self.name)
                peer = send(payload)
            except Exception:
                failed += 1  # the local copy keeps running: zero lost
                continue
            self._observe_transfer(time.monotonic() - t0)
            if self._run_on_loop(
                    lambda r=req, p=peer: self._finish_migrated(
                        r, p, reason)):
                moved += 1
                pages += npages
                self._count_migration(reason, npages)
            # else it retired while the bytes traveled: the peer's adopted
            # copy finishes unclaimed.
        return {"moved": moved, "failed": failed, "pages": pages}

    def _observe_transfer(self, seconds: float) -> None:
        self._reg().histogram(
            "kfx_lm_kv_transfer_seconds",
            "End-to-end KV transfer time (export snapshot to peer "
            "acknowledgement).", buckets=QUEUE_WAIT_BUCKETS).observe(
                seconds, model=self.name)

    def _count_migration(self, reason: str, npages: int) -> None:
        reg = self._reg()
        reg.counter("kfx_lm_kv_migrations_total",
                    "In-flight requests migrated to a peer replica, "
                    "by reason.").inc(1, model=self.name, reason=reason)
        reg.counter("kfx_lm_kv_pages_transferred_total",
                    "KV pages shipped to or adopted from peer "
                    "replicas.").inc(npages, model=self.name)

    def _finish_migrated(self, req: Request, peer: str,
                         reason: str) -> bool:
        """Detach a migrated request from its slot (loop thread): its pages
        release, and its waiter gets RequestMigrated naming ``peer``.
        False when the request already retired."""
        slot = next((s for s, r in enumerate(self._slots) if r is req),
                    None)
        if slot is None:
            return False
        self._prefilling.pop(slot, None)
        self._slots[slot] = None
        self._release_slot(slot)
        if self.flight is not None:
            self.flight.event(req, "migrated", peer=peer, reason=reason)
        req._finish(RequestMigrated(
            f"request migrated to {peer} ({reason})", peer=peer))
        self._touch_gauges()
        return True

    def kv_import(self, raw: bytes,
                  on_token: Optional[Callable[[Optional[int]], None]]
                  = None) -> Request:
        """Adopt a migrated request: verify the page stream (a broken chain
        digest raises TransferCorrupt and nothing is imported), check the
        geometry leaf for leaf, then install it in a free slot at the next
        iteration boundary, restoring the donor's slot state (mid-decode)
        or prefill cursor (mid-chunking). Returns the live Request. Raises
        TransferError / TransferCorrupt (nothing imported) or
        EngineOverloaded (no slot or pages: the donor keeps it)."""
        chaos.fail_or_delay("kv.transfer", kvtransfer.TransferCorrupt,
                            self.name, target=self.name)
        header, frames = kvtransfer.decode(raw)
        if int(header.get("format", -1)) != 1:
            raise kvtransfer.TransferError(
                f"unknown transfer format {header.get('format')!r}")
        if header.get("page_size") != self.page_size \
                or header.get("max_seq_len") != int(self.cfg.max_seq_len) \
                or header.get("vocab") != int(self.cfg.vocab_size) \
                or header.get("leaves") != self._leaf_descriptors():
            raise kvtransfer.TransferError(
                "kv geometry mismatch: donor and receiver caches are not "
                "leaf-for-leaf identical")
        r = header["req"]
        stop = int(r["stop"])
        req = self._make_request(
            r["prompt"], int(r["max_new"]), float(r["temperature"]),
            int(r["top_k"]), int(r["seed"]), None if stop < 0 else stop,
            tenant=r.get("tenant") or None,
            adapter=str(r.get("adapter") or ""),   # the donor's resolved one
            qos=r.get("qos"),
            deadline_s=float(r.get("deadline_s") or 0) or None)
        req.tokens = [int(t) for t in r["tokens"]]
        # The donor billed (and maybe streamed) these tokens: bill only
        # what this engine generates.
        req.meter_skip = len(req.tokens)
        req.counted = True
        req.t_admitted = time.monotonic()
        req.on_token = on_token
        self._run_on_loop(lambda: self._install_import(header, frames, req))
        return req

    def _install_import(self, header: Dict[str, Any],
                        frames: List[bytes], req: Request) -> None:
        """Install an adopted request (loop thread), all or nothing: every
        frame parses before the pool is touched, and a failure past
        allocation releases every page taken."""
        blocks = [int(b) for b in header["blocks"]]
        phase = header.get("phase", "decode")
        with obs_trace.span("engine.kv_import", trace_id=req.trace_id,
                            parent_id=req.span_id, model=self.name,
                            pages=str(len(blocks)), phase=phase):
            if self._draining:
                raise EngineDraining(
                    f"engine {self.name} is draining; the donor keeps the "
                    "request")
            slot = next((s for s, rq in enumerate(self._slots)
                         if rq is None), None)
            if slot is None:
                raise EngineOverloaded(
                    f"engine {self.name} has no free slot for a KV import")
            if any(b < 0 or b >= self.n_blocks for b in blocks):
                raise kvtransfer.TransferError("block index out of range")
            full = req.prompt + req.tokens
            if phase == "decode":
                st = header["slot_state"]
                if int(st["pending"]) >= 0 and not self.spec:
                    raise kvtransfer.TransferError(
                        "pending speculative token requires a speculative "
                        "receiver")
                if len(frames) != len(blocks) + 1:
                    raise kvtransfer.TransferError(
                        f"expected {len(blocks)} pages + 1 aux frame, got "
                        f"{len(frames)}")
                aux = header.get("aux") or {}
                if aux.get("dtype", "float32") != "float32" or \
                        len(frames[-1]) != 4 * self.cfg.vocab_size:
                    raise kvtransfer.TransferError(
                        "pending-logits frame does not match the vocab")
                logrow = np.frombuffer(frames[-1], np.float32).copy()
            elif phase == "prefill":
                cur = header["cursor"]
                # A speculating engine's continuation leaves the last
                # generated token (its pending token) out of the prefill.
                if self.spec and req.tokens:
                    full = full[:-1]
                if int(cur.get("n", len(full))) != len(full):
                    raise kvtransfer.TransferError(
                        "mid-prefill continuation between a speculating "
                        "and a plain engine")
                if len(frames) != len(blocks):
                    raise kvtransfer.TransferError(
                        f"expected {len(blocks)} pages, got {len(frames)}")
            else:
                raise kvtransfer.TransferError(f"unknown phase {phase!r}")
            rows = self._unpack_pages(frames[:len(blocks)])
            aid = -1
            if req.adapter:
                aid = self._resolve_adapter(req)  # raises = refusal
                if aid < 0:
                    raise kvtransfer.TransferError(
                        f"imported pages hold adapter KV but "
                        f"{req.adapter!r} degraded to base here")
            try:
                pages = self._alloc_pages(len(blocks))
            except PageAllocError:
                if aid >= 0:
                    self._apool.release(aid)
                raise
            try:
                self._scatter_pages(rows, pages)
            except Exception:
                self._mgr.decref(pages)  # discard the partial import whole
                if aid >= 0:
                    self._apool.release(aid)
                raise
            trow = np.full((self.n_blocks,), -1, np.int32)
            for b, pg in zip(blocks, pages):
                trow[b] = pg
            self._tables[slot] = trow
            self._slot_pages[slot] = list(pages)
            self._aids[slot] = aid
            n, ps = len(full), self.page_size
            # Register the imported PROMPT pages in the local prefix cache:
            # a migration carries its share of the fleet cache along.
            root = self._root_for(req, aid)
            key = root
            covered = len(req.prompt) // ps
            if phase == "prefill":
                covered = min(int(header["cursor"]["next"]),
                              len(req.prompt)) // ps
            reg_block = covered
            if self._prefix is not None:
                reg_block = 0
                for b in range(covered):
                    pg = int(trow[b])
                    if pg < 0:
                        break
                    key = self._prefix.insert_full(
                        key, full[b * ps:(b + 1) * ps], pg, root=root)
                    reg_block = b + 1
            if phase == "prefill":
                cur = header["cursor"]
                self._active[slot] = False
                self._pending[slot] = -1
                self._slots[slot] = req
                self._prefilling[slot] = {
                    "req": req, "full": full, "n": n,
                    "next": int(cur["next"]), "key": key,
                    "reg_block": reg_block, "root": root,
                    "bucket": int(cur["bucket"]),
                    "remaining": int(cur["remaining"]),
                    "fresh": bool(cur.get("fresh"))}
            else:
                self._logbuf[slot] = torch.from_numpy(logrow).to(
                    self.device)
                self._pos[slot] = int(st["pos"])
                self._loc[slot] = int(st["loc"])
                self._max_loc[slot] = int(st["max_loc"])
                self._pending[slot] = int(st["pending"])
                self._produced[slot] = len(req.tokens)
                self._seeds[slot] = seed32(req.seed)
                self._temp[slot] = req.temperature
                self._topk[slot] = req.top_k
                self._stop[slot] = req.stop
                self._max_new[slot] = req.max_new
                # An adopted slot never speculates: the draft pool holds
                # none of its KV (the verify window serves it a token an
                # iteration).
                self._spec_ok[slot] = False
                self._active[slot] = True
                self._slots[slot] = req
            if self.flight is not None:
                self.flight.event(req, "kv_import", pages=len(blocks),
                                  phase=phase)
            self._reg().counter(
                "kfx_lm_kv_pages_transferred_total",
                "KV pages shipped to or adopted from peer replicas.").inc(
                    len(blocks), model=self.name)
            self._touch_gauges()

    def _handoff_ready(self) -> None:
        """Prefill-role hand-off (loop thread): every active slot whose
        prefill just completed exports NOW, before this iteration's decode
        step, and ships from a side thread while the loop goes on. A
        failed transfer leaves the slot decoding locally."""
        for slot, req in enumerate(self._slots):
            if req is None or not self._active[slot] \
                    or slot in self._prefilling \
                    or req.rid in self._handoff_skip:
                continue
            if len(self._handoff_skip) > 4096:
                self._handoff_skip.clear()
            self._handoff_skip.add(req.rid)
            try:
                _, payload, npages = self._export_slot(slot)
            except Exception:
                continue  # decode locally
            threading.Thread(
                target=self._handoff_send, args=(req, payload, npages),
                name=f"kfx-kv-handoff-{self.name}", daemon=True).start()

    def _handoff_send(self, req: Request, payload: bytes,
                      npages: int) -> None:
        t0 = time.monotonic()
        try:
            chaos.fail_or_delay("kv.transfer", kvtransfer.TransferError,
                                self.name, target=self.name)
            peer = self._peer_send(payload)
        except Exception:
            return  # the slot decodes locally: zero lost
        self._observe_transfer(time.monotonic() - t0)
        try:
            if self._run_on_loop(lambda: self._finish_migrated(
                    req, peer, "disagg")):
                self._count_migration("disagg", npages)
        except (RuntimeError, TimeoutError):
            pass  # engine closed mid-hand-off; the peer copy idles out

    # -- host-RAM offload tier -----------------------------------------------
    def _offload_gauge(self) -> None:
        self._reg().gauge(
            "kfx_lm_kv_offload_pages",
            "Prefix-cache pages held per KV offload tier.").set(
                len(self._offload), model=self.name, tier="host")

    def _spill_page(self, e: _PrefixEntry) -> None:
        """Demote one evicted prefix page into the host tier (evict_one
        selects only pages no slot reads). Partial boundary pages are
        skipped: they are COW sources keyed by token comparison. The
        ``kv.offload`` chaos point (or a failed gather) drops the
        demotion: the page's next miss recomputes."""
        if e.partial:
            return
        inj = chaos.draw("kv.offload", target=self.name)
        if inj is not None:
            if inj.delay > 0:
                time.sleep(inj.delay)
            if inj.mode != "delay":
                return
        try:
            self._offload.put(e.key, self._page_payload(e.page))
        except Exception:
            return
        self._offload_gauge()

    def _promote_offloaded(self, full: List[int], max_reuse: int,
                           shared: List[int], matched: int, key: bytes,
                           root: bytes = b"") -> Tuple[int, bytes]:
        """Extend a prefix-cache match from the host tier: while the next
        full page's chain hash is resident in host RAM, allocate a page,
        scatter the payload back and register it as a live cache entry,
        so the admission skips that much more prefill. ``shared`` grows in
        place. Pool pressure, geometry drift or the ``kv.offload`` chaos
        point stop the walk (the tail re-prefills). The decode chunk's
        shapes never change: promotion happens at admission."""
        ps = self.page_size
        base = list(shared)
        for pg in base:
            self._mgr.incref(pg)  # eviction guard: promote allocs may
        ours: List[int] = []      # reclaim LRU cache pages
        while matched + ps <= max_reuse:
            nxt = _chain_hash(key, full[matched:matched + ps])
            payload = self._offload.get(nxt)
            if payload is None:
                break
            inj = chaos.draw("kv.offload", target=self.name)
            if inj is not None:
                if inj.delay > 0:
                    time.sleep(inj.delay)
                if inj.mode != "delay":
                    break  # promotion refused: the tail re-prefills
            try:
                row = self._unpack_pages([payload])
            except kvtransfer.TransferError:
                self._offload.pop(nxt)  # stale geometry: unusable
                break
            try:
                page = self._alloc_pages(1)[0]
            except PageAllocError:
                break
            try:
                self._scatter_pages(row, [page])
            except Exception:
                self._mgr.decref(base + ours + [page])
                raise
            self._offload.pop(nxt)
            self._prefix.insert_full(key, full[matched:matched + ps], page,
                                     root=root)
            ours.append(page)
            shared.append(page)
            key = nxt
            matched += ps
        # Promoted pages keep their cache ref; ours and the guards drop
        # here (the caller pins ``shared`` right after, on this thread).
        self._mgr.decref(base + ours)
        if ours:
            self._offload_gauge()
        return matched, key

    # -- the loop -------------------------------------------------------------
    def _loop(self) -> None:
        # Both are thread-local: the loop thread selects the device and
        # enters inference mode itself.
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.inference_mode():
            self._run_loop()

    def _run_loop(self) -> None:
        while True:
            with self._cond:
                while (not self._stopped and not self._queue
                       and self._active_count() == 0
                       and not self._control):
                    self._cond.wait()
                if self._stopped:
                    return
            try:
                # KV-transfer control jobs first (export snapshots, import
                # installs, detaches): slot-state surgery at a quiesced
                # iteration boundary, like admission.
                self._service_control()
                # Prefill dispatch time (a monolithic admission's, or this
                # iteration's one prompt chunk) is decode stall only when
                # active decode slots existed to be stalled by it.
                self._iter_stall = 0.0
                had_active = bool(self._active.any())
                self._admit_ready()
                if self._active_count():
                    self._maybe_wedge()
                    # At most ONE prompt-chunk dispatch per iteration.
                    self._advance_prefill()
                    if had_active and self._iter_stall > 0:
                        self._reg().histogram(
                            "kfx_lm_decode_stall_seconds",
                            "Seconds active decode slots waited on a "
                            "prefill dispatch, per engine iteration.",
                            buckets=QUEUE_WAIT_BUCKETS).observe(
                                self._iter_stall, model=self.name)
                        # Attribute the stall to every active request that
                        # waited through it (the ``stalled_s`` leg of the
                        # flight recorder's breakdown).
                        if self.flight is not None:
                            for slot, r in enumerate(self._slots):
                                if r is not None and self._active[slot]:
                                    r.stall_s += self._iter_stall
                    if self.role == "prefill" \
                            and self._peer_send is not None:
                        # Disaggregation: ship every freshly prefilled
                        # slot toward a decode peer BEFORE this
                        # iteration's decode step.
                        self._handoff_ready()
                    if bool(self._active.any()):
                        self._decode_once()
                if self.flight is not None:
                    self._record_flight()
                # The progress heartbeat: one completed iteration.
                self._iterations += 1
                self._last_progress = time.monotonic()
            except Exception as e:     # a broken dispatch fails the
                self._fail_inflight(e)  # requests, never the engine;
                time.sleep(0.01)        # KeyboardInterrupt/SystemExit
                #                         propagate (shutdown)

    def _record_flight(self) -> None:
        """Append this iteration's flight record (loop thread, end of the
        iteration, so a loop stuck mid-iteration leaves the ring frozen at
        the last completed one). Host state only: slot bookkeeping, the
        free lists and the spec counters; no tensor is read, so the
        record adds no device sync. Queue depth is read without the lock
        (a one-record-stale depth is fine for forensics)."""
        active, prefilling = [], []
        for slot, r in enumerate(self._slots):
            if r is None:
                continue
            if slot in self._prefilling:
                prefilling.append((slot, r.rid))
            elif self._active[slot]:
                active.append((slot, r.rid))
        self.flight.record_iteration(
            iteration=self._iterations,
            active=active, prefilling=prefilling,
            pages_free=self._mgr.n_free,
            draft_pages_free=(self._draft_mgr.n_free
                              if self._draft_mgr is not None else 0),
            spec_proposed=self._spec_proposed,
            spec_accepted=self._spec_accepted,
            stall_s=self._iter_stall,
            queue_depth=len(self._queue),
            preemptions=self._preempts)

    def _admit_ready(self) -> None:
        """Admit queued requests into free slots (between chunks, never
        mid-dispatch). Admission is gated on free PAGES: a request the
        pool cannot hold right now stays queued while in-flight work
        retires; if nothing is in flight to free pages, it fails."""
        while True:
            with self._cond:
                free = [i for i, r in enumerate(self._slots) if r is None]
                if not free or not self._queue:
                    break
                req = self._queue.pop()
                self._admitting = req
            requeued = False
            try:
                # Deadline gate at the slot boundary, BEFORE prefill: a
                # request whose deadline expired while queued sheds here
                # (a requeued preempt's included).
                if req.deadline is not None \
                        and time.monotonic() >= req.deadline:
                    self._count_shed("kfx_lm_deadline_shed_total")
                    req._finish(DeadlineInfeasible(
                        "deadline expired while queued (waited "
                        f"{time.monotonic() - req.t_enqueue:.2f}s)"))
                    continue
                self._admit(req, free[0])
            except PageAllocError as e:
                if self._active_count() == 0:
                    req._finish(e)
                else:
                    with self._cond:
                        self._queue.push_front(req)
                    requeued = True
            except Exception as e:
                if self._slots[free[0]] is req:
                    # Placed, then the draft's prefill dispatch failed:
                    # fail every in-flight request (the loop's handler).
                    raise
                # A failed prefill fails THIS request alone; the loop keeps
                # serving everyone else.
                req._finish(e)
            finally:
                self._admitting = None
            if requeued:
                break
        self._touch_gauges()

    def _admit(self, req: Request, slot: int) -> None:
        # Fault point: admission failure or latency (the engine's
        # serving.predict).
        inj = chaos.draw("engine.admit", target=self.name)
        if inj is not None:
            if inj.delay > 0:
                time.sleep(inj.delay)
            if inj.mode != "delay":
                req._finish(RuntimeError(f"chaos[engine.admit]: {self.name}"))
                return
        # The adapter resolves BEFORE any page work (prompt KV is adapter
        # KV). AdapterLoadError under fallback "error" fails this request
        # through _admit_ready; AdapterSlotError requeues like page
        # pressure. An admission that does not place the request releases
        # the pin (unless _fail_inflight already dropped every pin).
        aid = self._resolve_adapter(req)
        try:
            self._admit_resolved(req, slot, aid)
        finally:
            if aid >= 0 and self._slots[slot] is not req \
                    and self._apool.ref[aid] > 0:
                self._apool.release(aid)

    def _resolve_adapter(self, req: Request) -> int:
        """The request's adapter slot for this admission: acquire (paging
        the artifact in if needed) and pin it. A LOAD failure follows
        ``adapter_fallback``: "base" serves the base (-1) and counts
        ``kfx_lm_adapter_fallbacks_total``; "error" re-raises
        AdapterLoadError. AdapterSlotError (every slot pinned) always
        propagates: pool pressure, handled like KV-page exhaustion."""
        if self._apool is None or not req.adapter:
            return -1
        try:
            return self._apool.acquire(req.adapter)
        except AdapterSlotError:
            raise
        except AdapterLoadError:
            if self.adapter_fallback == "error":
                raise
            self._reg().counter(
                "kfx_lm_adapter_fallbacks_total",
                "Requests degraded to base-only after an adapter "
                "load failure (adapters.fallback=base).").inc(
                    1, model=self.name)
            return -1

    @staticmethod
    def _root_for(req: Request, aid: int) -> bytes:
        """The prefix-cache chain root of an admission: the RESOLVED
        adapter's name (cached pages hold adapter KV, so the same tokens
        under two adapters never share a page), "" for the base, a
        request that fell back to the base included."""
        return req.adapter.encode() if (req.adapter and aid >= 0) else b""

    def _admit_resolved(self, req: Request, slot: int, aid: int) -> None:
        L, ps = self.cfg.max_seq_len, self.page_size
        # Recompute continuation: a preempted request re-prefills prompt +
        # already-generated (the same values incremental decode wrote) and
        # keeps appending to the same token list. A speculating request's
        # last token is its pending token (emitted, never in a pool): it
        # stays out of the prefill and opens the next verify window, so
        # the windows realign as if the request had never left.
        full = req.prompt + req.tokens
        remaining = req.max_new - len(req.tokens)
        if self.spec and req.tokens:
            full, remaining = full[:-1], remaining + 1
        n = len(full)
        bucket = pow2_bucket(n, L - remaining)
        # Shared-prefix reuse, capped at n-1: the last prompt token must
        # run through the model for the next-token logits.
        root = self._root_for(req, aid)
        shared: List[int] = []
        cow = None
        matched = 0
        key = root
        if self._prefix is not None:
            shared, cow, matched, key = self._prefix.match(full, n - 1,
                                                           root=root)
            if self._offload is not None and cow is None \
                    and len(self._offload):
                # A page-aligned match may extend from the host offload
                # tier; past a COW match the chain cannot fold.
                matched, key = self._promote_offloaded(
                    full, n - 1, shared, matched, key, root=root)
        tail = full[matched:]
        if self.prefill_chunk_tokens and \
                len(tail) > self.prefill_chunk_tokens:
            return self._admit_chunked(req, slot, full, n, remaining,
                                       bucket, shared, cow, matched, key,
                                       aid, root)
        first_own = len(shared)  # COW lands in the first owned block
        # The matched pages (and the COW source) are pinned FIRST:
        # _alloc_pages reclaims LRU cache pages, and an unpinned
        # just-matched page could be handed back as a tail page.
        pinned = shared + ([cow[0]] if cow is not None else [])
        for pg in pinned:
            self._mgr.incref(pg)
        want_blocks = list(range(first_own, (n - 1) // ps + 1))
        if bucket // ps > (n - 1) // ps:
            # Reserve the first decode block too when the pad gap puts it
            # past the prompt blocks, or the admission would be preempted
            # at the very next chunk boundary under pool pressure.
            want_blocks.append(bucket // ps)
        try:
            pages = self._alloc_pages(len(want_blocks))
        except PageAllocError:
            self._mgr.decref(pinned)
            raise
        row = np.full((self.n_blocks,), -1, np.int32)
        for j, pg in enumerate(shared):
            row[j] = pg
        for b, pg in zip(want_blocks, pages):
            row[b] = pg
        self._count_admission(req, matched, n)
        t_dispatch = time.monotonic()
        with obs_trace.span("engine.admit", trace_id=req.trace_id,
                            parent_id=req.span_id, model=self.name,
                            slot=str(slot), bucket=str(bucket),
                            prefix_tokens=str(matched)):
            try:
                if cow is not None:
                    self._copy_page(int(row[first_own]), cow[0], cow[1])
                self._logbuf[slot] = self._prefill(tail, matched, row,
                                                   aid=aid)
            except Exception:
                self._mgr.decref(pinned + pages)
                raise
        # A monolithic prefill is decode stall for every active slot.
        self._iter_stall += time.monotonic() - t_dispatch
        if cow is not None:
            # The COW source's pin was only for the copy window; the slot
            # keeps the private clone.
            self._mgr.decref([cow[0]])
        self._tables[slot] = row
        self._slot_pages[slot] = shared + pages
        # Register this prompt's pages for future admissions: every full
        # prompt page not already cached, chained after the matched
        # prefix, plus the partially-filled boundary page.
        if self._prefix is not None:
            h = key
            for b in range(len(shared), n // ps):
                h = self._prefix.insert_full(
                    h, full[b * ps:(b + 1) * ps], int(row[b]), root=root)
            if n % ps and row[n // ps] >= 0:
                self._prefix.insert_partial(
                    h, full[(n // ps) * ps:n], int(row[n // ps]),
                    root=root)
        self._aids[slot] = aid    # the slot owns the adapter pin now
        self._slots[slot] = req
        self._activate(slot, req, full, bucket, remaining)

    def _activate(self, slot: int, req: Request, full: List[int],
                  bucket: int, remaining: int) -> None:
        """The slot's decode state once its whole prompt ``full`` is in the
        pool: decode writes start at the bucket (the dense-equivalent
        location) and the sampling stream continues at
        ``len(req.tokens)``. With a draft, the pending token is the
        request's last (a requeue) or none yet (-1), and the draft
        prefills ``full`` into its own pool."""
        n = len(full)
        self._pos[slot] = n
        self._loc[slot] = bucket
        self._max_loc[slot] = bucket + remaining - 1
        self._active[slot] = True
        self._produced[slot] = len(req.tokens)
        self._seeds[slot] = seed32(req.seed)
        self._temp[slot] = req.temperature
        self._topk[slot] = req.top_k
        self._stop[slot] = req.stop
        self._max_new[slot] = req.max_new
        if self.spec:
            self._pending[slot] = req.tokens[-1] if req.tokens else -1
            self._admit_draft(slot, full)

    def _admit_draft(self, slot: int, full: List[int]) -> None:
        """Prefill the WHOLE prompt into the slot's draft pages (the draft
        has no prefix cache; at draft depth the full prompt is cheap and
        keeps both pools' logical layouts identical). A draft-pool
        shortfall degrades the slot to non-speculative decode; a failed
        dispatch raises (the loop fails the in-flight requests)."""
        n, ps = len(full), self.page_size
        try:
            pages = self._alloc_draft_pages((n - 1) // ps + 1)
        except PageAllocError:
            self._spec_degraded += 1
            self._spec_ok[slot] = False
            return
        self._draft_tables[slot, :len(pages)] = pages
        self._draft_slot_pages[slot] = pages
        self._spec_ok[slot] = True
        self._prefill(full, 0, self._draft_tables[slot], draft=True,
                      aid=int(self._aids[slot]))

    def _count_admission(self, req: Request, matched: int, n: int) -> bool:
        """First-admission stats, counted once per CLIENT request: the
        queue-wait histogram, the prefix-hit counters and the
        admitted-prompt-token total. Returns whether it counted."""
        if req.counted:
            return False
        req.counted = True
        req.t_admitted = time.monotonic()
        if self.flight is not None:
            self.flight.event(req, "admit", matched=matched, prompt=n)
        wait = req.t_admitted - req.t_enqueue
        # The trailing queue-wait EWMA the deadline feasibility check
        # reads, biased toward recency (0.3) so a drained backlog stops
        # shedding within a few admissions.
        self._qwait_ewma = wait if self._qwait_ewma <= 0.0 \
            else 0.7 * self._qwait_ewma + 0.3 * wait
        self._reg().histogram(
            "kfx_lm_queue_wait_seconds",
            "Decode-engine admission wait (enqueue to slot prefill).",
            buckets=QUEUE_WAIT_BUCKETS).observe(wait, model=self.name)
        if self._apool is not None:
            # Per-tenant traffic ("" counts as the base tenant).
            self._reg().counter(
                "kfx_lm_adapter_requests_total",
                "Admitted client requests by adapter tenant.").inc(
                    1, model=self.name, adapter=req.adapter or "base")
        if req._usage is not None:
            # Admission billing, under the same ``counted`` latch: a
            # preempted request's recompute never bills twice.
            req._usage.admit(req.tenant, req.qos, req.adapter or "base",
                             len(req.prompt))
        if self._prefix is not None:
            if matched:
                self._count_prefix_hit(matched)
            self._prompt_tokens += n
        return True

    def _count_prefix_hit(self, matched: int) -> None:
        self._prefix.hits += 1
        self._prefix.tokens_reused += matched
        self._reg().counter(
            "kfx_lm_prefix_cache_hits_total",
            "Admissions that reused cached prefix pages.").inc(
                1, model=self.name)

    def _clone_cow_page(self, pinned: List[int], cow) -> int:
        """One COW boundary-page clone for the chunked paths: allocate a
        private page, copy ``cow`` into it (the source is already pinned
        via ``pinned``), release the source's pin. On failure every pin
        in ``pinned`` (and the clone) is released before re-raising."""
        try:
            page = self._alloc_pages(1)[0]
        except PageAllocError:
            self._mgr.decref(pinned)
            raise
        try:
            self._copy_page(page, cow[0], cow[1])
        except Exception:
            self._mgr.decref(pinned + [page])
            raise
        self._mgr.decref([cow[0]])
        return page

    def _admit_chunked(self, req: Request, slot: int, full: List[int],
                       n: int, remaining: int, bucket: int,
                       shared: List[int], cow, matched: int,
                       key: bytes, aid: int = -1,
                       root: bytes = b"") -> None:
        """Chunked admission: place the request in the slot WITHOUT a
        prompt dispatch — pin the matched prefix pages (and clone the COW
        boundary page), count the admission as the monolithic path does,
        and leave a prefill cursor for the loop to advance one chunk per
        iteration. The slot is not active until the cursor completes."""
        first_own = len(shared)
        pinned = shared + ([cow[0]] if cow is not None else [])
        for pg in pinned:
            self._mgr.incref(pg)
        with obs_trace.span("engine.admit", trace_id=req.trace_id,
                            parent_id=req.span_id, model=self.name,
                            slot=str(slot), bucket=str(bucket),
                            prefix_tokens=str(matched), chunked="1"):
            cow_page = None
            if cow is not None:
                cow_page = self._clone_cow_page(pinned, cow)
        row = np.full((self.n_blocks,), -1, np.int32)
        for j, pg in enumerate(shared):
            row[j] = pg
        own: List[int] = []
        if cow_page is not None:
            row[first_own] = cow_page
            own.append(cow_page)
        fresh = self._count_admission(req, matched, n)
        self._tables[slot] = row
        self._slot_pages[slot] = shared + own
        self._active[slot] = False
        self._aids[slot] = aid    # the slot owns the adapter pin now
        self._slots[slot] = req
        self._prefilling[slot] = {
            "req": req, "full": full, "n": n, "next": matched,
            "key": key, "reg_block": len(shared), "root": root,
            "bucket": bucket, "remaining": remaining,
            # Whether THIS admission counted as a client admission: the
            # late re-match's hit accounting follows the same verdict.
            "fresh": fresh}

    def _advance_prefill(self) -> None:
        """Advance chunked prefill by at most ONE chunk dispatch per
        iteration (oldest cursor first). Pages allocate at the chunk
        boundary; pool exhaustion preempts the youngest in-flight slot,
        which may be this cursor itself (re-queued whole)."""
        if not self._prefilling:
            return
        slot = min(self._prefilling,
                   key=lambda s: self._prefilling[s]["req"].t_enqueue)
        cur = self._prefilling[slot]
        req = cur["req"]
        if self._prefix is not None and cur["next"] == 0 \
                and not self._slot_pages[slot]:
            # Late prefix match, once per cursor before its first chunk:
            # the page owner may have been mid-prefill in the SAME wave,
            # and its completed chunks have registered by now.
            self._late_prefix_match(slot, cur)
        ps = self.page_size
        start, n = cur["next"], cur["n"]
        length = min(self.prefill_chunk_tokens, n - start)
        last = start + length >= n
        # Page budget: this chunk's blocks, plus (on the final chunk) the
        # first decode block when the pad gap puts it past the prompt.
        blocks = list(range(start // ps, (start + length - 1) // ps + 1))
        if last and cur["bucket"] // ps > (n - 1) // ps:
            blocks.append(cur["bucket"] // ps)
        while True:
            try:
                for b in blocks:
                    if self._tables[slot, b] < 0:
                        pg = self._alloc_pages(1)[0]
                        self._tables[slot, b] = pg
                        self._slot_pages[slot].append(pg)
                break
            except PageAllocError as e:
                victims = [s for s, r in enumerate(self._slots)
                           if r is not None]
                if len(victims) <= 1:
                    # Nothing in flight can free pages: fail honestly.
                    self._abort_prefill(slot, e)
                    return
                victim = self._preempt_victim(victims)
                self._preempt(victim)
                if victim == slot:
                    return  # this cursor was the victim: re-queued
        t_dispatch = time.monotonic()
        with obs_trace.span("engine.prefill_chunk",
                            trace_id=req.trace_id,
                            parent_id=req.span_id, model=self.name,
                            slot=str(slot), start=str(start),
                            tokens=str(length)):
            try:
                self._logbuf[slot] = self._prefill(
                    cur["full"][start:start + length], start,
                    self._tables[slot], aid=int(self._aids[slot]))
            except Exception as e:
                self._abort_prefill(slot, e)
                return
        self._iter_stall += time.monotonic() - t_dispatch
        self._reg().counter(
            "kfx_lm_prefill_chunks_total",
            "Prompt-chunk prefill dispatches (chunked admission).").inc(
                1, model=self.name)
        if self.flight is not None:
            self.flight.event(req, "prefill_chunk", start=start,
                              tokens=length)
        cur["next"] = start + length
        self._register_prefix_pages(slot, cur, final=last)
        if last:
            self._prefilling.pop(slot)
            self._activate(slot, req, cur["full"], cur["bucket"],
                           cur["remaining"])

    def _late_prefix_match(self, slot: int, cur: Dict[str, Any]) -> None:
        """Adopt a prefix-cache match for a cursor that admitted against
        an empty match: pin the matched full pages, clone the COW boundary
        page, and fast-forward the cursor. A failed COW allocation
        abandons the match; plain chunked prefill continues."""
        shared, cow, matched, key = self._prefix.match(
            cur["full"], cur["n"] - 1, root=cur["root"])
        if not matched:
            return
        pinned = shared + ([cow[0]] if cow is not None else [])
        for pg in pinned:
            self._mgr.incref(pg)
        cow_page = None
        if cow is not None:
            try:
                cow_page = self._clone_cow_page(pinned, cow)
            except PageAllocError:
                return   # match abandoned; plain prefill continues
        own = list(shared)
        for j, pg in enumerate(shared):
            self._tables[slot, j] = pg
        if cow_page is not None:
            self._tables[slot, len(shared)] = cow_page
            own.append(cow_page)
        self._slot_pages[slot] = own
        cur["next"] = matched
        cur["key"] = key
        cur["reg_block"] = len(shared)
        if cur["fresh"]:
            self._count_prefix_hit(matched)

    def _register_prefix_pages(self, slot: int, cur: Dict[str, Any],
                               final: bool) -> None:
        """Incremental prefix-cache registration: every full prompt page
        the cursor has covered chains after the matched prefix, and the
        partially-filled boundary page registers once at completion."""
        if self._prefix is None:
            return
        ps = self.page_size
        n, full = cur["n"], cur["full"]
        h = cur["key"]
        covered = min(cur["next"], n) // ps
        b = cur["reg_block"]
        while b < covered:
            h = self._prefix.insert_full(
                h, full[b * ps:(b + 1) * ps], int(self._tables[slot, b]),
                root=cur["root"])
            b += 1
        cur["key"], cur["reg_block"] = h, b
        if final and n % ps and self._tables[slot, n // ps] >= 0:
            self._prefix.insert_partial(
                h, full[(n // ps) * ps:n], int(self._tables[slot, n // ps]),
                root=cur["root"])

    def _abort_prefill(self, slot: int, error: BaseException) -> None:
        """Tear a prefill cursor down, releasing the slot's pages whole,
        and fail its request ALONE with ``error``."""
        cur = self._prefilling.pop(slot)
        self._slots[slot] = None
        self._release_slot(slot)
        cur["req"]._finish(error)

    def _ensure_chunk_pages(self) -> None:
        """Allocate, at the chunk boundary, every page the next chunk may
        write (decode locations loc..loc+k-1, capped at the slot's
        budget). On pool exhaustion the YOUNGEST slot is preempted, so the
        oldest requests always make progress; a lone slot that still
        cannot be placed fails with PageAllocError."""
        while True:
            try:
                for slot, req in enumerate(self._slots):
                    if req is None or not self._active[slot]:
                        continue
                    lo = int(self._loc[slot])
                    hi = min(lo + self.chunk_tokens - 1,
                             int(self._max_loc[slot]))
                    for b in range(lo // self.page_size,
                                   hi // self.page_size + 1):
                        if self._tables[slot, b] < 0:
                            pg = self._alloc_pages(1)[0]
                            self._tables[slot, b] = pg
                            self._slot_pages[slot].append(pg)
                return
            except PageAllocError:
                # Mid-prefill slots are victims too: their pages are as
                # reclaimable as a decoder's.
                victims = [s for s, r in enumerate(self._slots)
                           if r is not None]
                if len(victims) <= 1:
                    raise
                self._preempt(self._preempt_victim(victims))

    def _preempt_victim(self, victims: List[int]) -> int:
        """QoS-aware victim: a batch slot before any interactive one, and
        the YOUNGEST within a class, so the oldest requests of the better
        class always make progress."""
        return max(victims, key=lambda s: (self._slots[s].qos == "batch",
                                           self._slots[s].t_enqueue))

    def _preempt(self, slot: int) -> None:
        req = self._slots[slot]
        self._prefilling.pop(slot, None)
        self._slots[slot] = None
        self._release_slot(slot)
        self._reg().counter(
            "kfx_lm_kv_preemptions_total",
            "Slots preempted (recompute-requeued) on pool exhaustion."
            ).inc(1, model=self.name)
        self._preempts += 1
        req.preempts += 1
        if self.flight is not None:
            self.flight.event(req, "preempt", slot=slot)
        with self._cond:
            self._queue.push_front(req)

    def _decode_once(self) -> None:
        if self.spec:
            return self._spec_once()
        self._ensure_chunk_pages()
        if not self._active.any():
            return  # every decoding slot preempted away
        self._maybe_kv_quant_chaos()
        oldest = min((r for r in self._slots if r is not None),
                     key=lambda r: r.t_enqueue)
        with obs_trace.span("engine.chunk", trace_id=oldest.trace_id,
                            parent_id=oldest.span_id, model=self.name,
                            slots=str(int(self._active.sum())),
                            k=str(self.chunk_tokens)):
            toks, emits = self._decode_chunk()
        reg = self._reg()
        reg.counter("kfx_lm_engine_chunks_total",
                    "Decode-chunk dispatches.").inc(1, model=self.name)
        emitted = 0
        now = time.monotonic()
        for slot, req in enumerate(self._slots):
            if req is None or slot in self._prefilling:
                # A mid-prefill slot rides the dispatch fully masked:
                # inactive by design, not retired.
                continue
            hits = np.flatnonzero(emits[:, slot])
            fresh = [int(t) for t in toks[hits, slot]]
            req.tokens.extend(fresh)
            if req.on_token is not None:
                for t in fresh:
                    req._notify(t)
            emitted += len(hits)
            if len(hits) and req.t_first == 0.0:
                req.t_first = now
                if self.flight is not None:
                    self.flight.event(req, "first_token")
            if not self._active[slot]:
                self._slots[slot] = None
                self._release_slot(slot)
                req._finish()
        if emitted:
            reg.counter("kfx_lm_generated_tokens_total",
                        "Tokens generated since startup.").inc(
                            emitted, model=self.name)
        self._touch_gauges()

    # -- speculative decoding --------------------------------------------------
    def _ensure_spec_pages(self) -> None:
        """The next verify window's page budget, at the iteration boundary:
        a speculating slot writes target locations loc..loc+k (pending and
        k proposals) and the same span of the draft pool (k proposals and
        the catch-up token); a degraded slot writes only the pending token
        at loc. Target-pool exhaustion preempts the youngest slot (both
        pools freed); draft-pool exhaustion degrades the slot."""
        k, ps = self.propose_tokens, self.page_size

        def span_of(slot):
            lo = int(self._loc[slot])
            hi = min(lo + k, int(self._max_loc[slot])) \
                if self._spec_ok[slot] else lo
            return range(lo // ps, hi // ps + 1)

        while True:
            try:
                for slot, req in enumerate(self._slots):
                    if req is None or not self._active[slot]:
                        continue
                    for b in span_of(slot):
                        if self._tables[slot, b] < 0:
                            pg = self._alloc_pages(1)[0]
                            self._tables[slot, b] = pg
                            self._slot_pages[slot].append(pg)
                break
            except PageAllocError:
                victims = [s for s, r in enumerate(self._slots)
                           if r is not None]
                if len(victims) <= 1:
                    raise
                self._preempt(self._preempt_victim(victims))
        for slot in np.flatnonzero(self._active & self._spec_ok):
            try:
                for b in span_of(slot):
                    if self._draft_tables[slot, b] < 0:
                        pg = self._alloc_draft_pages(1)[0]
                        self._draft_tables[slot, b] = pg
                        self._draft_slot_pages[slot].append(pg)
            except PageAllocError:
                self._release_draft(slot)
                self._spec_degraded += 1

    def _invalidate_window(self, cache: PagedKVCache, tables: torch.Tensor,
                           locs: torch.Tensor) -> None:
        """Stamp position -1 at per-slot locations ``locs`` [B, S] (-1 =
        skip) with the writes' location math (same table lookup, skips to
        the sink), so exactly the entries a window wrote are killed."""
        P, N = self.page_size, cache.pos.shape[1] - 1
        ok = locs >= 0
        blk = torch.where(ok, locs // P, 0).long()
        page = torch.gather(tables, 1, blk)
        page = torch.where(ok & (page >= 0), page, N).long()
        slot = torch.where(ok, locs % P, 0).long()
        cache.pos[:, page.reshape(-1), slot.reshape(-1)] = -1

    def _spec_launch(self, fresh: np.ndarray, spec_on: np.ndarray,
                     draft_live: Optional[np.ndarray] = None
                     ) -> torch.Tensor:
        """Enqueue one speculative iteration over every slot at fixed
        shapes (nothing here waits for the device):

          1. the pending token: ``fresh`` slots sample it from their
             prefill logits at token index ``produced`` (the token the
             plain decode step would draw);
          2. k draft steps [n_slots, 1] from the pending token, masked for
             slots not in ``spec_on``, writes capped at ``max_loc``, each
             slot sampling with its own knobs (stream DRAFT);
          3. the verify: [pending, d_1..d_k] through the target as one
             window, writing at loc..loc+k under the same cap;
          4. the accept: d_i while U_i < min(1, p_i(d_i) / q_i(d_i)) (U
             from stream ACCEPT); then a residual max(p - q, 0), or p
             where q is 0 (the bonus after k accepts, non-speculating
             slots, capacity-forced boundaries), drawn from stream BONUS;
             greedy slots reduce to an exact argmax match;
          5. the rollback: window entries past the accepted count get
             position -1 in both pools;
          6. the draft catch-up: one masked draft step writes window
             index a where the proposal steps did not: a == k, or a == 0
             for a slot in ``draft_live`` (it holds draft pages; default
             ``spec_on``) that a full-rejection wave took out of
             ``spec_on``, so its draft pool stays aligned with the
             target's and the wave costs throughput, never accept rate
             after it.

        Returns the packed device result [n_slots, k+3]: pending, the k
        proposals, the accepted count a and the bonus token."""
        dev, k, B = self.device, self.propose_tokens, self.n_slots
        live = self._active
        any_fresh = bool(fresh.any())
        sampled = bool((self._temp[live] > 0).any())
        with_topk = sampled and bool((self._topk[live] > 0).any())
        if draft_live is None:
            draft_live = spec_on
        state = torch.from_numpy(np.stack([
            self._pending, self._pos, self._loc, self._max_loc,
            spec_on.astype(np.int64), draft_live.astype(np.int64),
            self._active.astype(np.int64), fresh.astype(np.int64),
            self._produced, self._topk, self._seeds, self._aids])).to(dev)
        (pending, pos, loc, max_loc, spec_on, draft_live, active, fresh,
         produced, topk, seeds, aids) = state
        # The draft wears each slot's adapter through the truncated stacks.
        lora, dlora = self._lora(), self._lora(draft=True)
        spec_on, draft_live = spec_on.bool(), draft_live.bool()
        active, fresh = active.bool(), fresh.bool()
        temp = torch.from_numpy(self._temp).to(dev)
        both = torch.from_numpy(np.concatenate(
            [self._tables, self._draft_tables])).to(dev)
        tables, dtables = both[:B], both[B:]
        draw = dict(sampled=sampled, with_topk=with_topk)

        # 1. the pending token of fresh slots
        if any_fresh:
            first = sample_slots(self._logbuf, temp, topk, seeds, produced,
                                 **draw)
            pending = torch.where(fresh, first, pending)
        t0 = produced + fresh.long()   # token index the window's d_1 takes

        # 2. draft propose
        tok, props, qlog = pending, [], []
        for i in range(k):
            on = active & spec_on & (loc + i <= max_loc)
            lg = self.draft_model(
                torch.where(active, tok, 0)[:, None],
                torch.where(on, pos + i, -1).int()[:, None],
                self._draft_cache, dtables,
                torch.where(on, loc + i, -1).int()[:, None], lora=dlora,
                adapter_ids=aids)[:, 0]
            tok = sample_slots(lg, temp, topk, seeds, t0 + i,
                               stream=STREAM_DRAFT, **draw)
            props.append(tok)
            if sampled:   # q enters only the sampled accept rule
                qlog.append(lg)
        D = torch.stack(props, 1)                          # [B, k]

        # 3. verify
        steps = torch.arange(k + 1, device=dev)
        win = torch.cat([pending[:, None], D], 1)          # [B, k+1]
        wloc = loc[:, None] + steps
        writable = active[:, None] & (wloc <= max_loc[:, None])
        logits = self.model(
            torch.where(active[:, None], win, 0),
            torch.where(writable, pos[:, None] + steps, -1).int(),
            self._cache, tables,
            torch.where(writable, wloc, -1).int(), lora=lora,
            adapter_ids=aids)                              # [B, k+1, V]

        # 4. accept
        within = wloc[:, 1:] <= max_loc[:, None]
        gate = spec_on[:, None] & within & active[:, None]
        if sampled:
            Pw = warp_probs(logits, temp, topk, with_topk)
            Qw = warp_probs(torch.stack(qlog, 1), temp, topk, with_topk)
            # q is zero wherever the test below is not a real draw, so a
            # forced rejection samples the plain target (q == 0).
            Qpad = torch.cat([Qw * (spec_on[:, None] & within)[..., None],
                              torch.zeros_like(Qw[:, :1])], 1)
            pd = Pw[:, :k].gather(-1, D[..., None])[..., 0]
            qd = Qpad[:, :k].gather(-1, D[..., None])[..., 0]
            U = slot_uniforms(seeds[:, None].expand(B, k).reshape(-1),
                              (t0[:, None] + steps[:k]).reshape(-1), 1,
                              STREAM_ACCEPT).view(B, k)
            acc = (U < (pd / qd.clamp_min(1e-30)).clamp(max=1.0)) & gate
        else:
            acc = (D == torch.argmax(logits[:, :k], -1)) & gate
        a = torch.cumprod(acc.long(), 1).sum(1)            # [B]
        if sampled:
            at = a[:, None, None].expand(B, 1, Pw.shape[-1])
            p_sel = Pw.gather(1, at)[:, 0]
            resid = (p_sel - Qpad.gather(1, at)[:, 0]).clamp_min(0.0)
            rsum = resid.sum(-1, keepdim=True)
            resid = torch.where(rsum > 0, resid / rsum.clamp_min(1e-30),
                                p_sel)
            u = slot_uniforms(seeds, t0 + a, resid.shape[-1], STREAM_BONUS)
            bonus = torch.argmax(torch.log(resid) - torch.log(-torch.log(u)),
                                 -1)
        else:
            bonus = torch.argmax(
                logits.gather(1, a[:, None, None].expand(
                    B, 1, logits.shape[-1]))[:, 0], -1)

        # 5. rollback: both pools, past the accept point (the draft wrote
        # window indices 0..k-1)
        past = writable & (steps > a[:, None])
        self._invalidate_window(self._cache, tables,
                                torch.where(past, wloc, -1))
        self._invalidate_window(
            self._draft_cache, dtables,
            torch.where(past & (steps < k) & spec_on[:, None], wloc, -1))

        # 6. draft catch-up at window index a when the proposal steps did
        # not write it (k accepted, or a masked-off wave's pending token)
        on = active & draft_live & ((a == k) | ~spec_on)
        self.draft_model(
            torch.where(active, win.gather(1, a[:, None])[:, 0], 0)[:, None],
            torch.where(on, pos + a, -1).int()[:, None], self._draft_cache,
            dtables, torch.where(on, loc + a, -1).int()[:, None],
            lora=dlora, adapter_ids=aids)
        return torch.cat([pending[:, None], D, a[:, None], bonus[:, None]],
                         1)

    def _emit(self, slot: int, toks: Sequence[int]) -> int:
        """Append ``toks`` to the slot's request through the stop and
        ``max_new`` contract of the decode chunk (the stop token is never
        emitted; the slot retires at the first stop or when the budget
        fills, and then releases its pages). Returns how many landed."""
        req = self._slots[slot]
        landed, done = 0, False
        for t in toks:
            if req.stop >= 0 and t == req.stop:
                done = True
                break
            req.tokens.append(int(t))
            req._notify(int(t))
            landed += 1
            if len(req.tokens) >= req.max_new:
                done = True
                break
        if landed and req.t_first == 0.0:
            req.t_first = time.monotonic()
            if self.flight is not None:
                self.flight.event(req, "first_token")
        if done:
            self._slots[slot] = None
            self._release_slot(slot)
            req._finish()
        return landed

    def _spec_once(self) -> None:
        """One speculative iteration: budget the window's pages, launch
        ``_spec_launch``, read its packed result back once, then apply the
        verdicts: emit [pending if fresh] + d_1..d_a + [bonus], advance the
        cursor by a + 1, and make the bonus the pending token. The
        ``engine.spec_verify`` chaos point turns the iteration into a
        full-rejection wave: no slot proposes, each emits the target's own
        token, so the output stays exact and the accepted count frozen."""
        inj = chaos.draw("engine.spec_verify", target=self.name)
        wave_off = inj is not None and inj.mode != "delay"
        if inj is not None and inj.delay > 0:
            time.sleep(inj.delay)
        self._ensure_spec_pages()
        if not self._active.any():
            return  # every decoding slot preempted away
        self._maybe_kv_quant_chaos()
        k = self.propose_tokens
        live = self._active.copy()
        fresh = live & (self._pending < 0)
        draft_live = live & self._spec_ok
        spec_on = np.zeros_like(draft_live) if wave_off else draft_live
        oldest = min((r for r in self._slots if r is not None),
                     key=lambda r: r.t_enqueue)
        with obs_trace.span("engine.verify", trace_id=oldest.trace_id,
                            parent_id=oldest.span_id, model=self.name,
                            slots=str(int(live.sum())), k=str(k)) as sp:
            out = self._spec_launch(fresh, spec_on, draft_live).cpu().numpy()
            pending, D = out[:, 0], out[:, 1:k + 1]
            A, bonus = out[:, k + 1], out[:, k + 2]
            sp.attrs["accepted"] = str(int(A[spec_on].sum()))
        reg = self._reg()
        # The verify window is spec mode's decode dispatch: one family
        # counts the hot decode dispatches in both modes.
        reg.counter("kfx_lm_engine_chunks_total",
                    "Decode-chunk / verify dispatches.").inc(
                        1, model=self.name)
        proposed = accepted = emitted = 0
        for slot in np.flatnonzero(live):
            if fresh[slot]:
                emitted += self._emit(slot, [int(pending[slot])])
                if self._slots[slot] is None:
                    continue  # retired on its first token
            a = int(A[slot])
            if spec_on[slot]:
                proposed += k
                accepted += a
                # Per-request attribution (spec_accept in the flight
                # recorder's breakdown).
                req = self._slots[slot]
                req.spec_prop += k
                req.spec_acc += a
            emitted += self._emit(
                slot, [int(t) for t in D[slot, :a]] + [int(bonus[slot])])
            if self._slots[slot] is not None:
                # The pending token and the a accepted proposals are now
                # in both pools; the bonus is the next pending token.
                self._pos[slot] += a + 1
                self._loc[slot] += a + 1
                self._pending[slot] = int(bonus[slot])
                self._produced[slot] = len(self._slots[slot].tokens)
        if proposed:
            self._spec_proposed += proposed
            self._spec_accepted += accepted
            with self._spec_lock:
                self._spec_window.append(
                    (time.monotonic(), proposed, accepted))
            reg.counter("kfx_lm_spec_proposed_total",
                        "Draft tokens proposed to the verify dispatch."
                        ).inc(proposed, model=self.name)
            reg.counter("kfx_lm_spec_accepted_total",
                        "Draft proposals the target model accepted."
                        ).inc(accepted, model=self.name)
        if emitted:
            reg.counter("kfx_lm_generated_tokens_total",
                        "Tokens generated since startup.").inc(
                            emitted, model=self.name)
        self._touch_gauges()

    def _fail_inflight(self, e: BaseException) -> None:
        """Fail every in-flight request and reset the pool: a dispatch that
        died midway may have written part of a step, so every page's
        position ids are invalidated and the bookkeeping starts afresh."""
        for slot, req in enumerate(self._slots):
            if req is not None:
                self._slots[slot] = None
                req._finish(e)
        self._prefilling.clear()
        if self._apool is not None:
            # Every wearer just failed; loaded adapters stay resident (the
            # stacks are written only by loads, so a dead launch cannot
            # have corrupted them).
            self._apool.release_all()
        self._aids[:] = -1
        self._active[:] = False
        self._tables[:, :] = -1
        self._slot_pages = [[] for _ in range(self.n_slots)]
        self._mgr = BlockManager(self.n_pages, self.page_size)
        if self._prefix is not None:
            self._prefix = PrefixCache(self._mgr)
        self._pending[:] = -1
        if self.spec:
            self._draft_tables[:, :] = -1
            self._draft_slot_pages = [[] for _ in range(self.n_slots)]
            self._spec_ok[:] = False
            self._draft_mgr = BlockManager(self.draft_n_pages,
                                           self.page_size)
        if not self._stopped:
            self._cache.pos.fill_(-1)
            self._logbuf.zero_()
            if self.spec:
                self._draft_cache.pos.fill_(-1)
        self._touch_gauges()

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        """Stop the loop and fail every in-flight/queued request (a racing
        submit gets an immediate error, never a timeout)."""
        with self._cond:
            if self._stopped:
                return
            self._stopped = True
            queued = self._queue.drain_all()
            self._cond.notify_all()
        self._thread.join(timeout=10.0)
        err = RuntimeError("engine closed")
        for req in queued:
            req._finish(err)
        self._fail_inflight(err)
