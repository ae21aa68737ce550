"""Many models over one card: a device weight pool with refcounted LRU
paging — port of ``kubeflow_tpu/serving/weights.py``. Scale-from-zero
becomes a measured weight SWAP, not a process spawn (ServerlessLLM-shaped;
S-LoRA's slot multiplexing generalized from LoRA factors to whole
checkpoints).

One ``LMPredictor`` process hosts several same-architecture models
time-sharing the card:

  * one slot per resident model, each holding a decode-mode
    ``TransformerLM`` on the engine's device, built by
    ``models/generate.load_decode_model`` from a versioned export
    (serving/lm_server.py ``load_lm``: v1 f32, v2 int8 and f32 quantized
    at load all admissible; every loaded tree is normalized to the POOL's
    precision and validated leaf for leaf against the resident model's
    signature, so every slot runs the same code at the same shapes);
  * the reference's host bookkeeping, line for line (free list, per-slot
    refcounts, name -> slot map, LRU order, per-load generations): a
    model pages in on first use, is pinned while requests wear it, and is
    evicted LRU when the pool wants room — eviction of an idle model's
    slot IS the scale-to-zero;
  * per-request model selection rides the engine's dispatch: a prefill
    calls its slot's module, and the decode chunk runs once per weight
    group present among the active slots (serving/engine.py
    ``_chunk_launch``). The reference passes the slot's param tree to one
    compiled function; here the slot's module is called directly (no
    ``torch.func.functional_call`` rebinding on the hot path).

A swap is ``storage.initialize`` + ``load_lm`` (disk and deserialize), the
normalization, then the copy to the device, synchronised before the clock
stops (the reference's ``block_until_ready``); ``last_swap`` keeps the
split of the latest one. Eviction drops the slot's module, so its device
bytes return to the allocator, and fires ``on_evict`` with the slot's
``name@generation`` root so the engine drops that model's prefix chains
BEFORE the slot can be refilled.

Every swap-in is measured where the activator's cold path used to be: the
``kfx_lm_weight_swap_seconds`` histogram, an ``autoscale.cold_start`` span
and a ``kfx_autoscaler_cold_start_seconds{mode="swap"}`` observation. The
``weights.load`` chaos point injects a delayed or failed artifact read
during the swap.
"""

from __future__ import annotations

import os
import tempfile
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from .. import chaos
from ..device import resolve_device
from ..models.convert import tree_signature
from ..obs import trace as obs_trace
from .engine import WeightLoadError, WeightSlotError

# Help strings shared with the operator's spawn-path observations: ONE
# family, one doc row, two `mode` label values.
COLD_START_DOC = ("Scale-from-zero latency: cold request to first "
                  "ready replica.")
SWAP_DOC = ("Weight swap-in latency: artifact load + quant "
            "normalization + device transfer into an HBM slot.")


def _tree_leaves_with_path(tree, prefix=""):
    """(path, leaf) pairs in deterministic key order (the reference's
    walk of a msgpack tree: plain nested dicts)."""
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.extend(_tree_leaves_with_path(tree[k], f"{prefix}/{k}"))
    else:
        out.append((prefix, tree))
    return out


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return np.asarray(x).dtype.name


def _signature(params: Mapping[str, Any]) -> List[tuple]:
    """(path, shape, dtype name) of every leaf in the reference's tree
    form, for a reference tree (nested dicts) or a port ``state_dict``."""
    if any(isinstance(v, Mapping) for v in params.values()):
        return [(p, tuple(np.shape(x)), _dtype_name(x))
                for p, x in _tree_leaves_with_path(params)]
    sig = tree_signature(params)
    return [("/" + "/".join(path), *sig[path]) for path in sorted(sig)]


def _module_bytes(model: torch.nn.Module) -> int:
    return sum(t.numel() * t.element_size()
               for t in model.state_dict().values())


class WeightPool:
    """Device weight slots over one engine: per-slot decode-mode modules
    plus the reference's host bookkeeping (free list, per-slot refcounts,
    name -> slot map, LRU order, per-load generations) and lazy paging
    from the artifact store (``sources``: name -> LM export URI).
    ``template`` (a reference tree or a ``state_dict``) fixes the pool's
    signature; ``device`` is "cuda" unless the caller asks for "cpu".

    All mutation happens on the engine's loop thread (the KV and adapter
    pools' single-writer discipline)."""

    def __init__(self, cfg, template, n_slots: int,
                 sources: Dict[str, str], name: str = "model",
                 registry=None,
                 on_evict: Optional[Callable[[str, bytes], None]] = None,
                 device: Union[str, torch.device] = "cuda"):
        if n_slots < 1:
            raise ValueError("weight_slots must be >= 1")
        if not sources:
            raise ValueError("model sources must be a non-empty "
                             "{name: LM export dir} map")
        self.cfg = cfg                    # pool config (fixes precision)
        self.name = name                  # engine/metrics identity
        self.n_slots = int(n_slots)
        self.sources = {str(k): str(v) for k, v in sources.items()}
        self.device = resolve_device(device)
        self._registry = registry
        self.on_evict = on_evict
        # Every pooled tree must match the resident model leaf for leaf
        # (path, shape, dtype): one forward serves every slot.
        self._sig = _signature(template)
        # -- slot state (loop thread only)
        self._models: List[Optional[torch.nn.Module]] = [None] * self.n_slots
        self._free: List[int] = list(range(self.n_slots - 1, -1, -1))
        self._by_name: Dict[str, int] = {}
        self._names: List[str] = [""] * self.n_slots
        self._gens: List[int] = [0] * self.n_slots
        self._last_used: List[float] = [0.0] * self.n_slots
        self.ref = np.zeros((self.n_slots,), np.int32)
        # Permanent residency, orthogonal to the request refcount: the
        # engine pins its adopted default model so neither LRU pressure,
        # the idle sweep nor release_all() can evict it.
        self.pinned = np.zeros((self.n_slots,), np.bool_)
        self._lru: "OrderedDict[str, int]" = OrderedDict()
        self._gen_seq = 0
        self.loads = 0
        self.evictions = 0
        # The latest swap's split (seconds and bytes), for measurement.
        self.last_swap: Dict[str, Any] = {}

    # -- metrics -------------------------------------------------------------
    def _reg(self):
        return self._registry() if callable(self._registry) else \
            self._registry

    def _count_eviction(self, reason: str) -> None:
        reg = self._reg()
        if reg is not None:
            reg.counter(
                "kfx_lm_weight_evictions_total",
                "Model weights evicted from HBM pool slots "
                "(LRU pressure, idle scale-to-zero, operator evict).",
            ).inc(1, model=self.name, reason=reason)

    def touch(self) -> None:
        """Seed and refresh every weight-pool family (the engine's
        ``_touch_gauges`` calls it): the slot gauges, zero-seeded load and
        eviction counters and swap histogram (scrapeable before the first
        swap), and the per-model residency gauges ("pooled but unloaded"
        is an explicit 0, never an absent series)."""
        reg = self._reg()
        if reg is None:
            return
        reg.gauge("kfx_lm_weight_slots",
                  "HBM weight slots (full-checkpoint capacity of the "
                  "multi-model pool).").set(self.n_slots, model=self.name)
        reg.gauge("kfx_lm_weight_slots_free",
                  "Weight slots not worn by in-flight requests (free "
                  "+ loaded-but-idle LRU candidates; pinned slots "
                  "excluded).").set(self.n_free, model=self.name)
        reg.gauge("kfx_lm_weight_models_loaded",
                  "Models resident in the HBM weight pool.").set(
                      len(self._by_name), model=self.name)
        reg.counter("kfx_lm_weight_loads_total",
                    "Model weights paged into HBM pool slots from the "
                    "artifact store.").inc(0, model=self.name)
        for reason in ("lru", "idle", "explicit"):
            reg.counter(
                "kfx_lm_weight_evictions_total",
                "Model weights evicted from HBM pool slots "
                "(LRU pressure, idle scale-to-zero, operator evict).",
            ).inc(0, model=self.name, reason=reason)
        reg.histogram("kfx_lm_weight_swap_seconds", SWAP_DOC).observe(
            0.0, n=0, model=self.name)
        reg.histogram("kfx_autoscaler_cold_start_seconds",
                      COLD_START_DOC).observe(0.0, n=0, mode="swap",
                                              model=self.name)
        for m in sorted(self.sources):
            reg.gauge(
                "kfx_lm_weight_model_loaded",
                "Per-model pool residency (1 = weights in an HBM "
                "slot, 0 = pooled but unloaded).").set(
                    1 if m in self._by_name else 0,
                    model=self.name, pooled=m)

    # -- read accessors ------------------------------------------------------
    @property
    def n_free(self) -> int:
        """Slots not holding a LIVE model reference: free-list slots plus
        loaded-but-idle (ref 0) LRU candidates. Pinned slots are never
        headroom."""
        return len(self._free) + sum(
            1 for s in self._by_name.values()
            if self.ref[s] == 0 and not self.pinned[s])

    def known(self, name: str) -> bool:
        return name in self.sources

    def loaded(self) -> List[str]:
        return sorted(self._by_name)

    def module(self, slot: int) -> Optional[torch.nn.Module]:
        """The slot's decode-mode model (dispatch calls it)."""
        return self._models[slot]

    def model_name(self, slot: int) -> str:
        return self._names[slot]

    def root(self, slot: int) -> bytes:
        """Prefix-cache chain root of the slot's CURRENT occupant:
        ``name@generation``. A reload (even of the same model into the
        same slot) gets a fresh generation, so chains built against
        evicted weights can never match again."""
        return f"{self._names[slot]}@{self._gens[slot]}".encode()

    def nbytes(self) -> int:
        """Device bytes of every resident model: the HBM cost of hosting
        the pool (``engine.hbm_bytes()["weights"]`` reads it)."""
        return sum(_module_bytes(m) for m in self._models if m is not None)

    # -- slot lifecycle ------------------------------------------------------
    def adopt(self, name: str, model: torch.nn.Module,
              pin: bool = False) -> int:
        """Install an ALREADY-LOADED model into a slot (the engine's
        resident model: no second copy, its artifact never re-read).
        ``pin=True`` marks the slot permanently resident; the request
        refcount starts at 0 either way."""
        if name in self._by_name:
            raise ValueError(f"model {name!r} already pooled")
        if not self._free:
            raise ValueError("no free weight slot to adopt into")
        slot = self._free.pop()
        self._gen_seq += 1
        self._models[slot] = model
        self._by_name[name] = slot
        self._names[slot] = name
        self._gens[slot] = self._gen_seq
        self._lru[name] = slot
        self._last_used[slot] = time.monotonic()
        self.ref[slot] = 0
        self.pinned[slot] = bool(pin)
        return slot

    def acquire(self, name: str) -> int:
        """Resolve ``name`` to a pinned slot id, paging the artifact in on
        a miss. Raises WeightSlotError (every slot pinned by an in-flight
        request: requeues like KV-page exhaustion) or WeightLoadError (the
        artifact failed to load, the ``weights.load`` chaos point
        included: 503 + Retry-After; wrong weights are never a degrade
        option)."""
        slot = self._by_name.get(name)
        if slot is not None:
            self._lru.move_to_end(name)
            self.ref[slot] += 1
            self._last_used[slot] = time.monotonic()
            return slot
        if name not in self.sources:
            raise WeightLoadError(f"unknown model {name!r}")
        if self._free:
            slot = self._free.pop()
        else:
            slot = self._evict_one()
            if slot is None:
                raise WeightSlotError(
                    f"all {self.n_slots} weight slots pinned by "
                    "in-flight requests")
        try:
            self._load_into(name, slot)
        except WeightLoadError:
            self._free.append(slot)
            raise
        self._by_name[name] = slot
        self._names[slot] = name
        self._lru[name] = slot
        self._last_used[slot] = time.monotonic()
        self.ref[slot] = 1
        return slot

    def release(self, slot: int) -> None:
        assert self.ref[slot] > 0, f"release of unpinned slot {slot}"
        self.ref[slot] -= 1
        self._last_used[slot] = time.monotonic()

    def release_all(self) -> None:
        """Drop every in-flight pin (the engine's failed-dispatch path:
        every request failed, nothing wears a slot). Loaded models stay
        resident: a dispatch only reads a slot's weights."""
        self.ref[:] = 0

    # -- eviction (scale-to-zero) --------------------------------------------
    def _drop_slot(self, name: str, slot: int, reason: str) -> None:
        root = self.root(slot)
        del self._lru[name]
        del self._by_name[name]
        self._names[slot] = ""
        self._models[slot] = None         # frees the device tensors
        self.evictions += 1
        self._count_eviction(reason)
        if self.on_evict is not None:
            # Prefix safety: the engine drops this model's prefix chains
            # BEFORE the slot can be refilled.
            self.on_evict(name, root)

    def _evict_one(self) -> Optional[int]:
        for name in list(self._lru):
            slot = self._lru[name]
            if self.ref[slot] == 0 and not self.pinned[slot]:
                self._drop_slot(name, slot, "lru")
                return slot
        return None

    def evict_model(self, name: str) -> bool:
        """Explicit eviction (the operator's scale-to-zero push or a
        drain). Refuses while worn by in-flight requests or permanently
        pinned (the engine's resident default)."""
        slot = self._by_name.get(name)
        if slot is None or self.ref[slot] > 0 or self.pinned[slot]:
            return False
        self._drop_slot(name, slot, "explicit")
        self._free.append(slot)
        return True

    def evict_idle(self, idle_s: float, keep: str = "") -> List[str]:
        """The replica-side scale-to-zero sweep: evict every ref-0 model
        idle longer than ``idle_s`` (except ``keep``, the default model).
        Returns the evicted names."""
        if idle_s <= 0:
            return []
        now = time.monotonic()
        out = []
        for name in list(self._lru):
            slot = self._lru[name]
            if name == keep or self.ref[slot] > 0 or self.pinned[slot]:
                continue
            if now - self._last_used[slot] >= idle_s:
                self._drop_slot(name, slot, "idle")
                self._free.append(slot)
                out.append(name)
        return out

    @staticmethod
    def _cache_dir() -> str:
        """Download cache for remote artifact schemes (gs/s3/http;
        file:// and bare paths never touch it): KFX_LM_STORAGE_CACHE, else
        under the system tempdir."""
        return os.environ.get("KFX_LM_STORAGE_CACHE") or os.path.join(
            tempfile.gettempdir(), "kfx-weight-cache")

    # -- the swap (cold path) ------------------------------------------------
    def _load_into(self, name: str, slot: int) -> None:
        """Page one model's export into ``slot``: artifact load, quant
        normalization to the pool precision, signature validation, the
        copy to the device. Runs on the loop thread; the whole swap is
        timed as the replica-side cold start."""
        t0 = time.perf_counter()
        ts = time.time()
        inj = chaos.draw("weights.load", target=f"{self.name}/{name}")
        if inj is not None:
            if inj.delay > 0:
                time.sleep(inj.delay)
            if inj.mode != "delay":
                raise WeightLoadError(f"chaos[weights.load]: {name}")
        from ..models.generate import load_decode_model
        from .lm_server import load_lm
        from .storage import initialize

        try:
            # Lazy, like the revision's own storageUri: a pooled model's
            # artifact is fetched at its first swap-in, not at spawn.
            path = initialize(self.sources[name], self._cache_dir())
            cfg, params = load_lm(path)
        except WeightLoadError:
            raise
        except Exception as e:
            raise WeightLoadError(
                f"model {name!r} failed to load from "
                f"{self.sources[name]}: {e}") from e
        t1 = time.perf_counter()
        try:
            params = self._normalize(name, cfg, params)
        except Exception as e:
            raise WeightLoadError(
                f"model {name!r} failed to normalize to the pool's "
                f"precision: {e}") from e
        self._validate(name, params)
        t2 = time.perf_counter()
        try:
            model = load_decode_model(self.cfg, params, self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        except Exception as e:
            raise WeightLoadError(
                f"model {name!r} failed to reach {self.device}: {e}") from e
        self._gen_seq += 1
        self._gens[slot] = self._gen_seq
        self._models[slot] = model
        self.loads += 1
        dt = time.perf_counter() - t0
        self.last_swap = {"model": name, "seconds": dt,
                          "load_s": t1 - t0, "normalize_s": t2 - t1,
                          "device_s": time.perf_counter() - t2,
                          "bytes": _module_bytes(model)}
        reg = self._reg()
        if reg is not None:
            reg.counter(
                "kfx_lm_weight_loads_total",
                "Model weights paged into HBM pool slots from the "
                "artifact store.").inc(1, model=self.name)
            reg.histogram("kfx_lm_weight_swap_seconds",
                          SWAP_DOC).observe(dt, model=self.name)
            # The fleet's own cold-start histogram: mode="swap" beside
            # the operator's mode="spawn".
            reg.histogram("kfx_autoscaler_cold_start_seconds",
                          COLD_START_DOC).observe(
                dt, mode="swap", model=self.name)
        obs_trace.record_span("autoscale.cold_start", ts=ts,
                              duration=dt, mode="swap",
                              model=self.name, pooled=name)

    def _normalize(self, name: str, cfg, params):
        """Bring a loaded export to the POOL's precision (one precision:
        every slot runs the same forward). An int8 pool quantizes f32
        exports at load (the export's per-channel scheme); an f32 pool
        expands int8 exports back to dense kernels."""
        want = self.cfg.quant or ""
        got = cfg.quant or ""
        if want == got:
            return params
        if want == "int8":
            from ..models.transformer import quantize_params_int8

            return quantize_params_int8(params)
        from ..models.transformer import dequantize_params_int8

        return dequantize_params_int8(params)

    def _validate(self, name: str, params) -> None:
        got = _signature(params)
        if len(got) != len(self._sig):
            raise WeightLoadError(
                f"model {name!r} tree has {len(got)} leaves, pool "
                f"signature has {len(self._sig)} — pooled models must "
                "share the engine's architecture")
        for (gp, gs, gd), (wp, ws, wd) in zip(got, self._sig):
            if gp != wp or gs != ws or gd != wd:
                raise WeightLoadError(
                    f"model {name!r} leaf {gp} ({gs}, {gd}) does not "
                    f"match pool signature {wp} ({ws}, {wd}) — one "
                    "compiled executable serves every slot, so pooled "
                    "models must be shape- and dtype-identical")
