"""Multi-tenant LoRA adapter serving — port of
``kubeflow_tpu/serving/adapters.py``: many cheap fine-tunes over ONE base.

A fine-tune (training/lora.py) is a set of rank-r A/B factor pairs on the
attention q/k/v/out and dense-FFN wi/wo projections, exported as a small
versioned artifact (serving/export.py ``export_adapter``). This module is
the serving half:

  * the artifact-form helpers (``extract_lora``, ``split_lora_tree``,
    ``graft_lora``, ``merge_lora_params``, ``random_lora_flat``), on
    reference-layout trees (nested dicts of arrays, the layers stacked),
    byte-compatible with the reference's;
  * ``AdapterPool``: device stacks ``[n_layers, n_slots, d_in, r]`` /
    ``[n_layers, n_slots, r, d_out]`` in f32 per target projection, and
    host bookkeeping (free list, per-slot refcounts, name -> slot map,
    LRU order) that pages artifacts in on first use, pins a slot while
    requests wear it and evicts the least recently used idle adapter when
    the pool wants room. alpha/rank is folded into B at load and a
    shorter rank zero-pads, so one stack shape serves every artifact.
    Slots are written in place, so the per-layer views the engine's
    launches take keep their storage;
  * ``FairQueue``: per-tenant admission queues popped weighted
    round-robin (the engine's own copy, re-exported under the reference's
    name).

The batched gather itself lives in the model
(``models/transformer.lora_gather_delta``); the engine (serving/engine.py)
owns the slot lifecycle, the ``engine.adapter_load`` chaos point and the
``kfx_lm_adapter_*`` metric families.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import chaos
from ..device import resolve_device
from ..models.transformer import lora_layers
from .engine import AdapterLoadError, AdapterSlotError, FairQueue  # noqa: F401,E501

# Target projections (path suffix under the layer stack) and their (d_in,
# d_out): the table both the pool stacks and the artifact validation are
# built from. The lm_head and the embedding are not targets; MoE configs
# are refused at config validation.
LORA_TARGETS = ("attn.query", "attn.key", "attn.value", "attn.out",
                "mlp.wi", "mlp.wo")


def lora_target_dims(cfg) -> Dict[str, Tuple[int, int]]:
    """target -> (d_in, d_out) for one TransformerConfig."""
    q = cfg.n_heads * cfg.head_dim
    return {
        "attn.query": (cfg.d_model, q),
        "attn.key": (cfg.d_model, q),
        "attn.value": (cfg.d_model, q),
        "attn.out": (q, cfg.d_model),
        "mlp.wi": (cfg.d_model, 2 * cfg.d_ff),
        "mlp.wo": (cfg.d_ff, cfg.d_model),
    }


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{"attn.query": leaf} -> {"attn": {"query": leaf}}: the nested form
    the model's ``lora`` argument takes."""
    out: Dict[str, Any] = {}
    for key, leaf in flat.items():
        mod, _, name = key.partition(".")
        out.setdefault(mod, {})[name] = leaf
    return out


def extract_lora(params) -> Dict[str, Dict[str, Any]]:
    """The train-time factors of a (full or LoRA-only) reference-layout
    tree: ``layers/attn/query_lora_a`` [L, d_in, r] etc. become
    ``{"attn.query": {"a": ..., "b": ...}, ...}``, the flat artifact form
    ``export_adapter`` writes and ``AdapterPool`` loads. Missing targets
    are absent."""
    layers = params.get("layers", params) if isinstance(params, dict) \
        else {}
    out: Dict[str, Dict[str, Any]] = {}
    for mod in ("attn", "mlp"):
        node = layers.get(mod)
        if not isinstance(node, dict):
            continue
        for k, v in node.items():
            for suffix, leaf in (("_lora_a", "a"), ("_lora_b", "b")):
                if k.endswith(suffix):
                    out.setdefault(f"{mod}.{k[:-len(suffix)]}", {})[
                        leaf] = v
    return out


def split_lora_tree(params) -> Tuple[Any, Any]:
    """(base, lora) split of a tree by leaf name: every ``*_lora_a`` /
    ``*_lora_b`` leaf goes to the lora side (structure kept, empty dicts
    pruned), everything else to the base."""
    def walk(node):
        if not isinstance(node, dict):
            return node, None
        base, lora = {}, {}
        for k, v in node.items():
            if not isinstance(v, dict) and (
                    k.endswith("_lora_a") or k.endswith("_lora_b")):
                lora[k] = v
                continue
            b, lo = walk(v)
            if not isinstance(v, dict) or b:
                base[k] = b
            if lo:
                lora[k] = lo
        return base, lora

    return walk(params)


def graft_lora(base, lora):
    """Deep-merge a LoRA leaf tree into a base tree (the inverse of
    ``split_lora_tree``); neither input is mutated."""
    if not isinstance(lora, dict):
        return lora
    out = dict(base) if isinstance(base, dict) else {}
    for k, v in lora.items():
        out[k] = graft_lora(out.get(k, {}), v)
    return out


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def merge_lora_params(base_params, lora_flat: Dict[str, Dict[str, Any]],
                      rank: int, alpha: float):
    """The dense merged-weights oracle: ``W' = W + (alpha/rank) A @ B`` in
    f32 for each target kernel, returned as a base-shaped reference-layout
    tree (what a one-off merged deployment would serve, and what the
    engine's batched-gather path is held to). A kernel that is a tensor is
    merged on its device and stays a tensor (a full-width base stays on
    the card); an array comes back an array. Inputs are not mutated."""
    scale = alpha / max(rank, 1)
    out = dict(base_params)
    layers = dict(out["layers"])
    for target, pair in lora_flat.items():
        mod, _, name = target.partition(".")
        node = dict(layers[mod])
        proj = dict(node[name])
        kernel = proj["kernel"]
        on_device = isinstance(kernel, torch.Tensor)
        k = kernel.float() if on_device else torch.from_numpy(_f32(kernel))
        a, b = (torch.from_numpy(_f32(pair[x])).to(k.device) for x in "ab")
        delta = torch.matmul(a, b) * scale          # [L, d_in, d_out]
        merged = (k.reshape(delta.shape) + delta).reshape(k.shape)
        proj["kernel"] = merged if on_device else merged.numpy()
        node[name] = proj
        layers[mod] = node
    out["layers"] = layers
    return out


def random_lora_flat(cfg, rank: int, seed: int = 0,
                     std: float = 0.02) -> Dict[str, Dict[str, Any]]:
    """A synthetic full-target adapter, both factors random normal (a
    fresh fine-tune's B is zero and would change nothing): the same numpy
    draws as the reference's, so the same seed gives the same bytes."""
    rng = np.random.default_rng(seed)
    L = cfg.n_layers
    out = {}
    for target, (d_in, d_out) in lora_target_dims(cfg).items():
        out[target] = {
            "a": rng.normal(0.0, std, (L, d_in, rank)).astype(np.float32),
            "b": rng.normal(0.0, std, (L, rank, d_out)).astype(np.float32),
        }
    return out


class AdapterPool:
    """Device-resident adapter slots over one base: per-target stacked A/B
    tensors (``tree``, leaves ``[n_layers, n_slots, ...]``, and its
    per-layer views ``layers``, the model's ``lora`` argument) plus host
    bookkeeping, paging artifacts in lazily from ``sources`` (name ->
    artifact URI). A speculating engine also gets ``draft_tree`` /
    ``draft_layers_views``: the same adapters truncated to the draft's
    depth, written at load time. ``device`` is "cuda" unless the caller
    asks for "cpu".

    All mutation happens on the engine's loop thread."""

    def __init__(self, cfg, n_slots: int, sources: Dict[str, str],
                 rank: int = 0, draft_layers: int = 0,
                 name: str = "model", registry=None,
                 device: Union[str, torch.device] = "cuda"):
        if n_slots < 1:
            raise ValueError("adapter_slots must be >= 1")
        if not sources:
            raise ValueError("adapter sources must be a non-empty "
                             "{name: artifact URI} map")
        self.cfg = cfg
        self.name = name
        self.n_slots = int(n_slots)
        self.sources = {str(k): str(v) for k, v in sources.items()}
        self._registry = registry
        device = resolve_device(device)   # "cuda" without a GPU raises
        if rank <= 0:
            # Auto-rank: the largest rank the artifacts declare (a config
            # peek each, so a bad URI fails at startup, not at the first
            # request that needs it).
            from .export import peek_adapter_rank

            rank = max(peek_adapter_rank(uri)
                       for uri in self.sources.values())
        self.rank = int(rank)
        self.draft_layers = int(draft_layers)
        L = cfg.n_layers

        def stacks(depth):
            return _nest({
                t: {"a": torch.zeros(depth, self.n_slots, d_in, self.rank,
                                     dtype=torch.float32, device=device),
                    "b": torch.zeros(depth, self.n_slots, self.rank, d_out,
                                     dtype=torch.float32, device=device)}
                for t, (d_in, d_out) in lora_target_dims(cfg).items()})

        self.tree = stacks(L)
        self.draft_tree = stacks(self.draft_layers) if self.draft_layers \
            else {}
        self.layers = lora_layers(self.tree, L)
        self.draft_layers_views = lora_layers(self.draft_tree,
                                              self.draft_layers)
        # -- host bookkeeping (loop thread only)
        self._free: List[int] = list(range(self.n_slots - 1, -1, -1))
        self._by_name: Dict[str, int] = {}
        self._names: List[str] = [""] * self.n_slots
        self.ref = np.zeros((self.n_slots,), np.int32)
        self._lru: "OrderedDict[str, int]" = OrderedDict()
        self.loads = 0
        self.evictions = 0

    # -- metrics -------------------------------------------------------------
    def _count(self, family: str, doc: str) -> None:
        reg = self._registry() if callable(self._registry) else \
            self._registry
        if reg is not None:
            reg.counter(family, doc).inc(1, model=self.name)

    @property
    def n_free(self) -> int:
        """Slots not holding a live reference: free-list slots plus
        loaded-but-idle (ref 0) LRU candidates."""
        return len(self._free) + sum(
            1 for s in self._by_name.values() if self.ref[s] == 0)

    def known(self, name: str) -> bool:
        return name in self.sources

    def loaded(self) -> List[str]:
        return sorted(self._by_name)

    # -- slot lifecycle ------------------------------------------------------
    def acquire(self, name: str) -> int:
        """Resolve ``name`` to a pinned slot id, paging the artifact in on
        a miss. Raises AdapterSlotError (every slot pinned by in-flight
        requests: pool pressure) or AdapterLoadError (the artifact failed
        to load, or the ``engine.adapter_load`` chaos point)."""
        slot = self._by_name.get(name)
        if slot is not None:
            self._lru.move_to_end(name)
            self.ref[slot] += 1
            return slot
        if name not in self.sources:
            raise AdapterLoadError(f"unknown adapter {name!r}")
        if self._free:
            slot = self._free.pop()
        else:
            slot = self._evict_one()
            if slot is None:
                raise AdapterSlotError(
                    f"all {self.n_slots} adapter slots pinned by "
                    "in-flight requests")
        try:
            self._load_into(name, slot)
        except AdapterLoadError:
            self._free.append(slot)
            raise
        self._by_name[name] = slot
        self._names[slot] = name
        self._lru[name] = slot
        self.ref[slot] = 1
        return slot

    def release(self, slot: int) -> None:
        assert self.ref[slot] > 0, f"release of unpinned slot {slot}"
        self.ref[slot] -= 1

    def release_all(self) -> None:
        """Drop every in-flight pin (the engine's failed-dispatch path:
        every request failed). Loaded adapters stay resident: the stacks
        are only ever written by ``_load_into``."""
        self.ref[:] = 0

    def _evict_one(self) -> Optional[int]:
        for name in list(self._lru):
            slot = self._lru[name]
            if self.ref[slot] == 0:
                del self._lru[name]
                del self._by_name[name]
                self._names[slot] = ""
                self.evictions += 1
                self._count(
                    "kfx_lm_adapter_evictions_total",
                    "Adapters evicted from HBM slots (LRU paging).")
                return slot
        return None

    def _load_into(self, name: str, slot: int) -> None:
        """Page one artifact into ``slot``: load and validate the flat A/B
        tree, fold alpha/rank into B, zero-pad the rank, and copy into the
        device stacks (and the truncated draft stacks) in place. Runs on
        the loop thread; bounded by the artifact's size."""
        inj = chaos.draw("engine.adapter_load",
                         target=f"{self.name}/{name}")
        if inj is not None:
            if inj.delay > 0:
                time.sleep(inj.delay)
            if inj.mode != "delay":
                raise AdapterLoadError(
                    f"chaos[engine.adapter_load]: {name}")
        from .export import load_adapter

        try:
            meta, flat = load_adapter(self.sources[name])
        except AdapterLoadError:
            raise
        except Exception as e:
            raise AdapterLoadError(
                f"adapter {name!r} failed to load from "
                f"{self.sources[name]}: {e}") from e
        rank = int(meta.get("rank", 0))
        alpha = float(meta.get("alpha", rank))
        if rank < 1 or rank > self.rank:
            raise AdapterLoadError(
                f"adapter {name!r} rank {rank} not in [1, {self.rank}] "
                "(the pool's stack rank — set adapters.rank or "
                "re-export)")
        dims = lora_target_dims(self.cfg)
        scale = np.float32(alpha / rank)
        L = self.cfg.n_layers
        staged = {}
        for target, pair in flat.items():
            if target not in dims:
                raise AdapterLoadError(
                    f"adapter {name!r} carries unknown target "
                    f"{target!r}")
            d_in, d_out = dims[target]
            a = np.asarray(pair["a"], np.float32)
            b = np.asarray(pair["b"], np.float32) * scale
            if a.shape != (L, d_in, rank) or b.shape != (L, rank, d_out):
                raise AdapterLoadError(
                    f"adapter {name!r} target {target} shapes "
                    f"{a.shape}/{b.shape} do not fit base "
                    f"({L}, {d_in}, r)/{(L, rank, d_out)}")
            pad = self.rank - rank
            staged[target] = (np.pad(a, ((0, 0), (0, 0), (0, pad))),
                              np.pad(b, ((0, 0), (0, pad), (0, 0))))
        # Every target is validated before any stack is written, so a
        # rejected artifact leaves the slot's previous bytes alone; a
        # target the artifact omits is zeroed (no stale factors).
        for target in dims:
            mod, _, leaf = target.partition(".")
            a, b = staged.get(target, (None, None))
            for tree, depth in ((self.tree, L),
                                (self.draft_tree, self.draft_layers)):
                if not tree:
                    continue
                entry = tree[mod][leaf]
                for key, host in (("a", a), ("b", b)):
                    dst = entry[key][:, slot]
                    if host is None:
                        dst.zero_()
                    else:
                        dst.copy_(torch.from_numpy(
                            np.ascontiguousarray(host[:depth])))
        self.loads += 1
        self._count("kfx_lm_adapter_loads_total",
                    "Adapters paged into HBM slots from the artifact "
                    "store.")

    def nbytes(self) -> int:
        """Device bytes of the adapter stacks (target and draft)."""
        def walk(node):
            if isinstance(node, dict):
                return sum(walk(v) for v in node.values())
            return node.numel() * node.element_size()

        return walk(self.tree) + walk(self.draft_tree)
