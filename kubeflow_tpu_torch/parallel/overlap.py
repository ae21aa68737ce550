"""Collective/compute overlap for data-parallel LM training — port of
``kubeflow_tpu/parallel/overlap.py``.

With dp > 1 every grad that is a partial sum over "data" is all-reduced
after the backward. The reference's levers are XLA flags (the combiner's
bucket size and the async collective scheduler); the port's counterpart
is ``GradBuckets``: the grads are flattened into buckets of at most
``DEFAULT_BUCKET_BYTES`` (32 MiB, the reference's bucket) in the order the
backward produces them (last layers first), one all-reduce a bucket. With
overlap on, a bucket's all-reduce starts (async) as soon as the last of
its grads is accumulated in the backward, so the reduction of the last
layers runs while the earlier layers still compute; with it off, every
bucket is reduced after the backward. The LM runner's
``--collective-overlap`` picks (``auto``: on over nccl, where the
reduction runs beside the compute on the card; off over gloo, whose
transfers go through the host).

``measure_collective`` times a real all-reduce over "data" (the
serialized per-step cost that overlap hides); the runner records it as
the ``train.collective`` span and prints ``collective_allreduce``.
"""

from __future__ import annotations

import functools
import time
from typing import Iterable, List, Optional, Union

import torch

from . import comm

DEFAULT_BUCKET_BYTES = 32 * 1024 * 1024


def overlap_enabled(mode: str, backend: str) -> bool:
    """``--collective-overlap``: "on" / "off", or "auto" (on over nccl)."""
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"collective overlap {mode!r}: auto, on or off")
    return mode == "on" or (mode == "auto" and backend == "nccl")


class GradBuckets:
    """The data-parallel reduction of the grads of ``params`` whose
    ``kfx_partial`` names "data", in buckets of at most
    ``DEFAULT_BUCKET_BYTES`` (see the module docstring). Call
    ``finish()`` after each backward."""

    def __init__(self, params: Iterable[torch.nn.Parameter], mesh,
                 overlap: bool = False):
        self.mesh = mesh
        self.overlap = overlap
        ps = [p for p in params if "data" in getattr(p, "kfx_partial", ())]
        self.buckets: List[List[torch.nn.Parameter]] = []
        cur: List[torch.nn.Parameter] = []
        size = 0
        for p in reversed(ps):   # the backward's order: last layers first
            nb = p.numel() * p.element_size()
            if cur and size + nb > DEFAULT_BUCKET_BYTES:
                self.buckets.append(cur)
                cur, size = [], 0
            cur.append(p)
            size += nb
        if cur:
            self.buckets.append(cur)
        self._hooks = []
        if overlap:
            for i, b in enumerate(self.buckets):
                for p in b:
                    self._hooks.append(p.register_post_accumulate_grad_hook(
                        functools.partial(self._ready, i)))
        self._reset()

    def _reset(self) -> None:
        self._left = [len(b) for b in self.buckets]
        self._flight = {}

    def _ready(self, i: int, p: torch.Tensor) -> None:
        self._left[i] -= 1
        if self._left[i] == 0:
            self._launch(i)

    def _launch(self, i: int) -> None:
        flat = torch.cat([p.grad.reshape(-1) for p in self.buckets[i]])
        self._flight[i] = (flat, comm.raw_all_reduce_async(
            flat, self.mesh, "data"))

    def finish(self) -> None:
        """Reduce every bucket not started in the backward, wait for all,
        and write the sums back into the grads."""
        for i, b in enumerate(self.buckets):
            if i not in self._flight:
                for p in b:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                self._launch(i)
        for i in sorted(self._flight):
            flat, work = self._flight[i]
            if work is not None:
                work.wait()
            off = 0
            for p in self.buckets[i]:
                n = p.numel()
                p.grad.copy_(flat[off:off + n].view_as(p.grad))
                off += n
        self._reset()

    def close(self) -> None:
        for h in self._hooks:
            h.remove()
        self._hooks = []


def grad_allreduce_bytes(params: Union[int, Iterable[torch.Tensor]],
                         plan) -> int:
    """Bytes one step's gradient reduction moves per rank: the f32 grads
    of every param (``params``: the tensors, or their element count) for
    plain dp, or their 1/dp shard under fsdp."""
    n = params if isinstance(params, int) else sum(
        int(p.numel()) for p in params)
    total = n * 4
    if getattr(plan, "fsdp", False) and plan.dp > 1:
        return total // plan.dp
    return total


def measure_collective(mesh, n_bytes: int, axis: Optional[str] = None,
                       repeats: int = 3) -> float:
    """Measured seconds for one all-reduce over ``axis`` (default "data")
    of a per-rank f32 buffer of ``n_bytes`` / ways bytes (the reference's
    sizing: the global reduced payload is ``n_bytes``), on the mesh's
    device; 0.0 for a trivial axis. One warm call before timing."""
    axis = axis or "data"
    ways = mesh.shape.get(axis, 1)
    if ways <= 1:
        return 0.0
    dev = torch.device(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.ones(max(n_bytes // 4 // ways, 1), dtype=torch.float32,
                   device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    comm.raw_all_reduce(x, mesh, axis)
    sync()
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = comm.raw_all_reduce(x, mesh, axis)
    sync()
    del out
    return (time.perf_counter() - t0) / repeats


__all__ = ["DEFAULT_BUCKET_BYTES", "GradBuckets", "grad_allreduce_bytes",
           "measure_collective", "overlap_enabled"]
