"""Autograd-aware collectives over one axis of a ``RankMesh`` — the
collectives GSPMD inserts for the reference, written out.

Every function takes ``(x, mesh, axis, ...)`` and is the identity when
the axis has size 1 (world 1 runs no collective). The pairs:

  * tp (Megatron): ``copy_to`` (identity forward, all-reduce backward)
    enters a tensor-parallel region, ``reduce_from`` (all-reduce forward,
    identity backward) leaves it;
  * sp, and fsdp's params: ``gather_from`` (all-gather forward along a
    dim, reduce-scatter backward) and ``scatter_to`` (reduce-scatter
    forward, all-gather backward);
  * replicated <-> sharded for the helpers: ``split`` (own chunk forward,
    all-gather backward) and ``gather`` (all-gather forward, own chunk
    backward);
  * ``all_reduce_sum`` (all-reduce both ways: a sum of per-rank terms
    that each rank then uses, the MoE load-balance means);
  * ep: ``all_to_all`` (its own inverse backward);
  * the ring and the pipeline: ``raw_shift`` (send to the next index
    along the axis, receive from the previous) and ``send`` / ``recv``,
    raw: their callers write the backward out (ring_attention.py,
    pipeline.py).

Transport. On nccl and on CPU tensors every op goes to
``torch.distributed`` directly. gloo runs only some collectives on CUDA
tensors (two ranks that share a card cannot use nccl): the others go
through ``host_staged``, the one function that copies CUDA tensors to
host memory, runs the gloo op there and copies the result back. Which
ops that is follows from the backend and the device alone
(``GLOO_CUDA_NATIVE``, measured with ``scripts/gloo_cuda_probe.py``), is
fixed before the first op, and ``transport_line`` prints it beside the
process group. The compute never leaves the card.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

# Collectives gloo runs on CUDA tensors itself (scripts/gloo_cuda_probe.py
# on the H100's torch 2.11: all_reduce, broadcast, all_gather,
# reduce_scatter and all_to_all_single ran and agreed; send/recv and
# batch_isend_irecv aborted the process). Every other op a gloo group
# runs on CUDA tensors goes through host_staged.
GLOO_CUDA_NATIVE = frozenset({"all_reduce", "broadcast", "all_gather",
                              "reduce_scatter", "all_to_all"})
OPS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
       "send_recv")


def _size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.shape[axis]


def staged_ops(backend: str, device_type: str) -> List[str]:
    """The ops that go through ``host_staged`` on ``backend`` for tensors
    on ``device_type``."""
    if backend != "gloo" or device_type != "cuda":
        return []
    return [op for op in OPS if op not in GLOO_CUDA_NATIVE]


def transport_line(backend: str, device_type: str) -> str:
    """``transport=direct`` or ``transport=host_staged(op,...)``: printed
    on the runner's ``process_group`` line."""
    ops = staged_ops(backend, device_type)
    return ("transport=direct" if not ops
            else f"transport=host_staged({','.join(ops)})")


def _staged(op: str, t: torch.Tensor, group) -> bool:
    return t.is_cuda and op not in GLOO_CUDA_NATIVE and \
        dist.get_backend(group) == "gloo"


def host_staged(fn: Callable[..., Optional[torch.Tensor]],
                *tensors: torch.Tensor) -> Optional[torch.Tensor]:
    """Run the gloo collective ``fn`` on host copies of CUDA ``tensors``
    and return its result on their device (the transport for ops gloo
    does not run on CUDA tensors)."""
    dev = tensors[0].device
    out = fn(*(t.detach().to("cpu") for t in tensors))
    return None if out is None else out.to(dev)


def _via(op: str, fn, t: torch.Tensor, group, *more: torch.Tensor):
    if _staged(op, t, group):
        return host_staged(fn, t, *more)
    return fn(t, *more)


# -- raw ops (no autograd) ---------------------------------------------------

def raw_all_reduce(t: torch.Tensor, mesh, axis: str,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``t`` all-reduced over ``axis``."""
    if _size(mesh, axis) == 1:
        return t
    group = mesh.group(axis)

    def fn(x):
        x = x.clone()
        dist.all_reduce(x, op=op, group=group)
        return x

    return _via("all_reduce", fn, t.contiguous(), group)


def raw_all_reduce_async(t: torch.Tensor, mesh, axis: str):
    """All-reduce ``t`` over ``axis`` in place, started without waiting:
    returns the work handle to ``wait()`` on (None when the op ran to its
    end here: a trivial axis, or the host-staged transport)."""
    if _size(mesh, axis) == 1:
        return None
    group = mesh.group(axis)
    if _staged("all_reduce", t, group):
        t.copy_(raw_all_reduce(t, mesh, axis))
        return None
    return dist.all_reduce(t, group=group, async_op=True)


def all_reduce_world(t: torch.Tensor, mesh) -> torch.Tensor:
    """A new tensor: ``t`` summed over every rank of the mesh."""
    if mesh is None or mesh.world == 1:
        return t

    def fn(x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    return _via("all_reduce", fn, t.contiguous(), None)


def raw_all_gather(t: torch.Tensor, mesh, axis: str, dim: int
                   ) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in axis order."""
    n = _size(mesh, axis)
    if n == 1:
        return t
    group = mesh.group(axis)

    def fn(x):
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    return _via("all_gather", fn, t.contiguous(), group)


def raw_reduce_scatter(t: torch.Tensor, mesh, axis: str, dim: int
                       ) -> torch.Tensor:
    """This rank's chunk along ``dim`` of ``t`` summed over ``axis``."""
    n = _size(mesh, axis)
    if n == 1:
        return t
    group = mesh.group(axis)
    if t.shape[dim] % n:
        raise ValueError(f"reduce-scatter of dim {dim} ({t.shape[dim]}) "
                         f"over {n} ranks of {axis!r}")

    def fn(x):
        parts = [c.contiguous() for c in x.chunk(n, dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=group)
        return out

    return _via("reduce_scatter", fn, t.contiguous(), group)


def raw_all_to_all(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Chunk i of ``t`` (dim 0, equal chunks) goes to index i of
    ``axis``; chunk j of the result came from index j."""
    if _size(mesh, axis) == 1:
        return t
    group = mesh.group(axis)

    def fn(x):
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    return _via("all_to_all", fn, t.contiguous(), group)


def _p2p(sends: Sequence, recvs: Sequence, group) -> None:
    """Post every (tensor, peer) send and (buffer, peer) receive, then
    wait for all of them."""
    reqs = [dist.isend(t, peer, group=group) for t, peer in sends]
    reqs += [dist.irecv(b, peer, group=group) for b, peer in recvs]
    for r in reqs:
        r.wait()


def raw_shift(t: torch.Tensor, mesh, axis: str, offset: int = 1
              ) -> torch.Tensor:
    """Send ``t`` to index + offset along ``axis`` (a ring) and return
    what index - offset sent."""
    n = _size(mesh, axis)
    if n == 1 or offset % n == 0:
        return t
    group = mesh.group(axis)
    i = mesh.index(axis)
    to = mesh.peer(axis, (i + offset) % n)
    frm = mesh.peer(axis, (i - offset) % n)

    def fn(x):
        out = torch.empty_like(x)
        _p2p([(x, to)], [(out, frm)], group)
        return out

    return _via("send_recv", fn, t.contiguous(), group)


def send(t: torch.Tensor, mesh, axis: str, index: int) -> None:
    """Blocking send of ``t`` to ``index`` along ``axis``."""
    group = mesh.group(axis)
    to = mesh.peer(axis, index)

    def fn(x):
        dist.send(x, to, group=group)

    _via("send_recv", fn, t.contiguous(), group)


def recv(like: torch.Tensor, mesh, axis: str, index: int) -> torch.Tensor:
    """Blocking receive from ``index`` along ``axis`` into a new tensor
    shaped and typed like ``like``."""
    group = mesh.group(axis)
    frm = mesh.peer(axis, index)

    def fn(x):
        dist.recv(x, frm, group=group)
        return x

    return _via("send_recv", fn, torch.empty_like(like), group)


# -- autograd-aware ops ------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return raw_all_reduce(g, ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return raw_all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return raw_all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return raw_all_reduce(g, ctx.mesh, ctx.axis), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return raw_all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (raw_reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim), None,
                None, None)


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return raw_reduce_scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (raw_all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None,
                None, None)


def _own_chunk(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n = _size(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} ({x.shape[dim]}) does not split over "
                         f"{n} ranks of {axis!r}")
    return x.chunk(n, dim)[mesh.index(axis)].contiguous()


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _own_chunk(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (raw_all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None,
                None, None)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return raw_all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_chunk(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return raw_all_to_all(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return raw_all_to_all(g, ctx.mesh, ctx.axis), None, None


def _wrap(fn: Callable) -> Callable:
    def op(x: torch.Tensor, mesh, axis: str, *rest) -> torch.Tensor:
        if _size(mesh, axis) == 1:
            return x
        return fn.apply(x, mesh, axis, *rest)
    return op


copy_to = _wrap(_CopyTo)
copy_to.__doc__ = "Identity forward, all-reduce backward (Megatron's f)."
reduce_from = _wrap(_ReduceFrom)
reduce_from.__doc__ = "All-reduce forward, identity backward (Megatron's g)."
all_reduce_sum = _wrap(_AllReduceSum)
all_reduce_sum.__doc__ = "All-reduce forward and backward."
gather_from = _wrap(_GatherFrom)
gather_from.__doc__ = "All-gather along dim forward, reduce-scatter backward."
scatter_to = _wrap(_ScatterTo)
scatter_to.__doc__ = "Reduce-scatter along dim forward, all-gather backward."
split = _wrap(_Split)
split.__doc__ = "This rank's chunk along dim forward, all-gather backward."
gather = _wrap(_Gather)
gather.__doc__ = "All-gather along dim forward, this rank's chunk backward."
all_to_all = _wrap(_AllToAll)
all_to_all.__doc__ = "All-to-all over dim 0, both ways."


__all__ = ["GLOO_CUDA_NATIVE", "all_reduce_sum", "all_reduce_world",
           "all_to_all", "copy_to", "gather", "gather_from", "host_staged",
           "raw_all_gather", "raw_all_reduce", "raw_all_reduce_async",
           "raw_all_to_all", "raw_reduce_scatter", "raw_shift", "recv",
           "reduce_from", "scatter_to", "send", "split", "staged_ops",
           "transport_line"]
