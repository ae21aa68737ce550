"""Device mesh and parameter sharding rules — port of
``kubeflow_tpu/parallel/mesh.py`` over ``torch.distributed`` ranks.

One process a device. The ranks form the reference's named mesh
("stage", "data", "ctx", "model") = (pp, dp, cp, tp), tp innermost (the
most chatty axis: per-layer all-reduces), then cp, dp, and pp outermost;
``make_mesh`` builds it with ``init_device_mesh`` and hands back this
rank's view (``RankMesh``: its coordinate and the process group of each
axis) with the ``MeshPlan``. At world 1 (no process group) every axis has
size 1 and no group.

The rules are the reference's, as pure functions: logical axis names on
every param (``models/transformer.py`` ``param_logical_axes``), a table
from logical names to mesh axes (``param_sharding_rules``), and
``logical_sharding``, which says which dimension of a param is cut on
which mesh axis, with the reference's collision rule (the leftmost
dimension keeps an axis) and divisibility rule (an axis that does not
divide its dimension is dropped). GSPMD reads those specs and inserts
the collectives; the port inserts them by hand (``parallel/comm.py``,
``models/transformer.py``), from the same specs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

AXIS_STAGE = "stage"   # pipeline (pp)
AXIS_DATA = "data"     # batch (dp) + fsdp param shards + experts (ep)
AXIS_CTX = "ctx"       # context parallelism (cp): sequence via ring attention
AXIS_MODEL = "model"   # tensor (tp) + sequence (sp) activation shards
AXES = (AXIS_STAGE, AXIS_DATA, AXIS_CTX, AXIS_MODEL)


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A parallelism plan: how many ways along each mesh axis.

    fsdp is not a mesh axis: it reuses "data" (params sharded over the
    data-parallel group, all-gathered before use). Experts (ep) ride
    "data" too, and sequence parallelism (sp) reuses "model" for
    activation shards. Context parallelism (cp) has its own axis."""

    pp: int = 1
    dp: int = 1
    cp: int = 1
    tp: int = 1
    fsdp: bool = False

    @property
    def n_devices(self) -> int:
        return self.pp * self.dp * self.cp * self.tp

    def axis_sizes(self) -> Dict[str, int]:
        return {AXIS_STAGE: self.pp, AXIS_DATA: self.dp,
                AXIS_CTX: self.cp, AXIS_MODEL: self.tp}


def _factor(n: int, want_tp: Optional[int], want_pp: Optional[int],
            want_cp: Optional[int]) -> Tuple[int, int, int, int]:
    """Choose (pp, dp, cp, tp) for n devices; dp absorbs the rest."""
    pp = want_pp or 1
    if n % pp:
        raise ValueError(f"pp={pp} does not divide device count {n}")
    rest = n // pp
    cp = want_cp or 1
    if rest % cp:
        raise ValueError(f"cp={cp} does not divide {rest} (n={n}, pp={pp})")
    rest //= cp
    tp = want_tp or 1
    if rest % tp:
        raise ValueError(
            f"tp={tp} does not divide {rest} (n={n}, pp={pp}, cp={cp})")
    return pp, rest // tp, cp, tp


class RankMesh:
    """This rank's view of the mesh: ``shape`` (axis -> size, as a JAX
    mesh's), ``coords`` (axis -> this rank's index), and ``group(axis)``,
    the process group of the ranks that differ from this one only along
    ``axis`` (None for an axis of size 1). ``device_mesh`` is the
    ``torch.distributed`` DeviceMesh (None at world 1)."""

    def __init__(self, plan: MeshPlan, device_type: str = "cpu",
                 device_mesh: Any = None):
        self.plan = plan
        self.device_type = device_type
        self.device_mesh = device_mesh
        self.shape: Dict[str, int] = plan.axis_sizes()
        self._groups: Dict[str, Any] = {}
        if device_mesh is None:
            self.rank, self.world = 0, 1
            self.coords = {a: 0 for a in AXES}
        else:
            import torch.distributed as dist

            self.rank, self.world = dist.get_rank(), dist.get_world_size()
            self.coords = dict(zip(AXES, device_mesh.get_coordinate()))
            for a in AXES:
                if self.shape[a] > 1:
                    self._groups[a] = device_mesh.get_group(a)

    def group(self, axis: str):
        return self._groups.get(axis)

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def peer(self, axis: str, index: int) -> int:
        """Global rank of the rank at ``index`` along ``axis`` with this
        rank's other coordinates (rank order is the row-major order of
        (stage, data, ctx, model), as in ``init_device_mesh``)."""
        c = dict(self.coords, **{axis: index})
        r = 0
        for a in AXES:
            r = r * self.shape[a] + c[a]
        return r

    def __repr__(self) -> str:
        return (f"RankMesh(rank={self.rank}, shape={self.shape}, "
                f"coords={self.coords})")


def make_mesh(n_devices: Optional[int] = None, *, tp: Optional[int] = None,
              pp: Optional[int] = None, cp: Optional[int] = None,
              fsdp: bool = False, device_type: str = "cpu"
              ) -> Tuple[RankMesh, MeshPlan]:
    """Build the ("stage", "data", "ctx", "model") mesh over the ranks of
    the torch.distributed group (one rank at world 1, when no group is
    initialized); ``n_devices`` defaults to the world size and must equal
    it. Factorisation errors are the reference's."""
    from ..runtime.rendezvous import rank_world

    _, world = rank_world()
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(
            f"requested a {n}-device mesh but only {world} rank(s) are in "
            "the torch.distributed group; start one process per device "
            "(KFX_NUM_PROCESSES, KFX_PROCESS_ID, KFX_COORDINATOR_ADDRESS)")
    pp_, dp_, cp_, tp_ = _factor(n, tp, pp, cp)
    plan = MeshPlan(pp=pp_, dp=dp_, cp=cp_, tp=tp_, fsdp=fsdp)
    if world == 1:
        return RankMesh(plan, device_type), plan
    if n != world:
        raise ValueError(f"a {n}-device mesh over {world} ranks: the mesh "
                         "spans every rank of the group")
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device_type, (pp_, dp_, cp_, tp_),
                          mesh_dim_names=AXES)
    return RankMesh(plan, device_type, dm), plan


# ---------------------------------------------------------------------------
# Logical-axis -> mesh-axis rules (Megatron-style layout)
# ---------------------------------------------------------------------------

def param_sharding_rules(plan: MeshPlan) -> Dict[Optional[str],
                                                 Optional[str]]:
    """Mapping of the model's logical axis names to mesh axes (the
    reference's table): vocab, mlp, heads and expert_mlp on "model";
    embed on "data" under fsdp; expert on "data" (ep)."""
    return {
        "vocab": AXIS_MODEL,
        "embed": AXIS_DATA if plan.fsdp else None,
        "mlp": AXIS_MODEL,
        "heads": AXIS_MODEL,
        "kv": None,
        "expert": AXIS_DATA,
        "expert_mlp": AXIS_MODEL,
        "layers": None,
        None: None,
    }


def _sizes(mesh) -> Mapping[str, int]:
    """Axis sizes of a RankMesh, a JAX-like mesh (``.shape``), or a plain
    mapping."""
    return getattr(mesh, "shape", mesh)


def logical_sharding(mesh, logical_axes: Tuple[Optional[str], ...],
                     rules: Mapping, shape: Optional[Tuple[int, ...]] = None
                     ) -> Tuple[Optional[str], ...]:
    """The mesh axis each dimension of a param is cut on (None = whole),
    the counterpart of the reference's PartitionSpec. A mesh axis cuts
    at most one dimension: on collision the leftmost keeps it. With a
    ``shape``, an axis that does not divide its dimension is dropped."""
    assigned: List[Optional[str]] = []
    seen = set()
    sizes = _sizes(mesh)
    for i, a in enumerate(logical_axes):
        m = rules.get(a)
        if m is not None and m in seen:
            m = None
        if m is not None and shape is not None and shape[i] % sizes[m]:
            m = None
        if m is not None:
            seen.add(m)
        assigned.append(m)
    return tuple(assigned)


def tree_shardings(mesh, params_axes: Mapping[str, tuple], rules: Mapping,
                   shapes: Optional[Mapping[str, Tuple[int, ...]]] = None
                   ) -> Dict[str, Tuple[Optional[str], ...]]:
    """``logical_sharding`` for every param of a flat {name: axes} map
    (``param_logical_axes``); with ``shapes`` ({name: shape}),
    divisibility is checked per dimension."""
    return {name: logical_sharding(
        mesh, axes, rules, None if shapes is None else tuple(shapes[name]))
        for name, axes in params_axes.items()}


__all__ = ["AXES", "AXIS_CTX", "AXIS_DATA", "AXIS_MODEL", "AXIS_STAGE",
           "MeshPlan", "RankMesh", "logical_sharding", "make_mesh",
           "param_sharding_rules", "tree_shardings"]
