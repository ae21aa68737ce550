"""Parallelism library — port of ``kubeflow_tpu/parallel``: the named mesh
over torch.distributed ranks and its sharding rules (``mesh``), the
autograd-aware collectives the reference leaves to GSPMD (``comm``),
ring attention (``ring_attention``), the GPipe pipeline (``pipeline``),
bucketed data-parallel grad reduction (``overlap``), the LM train loop on
one device or a mesh (``lm_train``) and the cross-process check
(``spmd_check``). One process a device:

  axis "data"   — batch (dp); parameters optionally cut here too (fsdp)
                  and MoE experts ride it (ep)
  axis "ctx"    — context parallelism (cp): the sequence, ring attention
  axis "model"  — tensor parallelism (tp); sequence parallelism (sp) cuts
                  the residual stream's sequence dim on this axis
  axis "stage"  — pipeline parallelism (pp), point-to-point between stages
"""

from .mesh import (  # noqa: F401
    AXIS_CTX,
    AXIS_DATA,
    AXIS_MODEL,
    AXIS_STAGE,
    MeshPlan,
    logical_sharding,
    make_mesh,
    param_sharding_rules,
)
