"""Pipeline parallelism — port of ``kubeflow_tpu/parallel/pipeline.py``:
GPipe-style microbatched training over the "stage" mesh axis.

Each stage holds n_layers/pp of the layers (dp/tp/fsdp/ep inside a stage
work as in the pp=1 loop, over the stage's own groups); embed, ln_f and
lm_head are on every stage, used by the first and the last, and their
grads are summed over "stage". The batch (this rank's rows) is cut into
``n_microbatches`` (default 2*pp) microbatches, and the forward runs
M + pp - 1 ticks: at tick t stage s runs microbatch t - s, receiving its
activation from stage s - 1 and sending its output to stage s + 1. The
backward runs the microbatches in reverse, each stage receiving the grad
of its output from s + 1 and sending the grad of its input to s - 1
(GPipe; bubble fraction (pp-1)/(M+pp-1)). The loss is the mean over the
microbatches of their mean CE, and with experts the aux term the
reference's (the layers' aux summed over stages and microbatches, over
n_layers * M). With dp > 1, microbatch j is every data rank's j-th slice
of its rows (the reference's is the j-th block of the global batch): the
same CE, and with experts a per-microbatch aux mean over other tokens.

The param tree stays the pp=1 loop's (``state_tree`` gathers the layers
of every stage in order), so checkpoints interchange between the two.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ..models.transformer import TransformerLM, full_from_shards
from . import comm
from .lm_train import LMHyperParams, LMTrainLoop
from .mesh import MeshPlan


class PipelinedLMTrainLoop(LMTrainLoop):
    """LMTrainLoop with the loss evaluated through the stage pipeline."""

    _pipelined = True

    def __init__(self, cfg, hp: Optional[LMHyperParams] = None,
                 device="cuda", mesh=None, plan: Optional[MeshPlan] = None,
                 n_microbatches: Optional[int] = None):
        plan = plan or (mesh.plan if mesh is not None else MeshPlan())
        if plan.pp <= 1:
            raise ValueError("PipelinedLMTrainLoop requires plan.pp > 1")
        if cfg.n_layers % plan.pp:
            raise ValueError(
                f"n_layers={cfg.n_layers} not divisible by pp={plan.pp}")
        if cfg.sp:
            raise NotImplementedError("sp inside the pipelined loop is not "
                                      "supported yet; use sp with pp=1")
        if cfg.cp > 1 or plan.cp > 1:
            raise ValueError(f"cfg.cp={cfg.cp} must match the mesh plan's "
                             "cp=1 (the pipelined loop runs dp/tp/fsdp/ep "
                             "inside a stage)")
        if mesh is None or mesh.world == 1:
            raise ValueError("PipelinedLMTrainLoop runs one stage a rank: "
                             "it needs a mesh of pp or more ranks")
        super().__init__(cfg, hp, device, mesh, plan)
        self.n_micro = n_microbatches or 2 * plan.pp
        self._local_layers = cfg.n_layers // plan.pp

    # -- state --------------------------------------------------------------
    def _place(self, model: TransformerLM) -> TransformerLM:
        s, n = self.mesh.index("stage"), self._local_layers
        model.layers = nn.ModuleList(list(model.layers)[s * n:(s + 1) * n])
        model.shard(self.mesh, self.plan)
        for name, p in model.named_parameters():
            if name.startswith("layers."):
                p.kfx_stage = True       # cut over "stage"
            else:
                p.kfx_partial = p.kfx_partial + ("stage",)
        return model

    def _global_names(self) -> List[str]:
        names = [n for n, _ in self.model.named_parameters()]
        per_layer = [n.split(".", 2)[2] for n in names
                     if n.startswith("layers.0.")]
        pre = [n for n in names if n.startswith("embed.")]
        post = [n for n in names
                if not n.startswith(("embed.", "layers."))]
        return pre + [f"layers.{i}.{suf}" for i in range(self.cfg.n_layers)
                      for suf in per_layer] + post

    def _global_name(self, name: str) -> str:
        if not name.startswith("layers."):
            return name
        _, j, rest = name.split(".", 2)
        i = self.mesh.index("stage") * self._local_layers + int(j)
        return f"layers.{i}.{rest}"

    def _full_tensors(self, name, p, tensors):
        full = [full_from_shards(name, t, p.kfx_spec, self.mesh)
                for t in tensors]
        if not name.startswith("layers."):
            return {name: full}
        _, j, rest = name.split(".", 2)
        stacked = [comm.raw_all_gather(t.unsqueeze(0), self.mesh, "stage", 0)
                   for t in full]
        return {f"layers.{s * self._local_layers + int(j)}.{rest}":
                [x[s] for x in stacked] for s in range(self.plan.pp)}

    # -- the pipeline -------------------------------------------------------
    def _pipeline(self, tokens: torch.Tensor, backward: bool):
        """Run this stage's part of the GPipe schedule on this rank's
        rows; with ``backward`` also the reversed backward. Returns the
        global (loss, accuracy)."""
        cfg, mesh, model = self.cfg, self.mesh, self.model
        s, pp = mesh.index("stage"), self.plan.pp
        last = pp - 1
        M = self.n_micro
        B = tokens.shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by microbatches {M}")
        mb, S = B // M, tokens.shape[1] - 1
        n_tokens = B * self.plan.dp * S
        positions = torch.arange(S, device=tokens.device,
                                 dtype=torch.int32).expand(mb, S)
        like = torch.empty(mb, S, cfg.d_model, dtype=cfg.dtype,
                           device=tokens.device)
        remat = cfg.remat and torch.is_grad_enabled()
        aux_w = self.hp.moe_aux_weight * self._aux_scale() / (
            max(cfg.n_layers, 1) * M)
        zero = torch.zeros((), dtype=torch.float32, device=tokens.device)
        ce_tot, hits_tot, aux_tot = zero, zero, zero
        saved = []
        for t in range(M + pp - 1):     # the forward ticks
            j = t - s
            if not 0 <= j < M:
                continue
            rows = tokens[j * mb:(j + 1) * mb]
            if s == 0:
                x = model.embed(rows[:, :-1])
            else:
                x = comm.recv(like, mesh, "stage", s - 1)
                if backward:
                    x.requires_grad_()
            y, aux = x, []
            for layer in model.layers:
                y, a = model.run_layer(layer, y, positions, remat)
                if a is not None:
                    aux.append(a)
            objs = []
            if s == last:
                h = model.ln_f(y)
                h = model.par.enter(h)
                out = h if cfg.loss_chunk > 0 else \
                    model.lm_head(h).to(torch.float32)
                ce, hits = self._head_sums(out, rows[:, 1:])
                ce_tot = ce_tot + ce.detach()
                hits_tot = hits_tot + hits.detach()
                objs.append(ce / n_tokens)
            else:
                comm.send(y.detach(), mesh, "stage", s + 1)
            if aux:
                a = torch.stack(aux).sum()
                aux_tot = aux_tot + a.detach()
                objs.append(a * aux_w)
            saved.append((x, y, objs))
        if backward:
            for j in reversed(range(M)):  # the backward, reversed
                x, y, objs = saved[j]
                outs = list(objs)
                grads: List[Optional[torch.Tensor]] = [None] * len(objs)
                if s != last:
                    outs.append(y)
                    grads.append(comm.recv(like, mesh, "stage", s + 1))
                torch.autograd.backward(outs, grads)
                if s > 0:
                    comm.send(x.grad, mesh, "stage", s - 1)
        both = torch.stack([ce_tot, hits_tot])
        for ax in ("data", "stage"):
            both = comm.raw_all_reduce(both, mesh, ax)
        loss = both[0] / n_tokens
        if cfg.n_experts:
            aux = comm.raw_all_reduce(aux_tot, mesh, "stage")
            loss = loss + self.hp.moe_aux_weight * aux / (
                max(cfg.n_layers, 1) * M)
        return loss, both[1] / n_tokens

    def _train_one(self, tokens: torch.Tensor):
        loss, acc = self._pipeline(tokens, backward=True)
        self._sync_grads()
        self.opt.step()
        self.model.zero_grad(set_to_none=True)
        return loss, acc

    def _eval_loss(self, tokens: torch.Tensor):
        return self._pipeline(tokens, backward=False)


__all__ = ["PipelinedLMTrainLoop"]
