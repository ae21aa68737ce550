"""LM training on one device or across ranks — port of
``kubeflow_tpu/parallel/lm_train.py``.

Same optimizer and schedule as the reference's optax chain, in PyTorch:
``clip_by_global_norm(grad_clip)`` then AdamW (b1=0.9, b2=0.95, eps=1e-8,
decoupled weight decay on every param, norm scales included — optax's
default mask), learning rate ``warmup_cosine_decay_schedule(0, lr,
warmup, max(total, warmup + 1))`` with end value 0. optax evaluates the
schedule at the count *before* the update, so the first update uses
``lr = schedule(0) = 0``; ``AdamW`` keeps that convention.

The loss is the reference's: f32 cross-entropy over the whole logits,
or per ``cfg.loss_chunk``-token chunk (``_chunked_ce``, each chunk body
checkpointed, so the [B, S, vocab] f32 logits never exist whole), plus
``moe_aux_weight`` times the mean of the MoE layers' Switch aux losses.
``cfg.remat`` rematerialises each layer (models/transformer.py).

The port updates params and optimizer state in place (the reference
returns a new state pytree).

Across ranks (``mesh``, ``plan`` from ``parallel/mesh.py``; one process a
device) the loop trains the same losses as at world 1:
  * init is plan-invariant: every rank draws the full params from
    ``hp.seed`` exactly as world 1 does, then keeps its shard
    (``TransformerLM.shard``);
  * ``train_step`` takes this rank's rows of the global [B, S+1] batch
    (the slice of its "data" coordinate: ``local_rows``); under cp the
    [B, S] inputs and targets are cut onto "ctx" in the loss;
  * each rank's objective is its share of the global mean (its tokens'
    CE over the global token count); after the backward the grads that
    are partial sums are all-reduced over the axes their params name
    (``kfx_partial``; "data" in buckets, ``parallel/overlap.py``);
  * under tp the loss is vocab-parallel: the row max, the sum of
    exponentials, the target logit and the argmax are reduced across
    "model";
  * the MoE aux loss is the reference's global one (its means over the
    global batch); each rank adds 1/(dp*cp*tp) of it, so that the sums
    over the partial axes give it once;
  * ``clip_by_global_norm`` uses the norm of the global gradient: each
    param's sum of squares over the ranks that cut it, a replicated param
    counted once;
  * the reported loss and accuracy are the global means;
  * ``state_tree`` gathers the full tree (the world-1 tree: a checkpoint
    from any plan loads at world 1, and its params in the JAX package),
    ``load_state_tree`` takes a full tree and keeps this rank's shard;
  * MFU divides by the distinct cards the ranks use.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from ..device import resolve_device
from ..models.transformer import (TransformerConfig, TransformerLM,
                                  full_from_shards, local_shard)
from ..obs.metrics import default_registry
from . import comm
from .mesh import MeshPlan
from .overlap import GradBuckets


@dataclasses.dataclass
class LMHyperParams:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moe_aux_weight: float = 0.01
    seed: int = 0


def warmup_cosine_lr(count: int, peak: float, warmup_steps: int,
                     decay_steps: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup_steps,
    decay_steps, end_value=0) at ``count``: linear 0 -> peak over the
    warmup, then cosine to 0 at ``decay_steps``."""
    if count < warmup_steps:
        return peak * min(max(count, 0), warmup_steps) / warmup_steps
    t = min(float(count - warmup_steps), float(decay_steps - warmup_steps))
    return peak * 0.5 * (1.0 + math.cos(
        math.pi * t / (decay_steps - warmup_steps)))


class AdamW:
    """optax ``chain(clip_by_global_norm(clip), adamw(schedule, b1, b2,
    eps, weight_decay))`` over a list of f32 params, updated in place."""

    def __init__(self, params: Iterable[torch.Tensor], hp: LMHyperParams,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 norm_fn=None):
        self.params: List[torch.Tensor] = list(params)
        self.hp = hp
        # The gradient's global norm from the list of grads (across ranks
        # for a sharded loop); default: the norm of these grads.
        self.norm_fn = norm_fn
        self.b1, self.b2, self.eps = b1, b2, eps
        self.decay_steps = max(hp.total_steps, hp.warmup_steps + 1)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def lr(self, count: int) -> float:
        return warmup_cosine_lr(count, self.hp.learning_rate,
                                self.hp.warmup_steps, self.decay_steps)

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad for p in self.params]
        # clip_by_global_norm: g * clip / ||g|| where ||g|| >= clip.
        if self.norm_fn is not None:
            g_norm = self.norm_fn(grads)
        else:
            g_norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
        clip = self.hp.grad_clip
        scale = torch.where(g_norm < clip, torch.ones_like(g_norm),
                            clip / g_norm)
        torch._foreach_mul_(grads, scale)
        # scale_by_adam with bias correction at the incremented count.
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
        t = self.count + 1
        denom = torch._foreach_div(self.nu, 1 - b2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.mu, 1 - b1 ** t)
        torch._foreach_div_(upd, denom)
        # add_decayed_weights, then scale_by_learning_rate at the
        # pre-increment count.
        torch._foreach_add_(upd, self.params, alpha=self.hp.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-self.lr(self.count))
        self.count = t


class LMTrainLoop:
    """Owns the model, the optimizer and the step on one device, or this
    rank's part of them on a mesh (see the module docstring)."""

    # PipelinedLMTrainLoop runs plans with pp > 1.
    _pipelined = False

    def __init__(self, cfg: TransformerConfig,
                 hp: Optional[LMHyperParams] = None,
                 device: Union[str, torch.device] = "cuda",
                 mesh=None, plan: Optional[MeshPlan] = None,
                 overlap: bool = False):
        plan = plan or (mesh.plan if mesh is not None else MeshPlan())
        if plan.pp > 1 and not self._pipelined:
            raise NotImplementedError(
                "pp>1 runs through parallel.pipeline.PipelinedLMTrainLoop")
        if cfg.cp != plan.cp and (cfg.cp > 1 or plan.cp > 1):
            raise ValueError(
                f"cfg.cp={cfg.cp} must match the mesh plan's cp={plan.cp}")
        if cfg.cp > 1 and cfg.sp:
            raise ValueError("sp and cp both shard the sequence dim; "
                             "enable at most one")
        self.cfg = cfg
        self.hp = hp or LMHyperParams()
        self.device = resolve_device(device)
        self.plan = plan
        self.mesh = mesh
        # A mesh of one rank runs the world-1 code.
        self.sharded = mesh is not None and mesh.world > 1
        self.overlap = overlap
        self.model: Optional[TransformerLM] = None
        self.opt: Optional[AdamW] = None
        self.buckets: Optional[GradBuckets] = None
        self.step = 0
        self._warm = False
        # Step time and MFU of the most recent timed train_many call (the
        # first call pays kernel build and warm-up and is not timed). MFU
        # is only computed on a CUDA device, against its peak.
        self.last_step_seconds: Optional[float] = None
        self.last_mfu: Optional[float] = None
        # The same numbers on the process registry, as the reference's
        # loop records them (the plane's /metrics bridges kfx_train_*):
        # kfx_train_step_seconds{job,config}, and kfx_train_mfu where an
        # MFU is computed (on a CUDA device). The labels resolve at the
        # first record: the pipelined subclass swaps self.plan.
        obs = default_registry()
        self._obs_step = obs.histogram(
            "kfx_train_step_seconds",
            "Per-optimizer-step wall time (fused dispatches amortised).")
        self._obs_mfu = obs.gauge(
            "kfx_train_mfu",
            "Model FLOPs utilisation of the most recent training "
            "dispatch (fraction of the cards' peak bf16 FLOP/s).")
        self._obs_labels: Optional[Dict[str, str]] = None

    # -- state --------------------------------------------------------------
    def init_state(self, state_dict: Optional[Dict[str, torch.Tensor]] = None
                   ) -> TransformerLM:
        """Build the model with params drawn from ``hp.seed`` (or loaded
        from the full ``state_dict``) and a fresh optimizer state; on a
        mesh, every rank draws the full params as world 1 does and keeps
        its shard."""
        gen = torch.Generator(device=self.device).manual_seed(self.hp.seed)
        model = TransformerLM(self.cfg, device=self.device, generator=gen)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = self._place(model) if self.sharded else model
        params = list(self.model.parameters())
        self.opt = AdamW(params, self.hp, norm_fn=(
            self._global_norm if self.sharded else None))
        if self.sharded:
            if self.buckets is not None:
                self.buckets.close()
            self.buckets = GradBuckets(
                params, self.mesh, overlap=self.overlap and not self._pipelined)
        self.step = 0
        return self.model

    def _place(self, model: TransformerLM) -> TransformerLM:
        """This rank's part of the full ``model``."""
        return model.shard(self.mesh, self.plan)

    def _global_names(self) -> List[str]:
        """Every param of the full model, in the world-1 model's order."""
        return [n for n, _ in self.model.named_parameters()]

    def _full_tensors(self, name: str, p: torch.Tensor, tensors
                      ) -> Dict[str, List[torch.Tensor]]:
        """{global name: the full ``tensors``} for the local param
        ``name`` (collective over the axes that cut it)."""
        return {name: [full_from_shards(name, t, p.kfx_spec, self.mesh)
                       for t in tensors]}

    def _local_name(self, name: str) -> Optional[str]:
        """The local param of global ``name`` (None: another rank's)."""
        return name

    def state_tree(self) -> Dict[str, object]:
        """What a checkpoint holds (``training/checkpoint.py``): the step,
        the params and AdamW's moments and count, whole (the world-1
        tree; on a mesh a collective, every rank gets it)."""
        if not self.sharded:
            return {"step": self.step, "params": self.model.state_dict(),
                    "opt_state": {"mu": list(self.opt.mu),
                                  "nu": list(self.opt.nu),
                                  "count": self.opt.count}}
        full = self._gather(with_moments=True)
        order = self._global_names()
        return {"step": self.step,
                "params": {n: full[n][0] for n in order},
                "opt_state": {"mu": [full[n][1] for n in order],
                              "nu": [full[n][2] for n in order],
                              "count": self.opt.count}}

    def _gather(self, with_moments: bool) -> Dict[str, List[torch.Tensor]]:
        """{global name: [full param(, full mu, full nu)]}, a collective."""
        full: Dict[str, List[torch.Tensor]] = {}
        for i, (name, p) in enumerate(self.model.named_parameters()):
            ts = [p.detach()]
            if with_moments:
                ts += [self.opt.mu[i], self.opt.nu[i]]
            full.update(self._full_tensors(name, p, ts))
        return full

    def full_params(self) -> Dict[str, torch.Tensor]:
        """The full params (the world-1 ``state_dict``; on a mesh a
        collective)."""
        if not self.sharded:
            return self.model.state_dict()
        full = self._gather(with_moments=False)
        return {n: full[n][0] for n in self._global_names()}

    def n_params(self) -> int:
        """Parameters of the full model (no communication)."""
        ps = list(self.model.parameters())
        if not self.sharded:
            return sum(p.numel() for p in ps)
        return sum(p.numel() * self._cut(p) for p in ps)

    @torch.no_grad()
    def load_state_tree(self, tree: Dict[str, object]) -> "LMTrainLoop":
        """Copy a tree of ``state_tree``'s structure into this loop (on a
        mesh, this rank's shard of it)."""
        opt = tree["opt_state"]
        if not self.sharded:
            self.model.load_state_dict(tree["params"])
            for mine, saved in zip(self.opt.mu + self.opt.nu,
                                   list(opt["mu"]) + list(opt["nu"])):
                mine.copy_(saved)
        else:
            order = self._global_names()
            at = {n: i for i, n in enumerate(order)}
            for i, (name, p) in enumerate(self.model.named_parameters()):
                g = self._global_name(name)
                for mine, full in ((p, tree["params"][g]),
                                   (self.opt.mu[i], opt["mu"][at[g]]),
                                   (self.opt.nu[i], opt["nu"][at[g]])):
                    mine.copy_(local_shard(name, full, p.kfx_spec,
                                           self.mesh))
        self.opt.count = int(opt["count"])
        self.step = int(tree["step"])
        return self

    def _global_name(self, name: str) -> str:
        """The full model's name of the local param ``name``."""
        return name

    # -- rows ---------------------------------------------------------------
    def local_rows(self, batch: np.ndarray) -> np.ndarray:
        """This rank's rows of a global batch: the slice of its "data"
        coordinate (every rank at one at world 1)."""
        if not self.sharded:
            return batch
        dp = self.plan.dp
        if batch.shape[0] % dp:
            raise ValueError(f"batch {batch.shape[0]} not divisible by "
                             f"dp={dp}")
        per = batch.shape[0] // dp
        d = self.mesh.index("data")
        return batch[d * per:(d + 1) * per]

    # -- loss ---------------------------------------------------------------
    def _ce_sums(self, logits: torch.Tensor, targets: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sum of f32 CE, number of argmax hits) over the tokens of
        ``logits`` [..., V] (this rank's vocab slice under tp: the
        vocab-parallel CE, replicated over "model")."""
        tp = self.mesh.shape["model"] if self.sharded else 1
        if tp == 1:
            ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                 targets.reshape(-1), reduction="sum")
            hits = (logits.argmax(-1) == targets).to(torch.float32).sum()
            return ce, hits
        mesh = self.mesh
        rows = logits.shape[-1]
        lo = mesh.index("model") * rows
        m = comm.raw_all_reduce(logits.detach().amax(-1), mesh, "model",
                                op=torch.distributed.ReduceOp.MAX)
        se = comm.reduce_from(torch.exp(logits - m[..., None]).sum(-1),
                              mesh, "model")
        mine = (targets >= lo) & (targets < lo + rows)
        tgt = logits.gather(-1, torch.where(mine, targets - lo, 0)[
            ..., None])[..., 0] * mine
        tgt = comm.reduce_from(tgt, mesh, "model")
        ce = (torch.log(se) + m - tgt).sum()
        # Accuracy: the first index of the global max, as argmax picks.
        with torch.no_grad():
            idx = logits.argmax(-1)
            val = logits.gather(-1, idx[..., None])[..., 0]
            top = comm.raw_all_reduce(val, mesh, "model",
                                      op=torch.distributed.ReduceOp.MAX)
            cand = torch.where(val == top, idx + lo, self.cfg.vocab_size)
            first = comm.raw_all_reduce(cand, mesh, "model",
                                        op=torch.distributed.ReduceOp.MIN)
            hits = (first == targets).to(torch.float32).sum()
        return ce, hits

    def _chunk_ce(self, h_c: torch.Tensor, t_c: torch.Tensor,
                  kernel: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One chunk's lm_head (in ``cfg.dtype``, the Dense it replaces)
        and f32 CE: (sum of CE, number of hits)."""
        dt = self.cfg.dtype
        par = self.model.lm_head.par
        if par is not None:
            kernel = par.use(kernel)
        logits = torch.matmul(h_c.to(dt), kernel.to(dt)).to(torch.float32)
        return self._ce_sums(logits, t_c)

    def _chunked_sums(self, hidden: torch.Tensor, targets: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's ``_chunked_ce``: lm_head + CE per
        ``cfg.loss_chunk``-token chunk, each chunk checkpointed, so only
        one [B, C, vocab] f32 transient (and its grad) exists at a time.
        Returns (sum of CE, hits); the lm_head grad flows through the
        kernel used here."""
        C = self.cfg.loss_chunk
        S = hidden.shape[1]
        if S % C:
            raise ValueError(f"seq len {S} not divisible by "
                             f"loss_chunk={C}")
        kernel = self.model.lm_head.kernel
        ce_sum = hit_sum = 0.0
        for i in range(S // C):
            h_c, t_c = hidden[:, i * C:(i + 1) * C], \
                targets[:, i * C:(i + 1) * C]
            if torch.is_grad_enabled():
                ce, hits = _ckpt.checkpoint(
                    self._chunk_ce, h_c, t_c, kernel, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                ce, hits = self._chunk_ce(h_c, t_c, kernel)
            ce_sum = ce_sum + ce
            hit_sum = hit_sum + hits
        return ce_sum, hit_sum

    def _chunked_ce(self, hidden: torch.Tensor, targets: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean CE, accuracy) of ``_chunked_sums`` on one device."""
        B, S, _ = hidden.shape
        ce_sum, hit_sum = self._chunked_sums(hidden, targets)
        return ce_sum / (B * S), hit_sum / (B * S)

    def _loss_fn(self, tokens: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens: [B, S+1] (inputs || shifted targets) -> (loss,
        accuracy): mean f32 CE (whole logits, or chunked with
        ``loss_chunk``) plus, with experts, ``moe_aux_weight`` times the
        layers' mean aux loss."""
        cfg = self.cfg
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        aux: List[torch.Tensor] = []
        out = self.model(inputs, return_hidden=cfg.loss_chunk > 0,
                         aux_out=aux)
        if cfg.loss_chunk > 0:
            loss, acc = self._chunked_ce(out, targets)
        else:
            loss = F.cross_entropy(out.reshape(-1, out.shape[-1]),
                                   targets.reshape(-1))
            acc = (out.argmax(-1) == targets).to(torch.float32).mean()
        if cfg.n_experts:
            loss = loss + self.hp.moe_aux_weight * (
                torch.stack(aux).sum() / max(cfg.n_layers, 1))
        return loss, acc

    def _head_sums(self, out: torch.Tensor, targets: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sum of CE, hits) of the model's output (logits, or the hidden
        state with ``loss_chunk``) against ``targets``."""
        if self.cfg.loss_chunk > 0:
            return self._chunked_sums(out, targets)
        return self._ce_sums(out, targets)

    def _report(self, ce_sum: torch.Tensor, hits: torch.Tensor,
                n_tokens: int, aux_mean: Optional[torch.Tensor],
                axes=("data", "ctx")) -> Tuple[torch.Tensor, torch.Tensor]:
        """The global (loss, accuracy) from this rank's sums: the CE sums
        over ``axes``, over the global token count, plus the aux term."""
        both = torch.stack([ce_sum.detach(), hits.detach()])
        for ax in axes:
            both = comm.raw_all_reduce(both, self.mesh, ax)
        loss = both[0] / n_tokens
        if aux_mean is not None:
            loss = loss + self.hp.moe_aux_weight * aux_mean.detach()
        return loss, both[1] / n_tokens

    def _aux_scale(self) -> float:
        """The share of the (replicated) aux loss each rank adds to its
        objective: summed over the partial axes it counts once."""
        sh = self.mesh.shape
        return 1.0 / (sh["data"] * sh["ctx"] * sh["model"])

    def _sharded_loss(self, tokens: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """tokens: this rank's [b, S+1] rows -> (this rank's objective,
        global loss, global accuracy)."""
        cfg, mesh = self.cfg, self.mesh
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        n_tokens = tokens.shape[0] * self.plan.dp * inputs.shape[1]
        if self.plan.cp > 1:
            i, cp = mesh.index("ctx"), self.plan.cp
            if inputs.shape[1] % cp:
                raise ValueError(f"seq len {inputs.shape[1]} not divisible "
                                 f"by cp={cp}")
            inputs = inputs.chunk(cp, 1)[i]
            targets = targets.chunk(cp, 1)[i]
        aux: List[torch.Tensor] = []
        out = self.model(inputs, return_hidden=cfg.loss_chunk > 0,
                         aux_out=aux)
        ce_sum, hits = self._head_sums(out, targets)
        obj = ce_sum / n_tokens
        aux_mean = None
        if cfg.n_experts:
            aux_mean = torch.stack(aux).sum() / max(cfg.n_layers, 1)
            obj = obj + self.hp.moe_aux_weight * aux_mean * self._aux_scale()
        loss, acc = self._report(ce_sum, hits, n_tokens, aux_mean)
        return obj, loss, acc

    # -- grads --------------------------------------------------------------
    def _sync_grads(self) -> None:
        """All-reduce every partial grad over the axes its param names:
        "data" through the buckets, the rest one by one."""
        params = self.opt.params
        for p in params:
            if p.grad is None:   # unused on this rank: a zero contribution
                p.grad = torch.zeros_like(p)
        self.buckets.finish()
        for p in params:
            for ax in p.kfx_partial:
                if ax != "data":
                    p.grad = comm.raw_all_reduce(p.grad, self.mesh, ax)

    def _cut(self, p: torch.Tensor) -> int:
        """Into how many slices ``p``'s param is cut across the ranks."""
        cut = 1
        for ax in p.kfx_spec:
            if ax is not None:
                cut *= self.mesh.shape[ax]
        if getattr(p, "kfx_stage", False):
            cut *= self.mesh.shape["stage"]
        return cut

    def _copies(self, p: torch.Tensor) -> int:
        """How many ranks hold the same slice of ``p``."""
        return self.mesh.world // self._cut(p)

    def _global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global gradient's norm: each slice's sum of squares
        counted once (divided by its copies), summed over every rank."""
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for p, g in zip(self.opt.params, grads):
            total = total + g.to(torch.float32).pow(2).sum() / self._copies(p)
        return torch.sqrt(comm.all_reduce_world(total, self.mesh))

    def _tokens(self, tokens: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(tokens)).to(
            self.device, torch.long)

    def _n_cards(self) -> int:
        """Distinct cards the ranks use (ranks share a card when there
        are more ranks than cards)."""
        world = self.mesh.world if self.sharded else 1
        return min(world, torch.cuda.device_count())

    def _record_steps(self, seconds: float, n_steps: int, n_tokens: int,
                      seq_len: int) -> None:
        if seconds <= 0 or n_steps <= 0 or n_tokens <= 0:
            return
        self.last_step_seconds = seconds / n_steps
        if self._obs_labels is None:
            plan, cfg = self.plan, self.cfg
            self._obs_labels = {
                "job": os.environ.get("KFX_JOB_NAME", "local"),
                "config": (f"pp{plan.pp}/dp{plan.dp}/cp{plan.cp}/"
                           f"tp{plan.tp}" + ("/fsdp" if plan.fsdp else "")
                           + f"-d{cfg.d_model}L{cfg.n_layers}")}
        self._obs_step.observe(self.last_step_seconds, n=n_steps,
                               **self._obs_labels)
        if self.device.type == "cuda":
            from ..utils.flops import mfu, transformer_train_flops_per_token

            self.last_mfu = mfu(n_tokens / seconds,
                                transformer_train_flops_per_token(
                                    self.cfg, seq_len),
                                n_cards=self._n_cards())
            self._obs_mfu.set(round(self.last_mfu, 6), **self._obs_labels)

    # -- steps --------------------------------------------------------------
    def _train_one(self, tokens: torch.Tensor):
        """One optimizer step on ``tokens``; returns (loss, accuracy) as
        tensors."""
        if not self.sharded:
            loss, acc = self._loss_fn(tokens)
            loss.backward()
        else:
            obj, loss, acc = self._sharded_loss(tokens)
            obj.backward()
            self._sync_grads()
        self.opt.step()
        self.model.zero_grad(set_to_none=True)
        return loss, acc

    def train_step(self, tokens: np.ndarray) -> Tuple[float, float]:
        return self.train_many([tokens])

    def train_many(self, batches) -> Tuple[float, float]:
        """Run a sequence of token batches (this rank's rows of each
        global batch) with ONE host sync at the end; returns the last
        step's (loss, accuracy), global means."""
        if self.model is None:
            raise RuntimeError("call init_state() first")
        self.model.train()
        loss = acc = None
        n_steps = n_tokens = seq_len = 0
        rows = self.plan.dp if self.sharded else 1
        t0 = time.perf_counter()
        for tokens in batches:
            seq_len = tokens.shape[1] - 1
            n_tokens += tokens.shape[0] * rows * seq_len
            n_steps += 1
            loss, acc = self._train_one(self._tokens(tokens))
            self.step += 1
        if loss is None:
            raise ValueError("train_many needs at least one batch")
        # Device sync before timing.
        loss, acc = float(loss.detach()), float(acc)
        if self._warm:
            self._record_steps(time.perf_counter() - t0, n_steps, n_tokens,
                               seq_len)
        self._warm = True
        return loss, acc

    def _eval_loss(self, tokens: torch.Tensor):
        if not self.sharded:
            return self._loss_fn(tokens)
        return self._sharded_loss(tokens)[1:]

    @torch.no_grad()
    def evaluate(self, tokens: np.ndarray) -> Dict[str, float]:
        """Global loss and accuracy on ``tokens`` (this rank's rows)."""
        self.model.eval()
        loss, acc = self._eval_loss(self._tokens(tokens))
        return {"loss": float(loss), "accuracy": float(acc)}
