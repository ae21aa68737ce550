"""Single-device LM training — port of ``kubeflow_tpu/parallel/lm_train.py``.

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
returns a new state pytree). Meshes (dp/fsdp/tp/sp/cp/ep/pp) come in a
later slice; this loop owns one device.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from ..device import resolve_device
from ..models.transformer import TransformerConfig, TransformerLM


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
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8):
        self.params: List[torch.Tensor] = list(params)
        self.hp = hp
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
    """Owns the model, the optimizer and the step on one device."""

    def __init__(self, cfg: TransformerConfig,
                 hp: Optional[LMHyperParams] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        self.hp = hp or LMHyperParams()
        self.device = resolve_device(device)
        self.model: Optional[TransformerLM] = None
        self.opt: Optional[AdamW] = None
        self.step = 0
        self._warm = False
        # Step time and MFU of the most recent timed train_many call (the
        # first call pays kernel build and warm-up and is not timed). MFU
        # is only computed on a CUDA device, against its peak.
        self.last_step_seconds: Optional[float] = None
        self.last_mfu: Optional[float] = None

    # -- state --------------------------------------------------------------
    def init_state(self, state_dict: Optional[Dict[str, torch.Tensor]] = None
                   ) -> TransformerLM:
        """Build the model with params drawn from ``hp.seed`` (or loaded
        from ``state_dict``) and a fresh optimizer state."""
        gen = torch.Generator(device=self.device).manual_seed(self.hp.seed)
        self.model = TransformerLM(self.cfg, device=self.device,
                                   generator=gen)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.opt = AdamW(self.model.parameters(), self.hp)
        self.step = 0
        return self.model

    def state_tree(self) -> Dict[str, object]:
        """What a checkpoint holds (``training/checkpoint.py``): the step,
        the params and AdamW's moments and count."""
        return {"step": self.step, "params": self.model.state_dict(),
                "opt_state": {"mu": list(self.opt.mu),
                              "nu": list(self.opt.nu),
                              "count": self.opt.count}}

    @torch.no_grad()
    def load_state_tree(self, tree: Dict[str, object]) -> "LMTrainLoop":
        """Copy a tree of ``state_tree``'s structure into this loop."""
        self.model.load_state_dict(tree["params"])
        opt = tree["opt_state"]
        for mine, saved in zip(self.opt.mu + self.opt.nu,
                               list(opt["mu"]) + list(opt["nu"])):
            mine.copy_(saved)
        self.opt.count = int(opt["count"])
        self.step = int(tree["step"])
        return self

    # -- loss ---------------------------------------------------------------
    def _chunk_ce(self, h_c: torch.Tensor, t_c: torch.Tensor,
                  kernel: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One chunk's lm_head (in ``cfg.dtype``, the Dense it replaces)
        and f32 CE: (sum of CE, number of hits)."""
        dt = self.cfg.dtype
        logits = torch.matmul(h_c.to(dt), kernel.to(dt)).to(torch.float32)
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             t_c.reshape(-1), reduction="sum")
        hits = (logits.argmax(-1) == t_c).to(torch.float32).sum()
        return ce, hits

    def _chunked_ce(self, hidden: torch.Tensor, targets: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's ``_chunked_ce``: lm_head + CE per
        ``cfg.loss_chunk``-token chunk, each chunk checkpointed, so only
        one [B, C, vocab] f32 transient (and its grad) exists at a time.
        Returns (mean CE, accuracy); the lm_head grad flows through the
        kernel used here."""
        C = self.cfg.loss_chunk
        B, S, _ = hidden.shape
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

    def _tokens(self, tokens: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(tokens)).to(
            self.device, torch.long)

    def _record_steps(self, seconds: float, n_steps: int, n_tokens: int,
                      seq_len: int) -> None:
        if seconds <= 0 or n_steps <= 0 or n_tokens <= 0:
            return
        self.last_step_seconds = seconds / n_steps
        if self.device.type == "cuda":
            from ..utils.flops import mfu, transformer_train_flops_per_token

            self.last_mfu = mfu(n_tokens / seconds,
                                transformer_train_flops_per_token(
                                    self.cfg, seq_len))

    # -- steps --------------------------------------------------------------
    def train_step(self, tokens: np.ndarray) -> Tuple[float, float]:
        return self.train_many([tokens])

    def train_many(self, batches) -> Tuple[float, float]:
        """Run a sequence of token batches with ONE host sync at the end;
        returns the last step's (loss, accuracy)."""
        if self.model is None:
            raise RuntimeError("call init_state() first")
        self.model.train()
        loss = acc = None
        n_steps = n_tokens = seq_len = 0
        t0 = time.perf_counter()
        for tokens in batches:
            seq_len = tokens.shape[1] - 1
            n_tokens += tokens.shape[0] * seq_len
            n_steps += 1
            loss, acc = self._loss_fn(self._tokens(tokens))
            loss.backward()
            self.opt.step()
            self.model.zero_grad(set_to_none=True)
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

    @torch.no_grad()
    def evaluate(self, tokens: np.ndarray) -> Dict[str, float]:
        self.model.eval()
        loss, acc = self._loss_fn(self._tokens(tokens))
        return {"loss": float(loss), "accuracy": float(acc)}
