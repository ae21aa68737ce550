"""Classifier training loop on one device — port of
``kubeflow_tpu/training/loop.py``.

The reference jits one GSPMD step over a device mesh and fuses K steps
into one dispatch with ``lax.scan``. The port owns one device: a step is
eager PyTorch (bf16 compute, f32 params, optimizer state and BatchNorm
statistics), and ``train_steps`` / ``train_steps_device`` run K steps
with one host sync at the end, the counterpart of the scan's single
round trip. Params, running stats and optimizer state are updated in
place; the methods still return the state, as the reference's do.

The optimizers are optax's, written for PyTorch (``OptaxOptimizer``):
hyperparameters live in the optimizer's ``param_groups`` and travel with
a checkpoint (optax's ``inject_hyperparams`` keeps them in ``opt_state``);
``reapply_hyperparams`` writes this loop's values back over a restored
state. The reference's ``legacy_checkpoint_layouts`` is not ported: it
migrates an optax layout from before ``inject_hyperparams`` that no
checkpoint of the port ever had.

The mesh is one device: ``KFX_NUM_PROCESSES`` > 1 raises (multi-GPU is
ROADMAP.md Queue A 6).
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Any, Dict, List, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..obs.metrics import default_registry

_HYPER = ("lr", "weight_decay", "momentum")


@dataclasses.dataclass
class TrainMetrics:
    step: int
    loss: float
    accuracy: float
    seconds: float

    def line(self) -> str:
        """The stdout contract the metrics collector parses."""
        return (f"step={self.step} loss={self.loss:.6f} "
                f"accuracy={self.accuracy:.6f} step_time={self.seconds:.4f}")


class OptaxOptimizer(torch.optim.Optimizer):
    """optax's ``adam``, ``adamw``, ``sgd`` (momentum, trace form) and
    ``lamb`` over f32 params, in place. State is created with the
    optimizer (optax's ``init``), so a fresh state and a trained one have
    the same structure, which a checkpoint restore compares.

      adam   scale_by_adam(b1, b2, eps) -> scale(-lr)
      adamw  scale_by_adam -> add_decayed_weights(wd) (every param, biases
             and norm scales included: optax's default mask) -> scale(-lr)
      sgd    trace(decay=momentum): t = g + momentum * t -> scale(-lr)
      lamb   scale_by_adam(eps=1e-6) -> add_decayed_weights(wd) ->
             scale_by_trust_ratio (||p|| / ||u||, 1 where either is 0)
             -> scale(-lr)

    scale_by_adam: mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2,
    update = mu / (1 - b1^t) / (sqrt(nu / (1 - b2^t)) + eps) at the
    incremented count t.
    """

    B1, B2 = 0.9, 0.999   # optax's defaults for all three adam forms

    def __init__(self, params, kind: str, lr: float,
                 weight_decay: float = 0.0, momentum: float = 0.9):
        if kind not in ("adam", "adamw", "sgd", "lamb"):
            raise KeyError(f"unknown optimizer {kind!r} (adam|adamw|sgd|lamb)")
        super().__init__(params, dict(kind=kind, lr=lr,
                                      weight_decay=weight_decay,
                                      momentum=momentum))
        self.eps = 1e-6 if kind == "lamb" else 1e-8
        for group in self.param_groups:
            for p in group["params"]:
                if kind == "sgd":
                    self.state[p] = {"trace": torch.zeros_like(p)}
                else:
                    # "step" (optax's count) stays a host int64 tensor:
                    # load_state_dict casts other entries to the param's
                    # dtype and device.
                    self.state[p] = {"mu": torch.zeros_like(p),
                                     "nu": torch.zeros_like(p),
                                     "step": torch.zeros((),
                                                         dtype=torch.int64)}

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            lr, wd, kind = group["lr"], group["weight_decay"], group["kind"]
            if kind == "sgd":
                trace = [self.state[p]["trace"] for p in params]
                torch._foreach_mul_(trace, group["momentum"])
                torch._foreach_add_(trace, grads)
                torch._foreach_add_(params, trace, alpha=-lr)
                continue
            b1, b2 = self.B1, self.B2
            mu = [self.state[p]["mu"] for p in params]
            nu = [self.state[p]["nu"] for p in params]
            count = self.state[params[0]]["step"]
            count += 1
            for p in params[1:]:
                self.state[p]["step"].copy_(count)
            t = int(count)
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
            denom = torch._foreach_div(nu, 1 - b2 ** t)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            upd = torch._foreach_div(mu, 1 - b1 ** t)
            torch._foreach_div_(upd, denom)
            if kind in ("adamw", "lamb") and wd:
                torch._foreach_add_(upd, params, alpha=wd)
            if kind == "lamb":
                p_norm = torch._foreach_norm(params)
                u_norm = torch._foreach_norm(upd)
                ratio = [torch.where((pn == 0) | (un == 0),
                                     torch.ones_like(pn), pn / un)
                         for pn, un in zip(p_norm, u_norm)]
                torch._foreach_mul_(upd, ratio)
            torch._foreach_add_(params, upd, alpha=-lr)


def _make_optimizer(name: str, lr: float, weight_decay: float
                    ) -> Tuple[Any, Dict[str, float]]:
    """(factory params -> OptaxOptimizer, configured hyperparams) with the
    reference's choices: adamw decays by ``weight_decay or 1e-4``, sgd
    uses momentum 0.9, lamb decays by ``weight_decay``."""
    name = name.lower()
    if name == "adam":
        hp = {"lr": lr}
    elif name == "adamw":
        hp = {"lr": lr, "weight_decay": weight_decay or 1e-4}
    elif name == "sgd":
        hp = {"lr": lr, "momentum": 0.9}
    elif name == "lamb":
        hp = {"lr": lr, "weight_decay": weight_decay}
    else:
        raise KeyError(f"unknown optimizer {name!r} (adam|adamw|sgd|lamb)")

    def make(params) -> OptaxOptimizer:
        return OptaxOptimizer(params, name, **hp)

    return make, hp


@dataclasses.dataclass
class TrainState:
    """The model (params and BatchNorm running stats), its optimizer and
    the step count. ``state_tree`` is what a checkpoint holds."""

    step: int
    model: torch.nn.Module
    optimizer: OptaxOptimizer

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_buffers())

    def state_tree(self) -> Dict[str, Any]:
        return {"step": self.step,
                "params": {k: v.detach() for k, v in self.params.items()},
                "batch_stats": self.batch_stats,
                "opt_state": self.optimizer.state_dict()}

    @torch.no_grad()
    def load_state_tree(self, tree: Dict[str, Any]) -> "TrainState":
        """Copy a tree of ``state_tree``'s structure into this state."""
        for name, t in self.params.items():
            t.copy_(tree["params"][name])
        for name, t in self.batch_stats.items():
            t.copy_(tree["batch_stats"][name])
        self.optimizer.load_state_dict(tree["opt_state"])
        self.step = int(tree["step"])
        return self


class TrainLoop:
    """Builds and runs the step for a classifier of ``models/`` on one
    device (``cuda`` unless the caller passes ``device="cpu"``)."""

    def __init__(self, model, learning_rate: float = 1e-3,
                 optimizer: str = "adam", weight_decay: float = 0.0,
                 seed: int = 0, device: Union[str, torch.device] = "cuda"):
        n_proc = int(os.environ.get("KFX_NUM_PROCESSES", "1") or 1)
        if n_proc > 1:
            raise NotImplementedError(
                f"KFX_NUM_PROCESSES={n_proc}: the port's TrainLoop owns one "
                "device; multi-GPU data parallelism is ROADMAP.md Queue A 6")
        self.model = model
        self.seed = seed
        self.device = resolve_device(device)
        self._make_opt, self._hparams = _make_optimizer(
            optimizer, learning_rate, weight_decay)
        # Device-placed batch_fn prototype tables, one per batch_fn (the
        # entry pins the fn so its id() is never recycled).
        self._device_consts: Dict[int, Tuple[Any, torch.Tensor]] = {}
        obs = default_registry()
        self._obs_step = obs.histogram(
            "kfx_train_step_seconds",
            "Per-optimizer-step wall time (fused dispatches amortised).")
        self._obs_rate = obs.gauge(
            "kfx_train_examples_per_second",
            "Training throughput of the most recent dispatch.")
        self._obs_model = type(model).__name__

    def _record_steps(self, seconds: float, n_steps: int,
                      batch_size: int) -> None:
        if seconds <= 0 or n_steps <= 0:
            return
        self._obs_step.observe(seconds / n_steps, n=n_steps,
                               model=self._obs_model)
        self._obs_rate.set(round(n_steps * batch_size / seconds, 2),
                           model=self._obs_model)

    # -- state -------------------------------------------------------------
    def init_state(self, sample_shape: Tuple[int, ...]) -> TrainState:
        """A fresh state: a copy of the loop's model with params drawn from
        ``seed`` (on the CPU, so every device starts from the same
        weights), on the loop's device, and a fresh optimizer."""
        if tuple(sample_shape) != tuple(self.model.input_shape):
            raise ValueError(f"sample shape {tuple(sample_shape)} is not the "
                             f"model's input {self.model.input_shape}")
        model = copy.deepcopy(self.model).cpu()
        model.reset_parameters(torch.Generator().manual_seed(self.seed))
        model.to(self.device, memory_format=torch.channels_last)
        return TrainState(step=0, model=model,
                          optimizer=self._make_opt(model.parameters()))

    def reapply_hyperparams(self, state: TrainState) -> TrainState:
        """Re-assert THIS loop's hyperparams over a restored state:
        checkpoints carry the ones they were saved with, and on resume the
        CLI's values win."""
        for group in state.optimizer.param_groups:
            for k in _HYPER:
                if k in self._hparams:
                    group[k] = self._hparams[k]
        return state

    # -- steps -------------------------------------------------------------
    def _step(self, state: TrainState, images: torch.Tensor,
              labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One update; returns (loss, accuracy) as device scalars."""
        logits = state.model(images, train=True)
        loss = F.cross_entropy(logits, labels)
        acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
        loss.backward()
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return loss.detach(), acc

    def _put(self, images, labels) -> Tuple[torch.Tensor, torch.Tensor]:
        return (torch.as_tensor(images).to(self.device, torch.float32),
                torch.as_tensor(labels).to(self.device, torch.long))

    def train_step(self, state: TrainState, images: np.ndarray,
                   labels: np.ndarray) -> Tuple[TrainState, float, float]:
        state, loss, acc = self.train_steps(state, images[None],
                                            labels[None])
        return state, loss, acc

    def train_steps(self, state: TrainState, images: np.ndarray,
                    labels: np.ndarray) -> Tuple[TrainState, float, float]:
        """Run a [K, B, ...] stacked chunk with one host sync at the end;
        returns the last step's (loss, accuracy)."""
        state.model.train()
        t0 = time.perf_counter()
        x, y = self._put(images, labels)
        for k in range(x.shape[0]):
            loss, acc = self._step(state, x[k], y[k])
        loss, acc = float(loss), float(acc)  # sync before timing
        self._record_steps(time.perf_counter() - t0, images.shape[0],
                           images.shape[1])
        return state, loss, acc

    def step_seed(self, step: int) -> int:
        """The device batch generator's seed at an absolute step: a
        function of (seed + 1, step), so a resume continues the stream
        (the reference folds the step into PRNGKey(seed + 1))."""
        return int(np.random.SeedSequence([self.seed + 1, step])
                   .generate_state(1, np.uint64)[0])

    def train_steps_device(self, state: TrainState, batch_fn,
                           batch_size: int, start_step: int, n_steps: int
                           ) -> Tuple[TrainState, float, float]:
        """Run n_steps with batches drawn on the device by ``batch_fn``
        (``data.synthetic.Dataset.device_batch_fn``), one sync at the
        end."""
        entry = self._device_consts.get(id(batch_fn))
        if entry is None:
            consts = torch.from_numpy(batch_fn.consts).to(self.device)
            entry = self._device_consts[id(batch_fn)] = (batch_fn, consts)
        consts = entry[1]
        state.model.train()
        gen = torch.Generator(device=self.device)
        t0 = time.perf_counter()
        for i in range(n_steps):
            gen.manual_seed(self.step_seed(start_step + i))
            images, labels = batch_fn(consts, gen, batch_size)
            loss, acc = self._step(state, images, labels)
        loss, acc = float(loss), float(acc)  # sync before timing
        self._record_steps(time.perf_counter() - t0, n_steps, batch_size)
        return state, loss, acc

    @torch.no_grad()
    def evaluate(self, state: TrainState, images: np.ndarray,
                 labels: np.ndarray, batch_size: int = 512
                 ) -> Dict[str, float]:
        """Mean loss and accuracy over the full batches of ``batch_size``
        (a ragged tail is dropped, as the reference's sharded eval drops
        it); ``count`` is the number of examples seen."""
        state.model.eval()
        losses: List[float] = []
        accs: List[float] = []
        count = 0
        for i in range(0, len(images) - batch_size + 1, batch_size):
            x, y = self._put(images[i:i + batch_size],
                             labels[i:i + batch_size])
            logits = state.model(x, train=False)
            losses.append(float(F.cross_entropy(logits, y)))
            accs.append(float((logits.argmax(-1) == y).float().mean()))
            count += batch_size
        return {"loss": float(np.mean(losses)) if losses else float("nan"),
                "accuracy": float(np.mean(accs)) if accs else float("nan"),
                "count": count}
