"""LoRA fine-tuning: rank-r A/B factors trained against a FROZEN base —
port of ``kubeflow_tpu/training/lora.py`` ``LoRAFineTuner``.

A tenant's model is a low-rank correction ``y = base(x) + (x @ A) @ B *
alpha / r`` on the attention q/k/v/out and dense-FFN wi/wo projections
(``models/transformer.py``, ``lora_rank`` / ``lora_alpha``):

  * the base is frozen structurally: its tensors have
    ``requires_grad=False`` and are not in the optimizer, so autograd
    computes no base weight gradient and there is no optimizer state for
    it; gradients still reach q, k and v through the factors, so on the
    card at ``S >= flash_min_seq`` the step runs the flash forward, dQ and
    dK/dV kernels;
  * B starts at zero, so step 0 of every fine-tune is the base model;
  * the factors train with optax's ``adamw`` at its defaults (the
    reference's optimizer), on the mean cross-entropy of
    ``tokens[:, :-1]`` -> ``tokens[:, 1:]``;
  * ``export(dir, name)`` writes the adapter artifact the serving
    ``AdapterPool`` pages in (serving/export.py ``export_adapter``), and
    ``merged_params()`` folds ``alpha/r A B`` into the base kernels: the
    dense oracle the engine's batched-gather path is held to.

One device, ``device`` ("cuda" unless the caller asks for "cpu").
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models.convert import lora_from_jax, params_from_jax, params_to_jax
from ..models.transformer import TransformerConfig, TransformerLM
from .loop import OptaxOptimizer

# optax.adamw's default weight decay (the reference calls adamw(lr)).
ADAMW_WEIGHT_DECAY = 1e-4


class LoRAFineTuner:
    """One fine-tune: the base config and frozen base params, the LoRA
    factors and their optimizer state, and an eager train step.

    ``base_params`` is a reference-layout tree (nested dicts) or a port
    ``state_dict`` of the base (no factors). ``lora_init``, a LoRA leaf
    tree in the reference's layout (``split_lora_tree``'s lora side),
    replaces the seeded initial factors."""

    def __init__(self, cfg: TransformerConfig, base_params,
                 rank: int = 8, alpha: float = 16.0,
                 learning_rate: float = 1e-3, seed: int = 0,
                 device: Union[str, torch.device] = "cuda",
                 lora_init: Optional[Mapping[str, Any]] = None):
        if rank < 1:
            raise ValueError("rank must be >= 1")
        if cfg.n_experts > 0:
            raise ValueError("LoRA fine-tuning targets the dense FFN; "
                             "MoE configs are not supported")
        self.rank = int(rank)
        self.alpha = float(alpha)
        self.device = resolve_device(device)
        self.cfg = dataclasses.replace(cfg, lora_rank=self.rank,
                                       lora_alpha=self.alpha,
                                       decode=False, kv_page_size=0,
                                       kv_pages=0, kv_quant="")
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        self.model = TransformerLM(self.cfg, device=self.device,
                                   generator=g)
        base = base_params
        if any(isinstance(v, Mapping) for v in base.values()):
            base = params_from_jax(base)
        names = dict(self.model.named_parameters())
        self.lora_names = [n for n in names if "_lora_" in n]
        unexpected = sorted(set(base) - set(names))
        missing = sorted(set(names) - set(base) - set(self.lora_names))
        if unexpected or missing:
            raise KeyError(f"base params do not match the model: missing "
                           f"{missing}, unexpected {unexpected}")
        with torch.no_grad():
            for n, t in base.items():
                names[n].copy_(torch.as_tensor(t))
            if lora_init is not None:
                sd = lora_from_jax(lora_init)
                for n in self.lora_names:
                    names[n].copy_(torch.as_tensor(sd[n]))
        # The base: frozen, outside the optimizer.
        self.base: Dict[str, torch.Tensor] = {
            n: p.requires_grad_(False) for n, p in names.items()
            if n not in self.lora_names}
        self.lora: Dict[str, torch.nn.Parameter] = {
            n: names[n] for n in self.lora_names}
        self.opt = OptaxOptimizer(list(self.lora.values()), "adamw",
                                  learning_rate,
                                  weight_decay=ADAMW_WEIGHT_DECAY)
        self.step = 0

    def train_step(self, tokens) -> float:
        """One optimizer step over ``tokens`` [B, S+1] (inputs and the
        shifted targets): the mean next-token cross-entropy. Returns the
        loss; only the factors move."""
        t = torch.as_tensor(np.asarray(tokens) if not isinstance(
            tokens, torch.Tensor) else tokens).to(self.device).long()
        logits = self.model(t[:, :-1])
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               t[:, 1:].reshape(-1))
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        self.step += 1
        return float(loss.detach())

    def train(self, batches) -> List[float]:
        return [self.train_step(t) for t in batches]

    # -- outputs -------------------------------------------------------------
    def lora_flat(self) -> Dict[str, Dict[str, np.ndarray]]:
        """The artifact-form factors ({"attn.query": {"a", "b"}, ...},
        f32 numpy, stacked over the layers)."""
        from ..serving.adapters import LORA_TARGETS

        def stacked(key):
            return np.stack([self.lora[f"layers.{i}.{key}"].detach().cpu()
                             .numpy() for i in range(self.cfg.n_layers)])

        return {t: {ab: stacked(f"{t}_lora_{ab}") for ab in "ab"}
                for t in LORA_TARGETS}

    def params(self) -> dict:
        """Base and factors in one reference-layout tree: the params of
        the ``lora_rank`` model."""
        return params_to_jax({**self.base, **self.lora})

    def base_params(self) -> dict:
        """The frozen base as a reference-layout tree."""
        return params_to_jax(self.base)

    def merged_params(self) -> dict:
        """The dense merged-weights tree (``W + alpha/r A B``): the
        serving parity oracle, and a drop-in for any base-shaped consumer
        (``LMGenerator``, ``export_lm``)."""
        from ..serving.adapters import merge_lora_params

        return merge_lora_params(self.base_params(), self.lora_flat(),
                                 self.rank, self.alpha)

    def export(self, directory: str, name: str) -> str:
        """Write the versioned adapter artifact the serving pool pages
        in."""
        from ..serving.export import export_adapter

        return export_adapter(directory, name, self.cfg, self.lora_flat(),
                              self.rank, self.alpha)
