"""MLP classifier — port of ``kubeflow_tpu/models/mlp.py``."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .layers import Classifier, Dense
from .registry import register_model


class MLP(Classifier):
    """Dense + relu per hidden width, then f32 logits; the NHWC input is
    flattened as flax flattens it (H, W, C order)."""

    def __init__(self, input_shape: Sequence[int],
                 features: Sequence[int] = (512, 256), num_classes: int = 10,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0):
        super().__init__(input_shape, num_classes, dtype)
        d = 1
        for n in self.input_shape:
            d *= n
        for i, f in enumerate(features):
            self.add_module(f"Dense_{i}", Dense(d, f, dtype))
            d = f
        self.add_module(f"Dense_{len(features)}",
                        Dense(d, num_classes, torch.float32))
        self._init(seed)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dense = list(self.children())
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for layer in dense[:-1]:
            x = torch.relu(layer(x))
        return dense[-1](x)


@register_model("mlp")
def _mlp(num_classes: int = 10, hidden: Sequence[int] = (512, 256),
         input_shape: Sequence[int] = (28, 28, 1), **kw):
    return MLP(input_shape, features=tuple(hidden), num_classes=num_classes,
               **kw)
