"""Small convnet classifier — port of ``kubeflow_tpu/models/cnn.py``."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from .layers import Classifier, Conv, Dense
from .registry import register_model


class CNN(Classifier):
    """(3x3 SAME conv + relu + 2x2 max-pool) per feature width, a relu
    Dense, f32 logits. The flatten before the Dense is in NHWC order, as
    flax's."""

    def __init__(self, input_shape: Sequence[int], num_classes: int = 10,
                 features: Sequence[int] = (64, 128), dense: int = 256,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0):
        super().__init__(input_shape, num_classes, dtype)
        h, w, c = self.input_shape
        for i, f in enumerate(features):
            self.add_module(f"Conv_{i}", Conv(c, f, 3, dtype=dtype))
            c, h, w = f, h // 2, w // 2
        self.n_convs = len(features)
        self.Dense_0 = Dense(h * w * c, dense, dtype)
        self.Dense_1 = Dense(dense, num_classes, torch.float32)
        self._init(seed)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        for i in range(self.n_convs):
            x = F.max_pool2d(torch.relu(getattr(self, f"Conv_{i}")(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.Dense_1(torch.relu(self.Dense_0(x)))


@register_model("cnn")
def _cnn(num_classes: int = 10, input_shape: Sequence[int] = (28, 28, 1),
         **kw):
    return CNN(input_shape, num_classes=num_classes, **kw)
