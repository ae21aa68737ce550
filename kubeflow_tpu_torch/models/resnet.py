"""ResNet v1.5 (18/50) — port of ``kubeflow_tpu/models/resnet.py``.

bf16 convs, f32 BatchNorm statistics, an f32 residual stream (flax's f32
BatchNorm output feeds the add) and f32 logits. The stem follows the
input size, as the reference's: the CIFAR stem (3x3 conv, no max-pool)
for H <= 64, else the ImageNet stem (7x7/2 conv and a 3x3/2 max-pool,
both with flax's uneven SAME pads).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .layers import BatchNorm, Classifier, Conv, Dense, max_pool_same
from .registry import register_model


class ResNetBlock(nn.Module):
    expansion = 1

    def __init__(self, c_in: int, filters: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        self.Conv_0 = Conv(c_in, filters, 3, stride, False, dtype)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3, 1, False, dtype)
        self.BatchNorm_1 = BatchNorm(filters, zero_scale=True)
        _proj(self, c_in, filters, stride, dtype)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        return torch.relu(_residual(self, x, train) + y)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, c_in: int, filters: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        self.Conv_0 = Conv(c_in, filters, 1, 1, False, dtype)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3, stride, False, dtype)
        self.BatchNorm_1 = BatchNorm(filters)
        self.Conv_2 = Conv(filters, filters * 4, 1, 1, False, dtype)
        self.BatchNorm_2 = BatchNorm(filters * 4, zero_scale=True)
        _proj(self, c_in, filters * 4, stride, dtype)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = torch.relu(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        return torch.relu(_residual(self, x, train) + y)


def _proj(block: nn.Module, c_in: int, c_out: int, stride: int,
          dtype: torch.dtype) -> None:
    """The reference projects the residual when its shape differs from
    the block's output: a stride or a change of width."""
    block.has_proj = stride != 1 or c_in != c_out
    if block.has_proj:
        block.conv_proj = Conv(c_in, c_out, 1, stride, False, dtype)
        block.norm_proj = BatchNorm(c_out)


def _residual(block: nn.Module, x: torch.Tensor, train: bool
              ) -> torch.Tensor:
    if block.has_proj:
        return block.norm_proj(block.conv_proj(x), train)
    return x


class ResNet(Classifier):
    def __init__(self, input_shape: Sequence[int], stage_sizes: Sequence[int],
                 block_cls, num_classes: int = 10, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0):
        super().__init__(input_shape, num_classes, dtype)
        h, _, c = self.input_shape
        self.small_input = h <= 64
        k, s = (3, 1) if self.small_input else (7, 2)
        self.conv_init = Conv(c, num_filters, k, s, False, dtype)
        self.bn_init = BatchNorm(num_filters)
        c = num_filters
        n = 0
        for i, size in enumerate(stage_sizes):
            for j in range(size):
                stride = 2 if i > 0 and j == 0 else 1
                filters = num_filters * 2 ** i
                self.add_module(f"{block_cls.__name__}_{n}",
                                block_cls(c, filters, stride, dtype))
                c = filters * block_cls.expansion
                n += 1
        self.n_blocks = n
        self.block_prefix = block_cls.__name__
        self.head = Dense(c, num_classes, torch.float32)
        self._init(seed)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)   # NCHW, channels_last
        x = torch.relu(self.bn_init(self.conv_init(x), train))
        if not self.small_input:
            x = max_pool_same(x, 3, 2)
        for i in range(self.n_blocks):
            x = getattr(self, f"{self.block_prefix}_{i}")(x, train)
        return self.head(x.mean((2, 3)))


def ResNet18(input_shape: Sequence[int], **kw) -> ResNet:
    return ResNet(input_shape, [2, 2, 2, 2], ResNetBlock, **kw)


def ResNet50(input_shape: Sequence[int], **kw) -> ResNet:
    return ResNet(input_shape, [3, 4, 6, 3], BottleneckBlock, **kw)


@register_model("resnet18")
def _resnet18(num_classes: int = 10, input_shape: Sequence[int] = (32, 32, 3),
              **kw):
    return ResNet18(input_shape, num_classes=num_classes, **kw)


@register_model("resnet50")
def _resnet50(num_classes: int = 10, input_shape: Sequence[int] = (32, 32, 3),
              **kw):
    return ResNet50(input_shape, num_classes=num_classes, **kw)
