"""Vision Transformer classifier — port of ``kubeflow_tpu/models/vit.py``.

A strided-conv patch embedding, pre-LN encoder blocks (flax's
``MultiHeadDotProductAttention`` and a tanh-GELU MLP) in the compute
dtype with f32 LayerNorm statistics (eps 1e-6), mean-pooling over the
patch tokens (no CLS token) and f32 logits. Attention is plain torch ops,
as the reference's is plain XLA: q scaled by 1/sqrt(d_head) before QK^T,
the softmax kept in the compute dtype, biases on q/k/v/out.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Classifier, Conv, Dense, LayerNorm, lecun_normal_
from .registry import register_model


class MultiHeadDotProductAttention(nn.Module):
    """Self-attention with flax's param layout: query/key/value kernels
    [d, heads, d_head] with biases [heads, d_head]; out [heads, d_head,
    d] with bias [d]."""

    def __init__(self, d_model: int, n_heads: int, dtype: torch.dtype):
        super().__init__()
        self.n_heads, self.d_head = n_heads, d_model // n_heads
        self.dtype = dtype
        for name in ("query", "key", "value"):
            mod = nn.Module()
            mod.kernel = nn.Parameter(torch.empty(d_model, n_heads,
                                                  self.d_head))
            mod.bias = nn.Parameter(torch.empty(n_heads, self.d_head))
            self.add_module(name, mod)
        self.out = nn.Module()
        self.out.kernel = nn.Parameter(torch.empty(n_heads, self.d_head,
                                                   d_model))
        self.out.bias = nn.Parameter(torch.empty(d_model))

    def reset_parameters(self, generator: torch.Generator) -> None:
        d = self.query.kernel.shape[0]
        for mod, fan_in in ((self.query, d), (self.key, d), (self.value, d),
                            (self.out, self.n_heads * self.d_head)):
            lecun_normal_(mod.kernel.data, fan_in, generator)
            mod.bias.data.zero_()

    def _proj(self, mod: nn.Module, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        w = mod.kernel.to(dt).reshape(mod.kernel.shape[0], -1)
        y = F.linear(x, w.t(), mod.bias.to(dt).reshape(-1))
        return y.reshape(x.shape[0], x.shape[1], self.n_heads, self.d_head
                         ).transpose(1, 2)                  # [B, h, N, dh]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        B, N, d = x.shape
        q = self._proj(self.query, x) / torch.tensor(
            math.sqrt(self.d_head), dtype=dt)
        k, v = self._proj(self.key, x), self._proj(self.value, x)
        w = torch.softmax(torch.matmul(q, k.transpose(-1, -2)), -1)
        o = torch.matmul(w, v).transpose(1, 2).reshape(B, N, -1)
        wo = self.out.kernel.to(dt).reshape(-1, d)
        return F.linear(o, wo.t(), self.out.bias.to(dt))


class ViTBlock(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_ff: int,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.LayerNorm_0 = LayerNorm(d_model)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            d_model, n_heads, dtype)
        self.LayerNorm_1 = LayerNorm(d_model)
        self.Dense_0 = Dense(d_model, d_ff, dtype)
        self.Dense_1 = Dense(d_ff, d_model, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x).to(dt))
        x = x + y
        y = self.Dense_0(self.LayerNorm_1(x).to(dt))
        y = self.Dense_1(F.gelu(y, approximate="tanh"))
        return x + y


class ViT(Classifier):
    def __init__(self, input_shape: Sequence[int], num_classes: int = 10,
                 patch_size: int = 4, d_model: int = 128, n_heads: int = 4,
                 d_ff: int = 512, n_layers: int = 6,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0):
        super().__init__(input_shape, num_classes, dtype)
        H, W, C = self.input_shape
        p = patch_size
        if H % p or W % p:
            raise ValueError(
                f"input {H}x{W} not divisible by patch_size {p}")
        self.patch_embed = Conv(C, d_model, p, p, True, dtype)
        self.pos_embed = nn.Parameter(
            torch.empty(1, (H // p) * (W // p), d_model))
        for i in range(n_layers):
            self.add_module(f"ViTBlock_{i}",
                            ViTBlock(d_model, n_heads, d_ff, dtype))
        self.n_layers = n_layers
        self.LayerNorm_0 = LayerNorm(d_model)
        self.Dense_0 = Dense(d_model, num_classes, torch.float32)
        self._init(seed)

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        nn.init.normal_(self.pos_embed.data, std=0.02, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.patch_embed(x.to(self.dtype).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)                    # [B, N, D]
        x = x + self.pos_embed.to(self.dtype)
        for i in range(self.n_layers):
            x = getattr(self, f"ViTBlock_{i}")(x)
        return self.Dense_0(self.LayerNorm_0(x).mean(1))


@register_model("vit")
def _vit(num_classes: int = 10, input_shape: Sequence[int] = (32, 32, 3),
         **kw):
    return ViT(input_shape, num_classes=num_classes, **kw)


@register_model("vit-s")
def _vit_s(num_classes: int = 10, input_shape: Sequence[int] = (32, 32, 3),
           **kw):
    return ViT(input_shape, num_classes=num_classes, d_model=384, n_heads=6,
               d_ff=1536, n_layers=12, patch_size=8, **kw)
