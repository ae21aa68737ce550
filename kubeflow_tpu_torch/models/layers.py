"""The layers of the classifier zoo, each computing what its flax.linen
counterpart computes (the reference's models are flax modules):

  Dense      kernel [in, out] (flax's layout) + bias, in the compute dtype
  Conv       weight [cout, cin, kh, kw] (PyTorch's layout; the converter
             transposes flax's [kh, kw, cin, cout]) + optional bias, with
             flax's ``padding="SAME"``: total = max((ceil(n/s) - 1) * s +
             k - n, 0), lo = total // 2, hi = the rest. PyTorch's
             symmetric ``padding=k // 2`` differs for stride 2 on an even
             input (the 3x3/2 block conv pads (0, 1), the 7x7/2 stem on
             224 pads (2, 3)), so uneven pads are explicit.
  BatchNorm  statistics in f32 as flax's "fast variance" (E[x^2] - E[x]^2,
             clipped at 0); the running stats move by ``ra = m * ra +
             (1 - m) * batch`` with the BIASED batch variance (PyTorch's
             BatchNorm2d uses the unbiased one); f32 output
  LayerNorm  the same statistics over the last axis, eps 1e-6; f32 output

Activations run NCHW in ``channels_last`` memory between convs. Params are
f32; each layer casts to its ``dtype`` where flax promotes to it. Every
layer initialises from an explicit ``torch.Generator`` with flax's
initializers (lecun-normal kernels, zero biases, unit norm scales), so a
seed gives the same weights on every device.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


_ERF2 = math.erf(2 / math.sqrt(2))


@torch.no_grad()
def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """flax's default kernel init: variance_scaling(1, "fan_in",
    "truncated_normal"), a normal truncated at two deviations, rescaled so
    its variance is 1 / fan_in. Drawn as jax draws it, by the inverse CDF
    of a uniform over (erf(-2/sqrt2), erf(2/sqrt2)): one pass, where
    ``nn.init.trunc_normal_`` resamples until every value is in range."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t.uniform_(-_ERF2, _ERF2, generator=generator).erfinv_()
    t.mul_(std * math.sqrt(2)).clamp_(-2 * std, 2 * std)


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA ``padding="SAME"`` along one axis of length ``n``."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, s: int, value: float = 0.0
              ) -> Tuple[torch.Tensor, int]:
    """(x padded for SAME, the padding left for the op itself): an even
    symmetric pad rides the op's own ``padding`` argument; an uneven one
    is applied here."""
    (ht, hb), (wl, wr) = (same_pads(x.shape[2], k, s),
                          same_pads(x.shape[3], k, s))
    if ht == hb == wl == wr:
        return x, ht
    return F.pad(x, (wl, wr, ht, hb), value=value), 0


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(d_in, d_out))
        self.bias = nn.Parameter(torch.empty(d_out))

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel.data, self.kernel.shape[0], generator)
        self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.kernel.to(dt).t(), self.bias.to(dt))


class Conv(nn.Module):
    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1,
                 use_bias: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype, self.k, self.stride = dtype, kernel, stride
        self.weight = nn.Parameter(torch.empty(c_out, c_in, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(c_out)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        c_out, c_in, kh, kw = self.weight.shape
        lecun_normal_(self.weight.data, c_in * kh * kw, generator)
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x, pad = _pad_same(x.to(dt), self.k, self.stride)
        return F.conv2d(x, self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt),
                        stride=self.stride, padding=pad)


def max_pool_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """``nn.max_pool(x, (k, k), (s, s), padding="SAME")``: pads with -inf."""
    x, pad = _pad_same(x, k, s, value=-math.inf)
    return F.max_pool2d(x, k, s, padding=pad)


def _f32_stats(x32: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    mean = x32.mean(dims)
    var = torch.clamp((x32 * x32).mean(dims) - mean * mean, min=0.0)
    return mean, var


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum, epsilon, dtype=float32)`` over NCHW
    channels. Running stats are buffers ``mean`` and ``var``."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5, zero_scale: bool = False):
        super().__init__()
        self.momentum, self.eps, self.zero_scale = momentum, eps, zero_scale
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        self.scale.data.fill_(0.0 if self.zero_scale else 1.0)
        self.bias.data.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x32 = x.float()
        if train:
            mean, var = _f32_stats(x32, (0, 2, 3))
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(m).add_(mean, alpha=1 - m)
                self.var.mul_(m).add_(var, alpha=1 - m)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((x32 - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)`` over the last axis."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        self.scale.data.fill_(1.0)
        self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean, var = _f32_stats(x32, -1)
        mul = torch.rsqrt(var + self.eps)[..., None] * self.scale
        return (x32 - mean[..., None]) * mul + self.bias


class Classifier(nn.Module):
    """Base of the zoo: ``forward(x, train=False)`` takes NHWC float images
    ``[B, H, W, C]`` (the reference's data and ``:predict`` instances) and
    returns f32 logits ``[B, num_classes]``.

    Unlike a flax module, a PyTorch module owns its params, so it is built
    for one ``input_shape`` (H, W, C): it sizes the first Dense of the MLP
    and CNN, ViT's positions, and selects the ResNet stem."""

    def __init__(self, input_shape: Sequence[int], num_classes: int,
                 dtype: torch.dtype):
        super().__init__()
        self.input_shape = tuple(int(d) for d in input_shape)
        self.num_classes = num_classes
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Initialise every param from ``generator`` (on the CPU), in
        module order."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def _init(self, seed: int) -> None:
        self.reset_parameters(torch.Generator().manual_seed(seed))
