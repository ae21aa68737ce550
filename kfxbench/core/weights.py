"""Seeded weights of a decoder LM configuration, made on the device.

The benchmark, not the program, makes the weights: one flat buffer drawn
from ``--seed`` with a ``torch.Generator`` on the device in a few large
calls, in the dtype the cell runs them in, then scaled leaf by leaf. The
leaves are views of that buffer, named as the port's ``state_dict`` names
them, so the same tensors go to the program and to the reference. The
same seed on the same device and PyTorch gives the same bits, so a
reference that runs after the program can draw them again.

Kernels are normal with std 1/sqrt(fan_in), the embedding normal with
std 1/sqrt(d_model), norm scales 1 + 0.1 * normal (not all ones, so that
a program that drops a scale reads wrong).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# Elements drawn per generator call.
DRAW_CHUNK = 1 << 30


def head_dim(cfg: dict) -> int:
    """The published ``head_dim``, else hidden_size / heads (Llama's
    convention)."""
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg[
        "num_attention_heads"]


def layout(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """[(name, shape, kind, std)] of every leaf of the model ``cfg``
    (``hidden_size``, ``num_hidden_layers``, ``num_attention_heads``,
    ``intermediate_size``, ``vocab_size``), in the port's
    parameter order. ``kind`` is "normal" or "norm"."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    H, D = cfg["num_attention_heads"], head_dim(cfg)
    F, V = cfg["intermediate_size"], cfg["vocab_size"]
    out = [("embed.embedding", (V, d), "normal", 1.0 / math.sqrt(d))]
    for i in range(L):
        p = f"layers.{i}."
        out += [
            (p + "ln1.scale", (d,), "norm", 0.1),
            (p + "attn.query.kernel", (d, H, D), "normal", d ** -0.5),
            (p + "attn.key.kernel", (d, H, D), "normal", d ** -0.5),
            (p + "attn.value.kernel", (d, H, D), "normal", d ** -0.5),
            (p + "attn.out.kernel", (H, D, d), "normal", (H * D) ** -0.5),
            (p + "ln2.scale", (d,), "norm", 0.1),
            (p + "mlp.wi.kernel", (d, 2 * F), "normal", d ** -0.5),
            (p + "mlp.wo.kernel", (F, d), "normal", F ** -0.5),
        ]
    out += [("ln_f.scale", (d,), "norm", 0.1),
            ("lm_head.kernel", (d, V), "normal", d ** -0.5)]
    return out


def n_params(cfg: dict) -> int:
    return sum(math.prod(s) for _, s, _, _ in layout(cfg))


def make(cfg: dict, seed: int, dtype: torch.dtype,
         device: torch.device) -> Dict[str, torch.Tensor]:
    """{name: tensor}: views of one flat ``dtype`` buffer on ``device``
    drawn from ``seed``."""
    leaves = layout(cfg)
    total = sum(math.prod(s) for _, s, _, _ in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    flat = torch.empty(total, dtype=dtype, device=device)
    with torch.no_grad():
        for lo in range(0, total, DRAW_CHUNK):
            flat[lo:lo + DRAW_CHUNK].normal_(generator=gen)
        out, at = {}, 0
        for name, shape, kind, std in leaves:
            n = math.prod(shape)
            w = flat[at:at + n]
            w.mul_(std)
            if kind == "norm":
                w.add_(1.0)
            out[name] = w.view(shape)
            at += n
    return out
