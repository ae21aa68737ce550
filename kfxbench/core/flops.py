"""The benchmark's own operation and byte counts, and the card's peaks.

Counts are of the work the model needs, 2 * m * n * k a matrix product,
from the configuration's published sizes (``hidden_size``,
``num_hidden_layers``, ``num_attention_heads``, ``intermediate_size``,
``vocab_size``):

* attention is causal: query i scores keys 0..i, so a sequence of S
  tokens scores S (S + 1) / 2 pairs, not S**2 (``utils/flops.py`` of the
  port counts the full square);
* training is forward plus backward at twice the forward; recomputation
  is not counted;
* serving counts each token's forward at its own position, and the head
  once for each token produced.
"""

from __future__ import annotations

from typing import Dict

from .weights import head_dim

# NVIDIA H100 SXM data sheet, dense (no sparsity).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def _sizes(cfg: dict):
    return (cfg["hidden_size"], cfg["num_hidden_layers"],
            cfg["num_attention_heads"] * head_dim(cfg),
            cfg["intermediate_size"], cfg["vocab_size"])


def body_matmul_flops(cfg: dict) -> float:
    """Forward FLOPs a token in the layers' projections and MLP."""
    d, L, hh, F, _ = _sizes(cfg)
    return 2.0 * L * (3 * d * hh + hh * d + 3 * d * F)


def head_flops(cfg: dict) -> float:
    d, _, _, _, V = _sizes(cfg)
    return 2.0 * d * V


def attention_flops_at(cfg: dict, n_keys: float) -> float:
    """Forward attention FLOPs of one query over ``n_keys`` keys, all
    layers (q.k and probs.v)."""
    _, L, hh, _, _ = _sizes(cfg)
    return 4.0 * L * hh * n_keys


def train_flops_per_token(cfg: dict, seq_len: int,
                          causal: bool = True) -> float:
    """Forward + backward FLOPs a trained token in a sequence of
    ``seq_len``; ``causal=False`` gives the port's full-square count."""
    keys = (seq_len + 1) / 2.0 if causal else float(seq_len)
    fwd = body_matmul_flops(cfg) + attention_flops_at(cfg, keys) \
        + head_flops(cfg)
    return 3.0 * fwd


def prompt_flops(cfg: dict, n: int) -> float:
    """Forward FLOPs of a prompt of ``n`` tokens at positions 0..n-1, with
    the head at its last position."""
    return (n * body_matmul_flops(cfg)
            + attention_flops_at(cfg, n * (n + 1) / 2.0) + head_flops(cfg))


def decode_flops(cfg: dict, position: int) -> float:
    """Forward FLOPs of one token at ``position`` (it attends position+1
    keys), with the head."""
    return (body_matmul_flops(cfg) + attention_flops_at(cfg, position + 1)
            + head_flops(cfg))


def kv_bytes_per_token(cfg: dict, dtype_bytes: int = 2) -> int:
    """Bytes of K and V a cached token holds, over all layers."""
    _, L, hh, _, _ = _sizes(cfg)
    return 2 * L * hh * dtype_bytes


def flash_least_seconds(batch: int, seq_len: int, heads: int, dim: int,
                        dtype_bytes: int = 2) -> Dict[str, float]:
    """The least time of one causal attention call's forward and backward
    at [batch, seq_len, heads, dim]: the larger of its FLOPs over the bf16
    peak and its bytes over the HBM peak. FLOPs: the forward's two
    products and the backward's four (dV, dP, dQ, dK), each over the
    S (S + 1) / 2 causal pairs. Bytes: q, k, v read and o written
    forward; q, k, v, o, dO read and dQ, dK, dV written backward, each
    once, with the f32 row statistics (lse, delta) read and written once."""
    pairs = seq_len * (seq_len + 1) / 2.0
    one = 2.0 * batch * heads * dim * pairs
    flops = 6.0 * one
    tensor = batch * seq_len * heads * dim * dtype_bytes
    rows = batch * seq_len * heads * 4
    nbytes = 4 * tensor + rows + 8 * tensor + 2 * rows
    t_flops = flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_HBM_BYTES_PER_S
    return {"flops": flops, "bytes": float(nbytes),
            "seconds": max(t_flops, t_bytes),
            "bound": "compute" if t_flops >= t_bytes else "memory"}
