"""Model-FLOPs accounting for MFU reporting (the reference's
``kubeflow_tpu/utils/flops.py`` convention, against an NVIDIA peak).

Convention (PaLM appendix B / scaling-book): count the matmul FLOPs the
model *requires* — 2·m·n·k per matmul, attention scored over the full
sequence (no causal discount), backward = 2x forward, and remat
recomputation NOT counted (MFU penalises remat rather than crediting it).
"""

from __future__ import annotations

from typing import Optional

# Peak dense bf16 FLOP/s per card (NVIDIA data sheets, SXM parts, no
# sparsity). Keys are matched against torch.cuda.get_device_name().
PEAK_FLOPS = {
    "h100": 989e12,
}


def transformer_fwd_flops_per_token(cfg, seq_len: int) -> float:
    """Forward matmul FLOPs per token for models.transformer.TransformerLM."""
    d, hh = cfg.d_model, cfg.n_heads * cfg.head_dim
    per_layer = (
        2 * d * 3 * hh          # qkv projections
        + 2 * hh * d            # output projection
        + 2 * 2 * seq_len * hh  # scores (q·k) + mixing (probs·v)
    )
    if cfg.n_experts > 0:
        per_layer += 2 * d * cfg.n_experts                    # router gate
        per_layer += cfg.expert_top_k * 6 * d * cfg.d_ff      # SwiGLU experts
    else:
        per_layer += 6 * d * cfg.d_ff                         # SwiGLU wi+wo
    return cfg.n_layers * per_layer + 2 * d * cfg.vocab_size  # + lm head


def transformer_train_flops_per_token(cfg, seq_len: int) -> float:
    """fwd + bwd (2x fwd) matmul FLOPs per trained token."""
    return 3.0 * transformer_fwd_flops_per_token(cfg, seq_len)


def peak_flops_per_card(device_name: Optional[str] = None) -> float:
    """Peak dense bf16 FLOP/s of the card named ``device_name`` (default:
    ``torch.cuda.get_device_name(0)``). Raises for a card without a
    known peak rather than guessing one."""
    if device_name is None:
        import torch

        device_name = torch.cuda.get_device_name(0)
    name = device_name.lower().replace(" ", "")
    for key, peak in PEAK_FLOPS.items():
        if key in name:
            return peak
    raise ValueError(f"no peak FLOP/s known for device {device_name!r} "
                     f"(have {sorted(PEAK_FLOPS)})")


def mfu(tokens_per_s: float, flops_per_token: float,
        n_cards: int = 1, peak: Optional[float] = None) -> float:
    peak = peak or peak_flops_per_card()
    return tokens_per_s * flops_per_token / (n_cards * peak)
