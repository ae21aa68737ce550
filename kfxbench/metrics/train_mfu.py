"""train.mfu: the window's tokens/s times the benchmark's causal training
FLOPs a token (core/flops.py), over the H100's bf16 peak, in %."""

from kfxbench.core.flops import PEAK_BF16_FLOPS

NAME = "train.mfu"


def read(rec):
    train = rec.get("train")
    if not train:
        return None
    rate = train["tokens"] / rec["window_s"]
    return 100.0 * rate * train["flops_per_token"] / PEAK_BF16_FLOPS
