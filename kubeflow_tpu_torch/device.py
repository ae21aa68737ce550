"""Device selection: explicit, never a silent fallback."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(name: Union[str, torch.device] = "cuda") -> torch.device:
    """``torch.device`` for ``name``. A CUDA device on a machine where
    ``torch.cuda.is_available()`` is false raises ``RuntimeError``: the
    port's entry points run on the card unless the caller asks for the
    CPU, and never fall back to it on their own."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "false (no GPU, or a CPU-only PyTorch build); pass device='cpu' "
            "/ --device cpu to run on the CPU")
    return dev
