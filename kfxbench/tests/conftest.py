"""Shared pieces of the benchmark's CPU tests: the repository on the
path, and contexts that run a cell's driver at a tiny size on the CPU.

    python -m pytest kfxbench/tests
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_MODEL = {"hidden_size": 128, "num_hidden_layers": 2,
              "num_attention_heads": 2, "num_key_value_heads": 2,
              "intermediate_size": 256, "vocab_size": 512,
              "eos_token_id": 511}


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny_context(workload: str, seed: int = 12345678901,
                 seconds: float = 2.0, trace: bool = False):
    """The cell's context with its model, engine and traffic cut to a size
    the CPU runs in seconds; everything else as the cell has it."""
    import torch

    from kfxbench import run as harness

    harness.set_environment()
    ctx = harness.context(bench(), workload, seed, seconds, trace,
                          torch.device("cpu"), time.perf_counter())
    if ctx.config["path"] == "train":
        ctx.config = dict(ctx.config, **TINY_MODEL)
        ctx.traffic = dict(ctx.traffic, batch=2, seq_len=128,
                           pool_batches=5)
        return ctx
    engine = dict(ctx.config["port"]["engine"], n_slots=4, kv_pages=64)
    ctx.config = dict(ctx.config, **TINY_MODEL, max_position_embeddings=256,
                      port=dict(ctx.config["port"], engine=engine))
    mix = dict(ctx.traffic, clients=4,
               user=dict(median=24, sigma=0.6, min=8, max=100),
               output=dict(median=6, sigma=0.5, min=2, max=12))
    if mix.get("system"):
        mix["system"] = dict(mix["system"], tokens=48)
        mix["context_max"] = 200
    else:
        mix["context_max"] = 256
    ctx.traffic = mix
    return ctx
