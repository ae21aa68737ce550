"""Drives the port's training path: ``LMTrainLoop.train_step`` of
``kubeflow_tpu_torch/parallel/lm_train.py``, the call
``runners/lm_runner.py`` makes once a step.

Set-up builds one loop from the benchmark's seeded weights and runs its
first ``CHECK_STEPS`` steps through ``train_step`` on the mix's first
batches, reading what the comparison needs: each step's loss, every
leaf's first gradient as AdamW got it (its first moment after one step,
over 1 - b1), and every leaf's change after the last checked step (the
weights drawn again from the seed, before the next step moves them).
The same loop then runs the window: steps back to back, cycling the
mix's batches, one host sync a step (the loop's own), until
``--seconds`` have passed; the window ends on that step's sync.

After the window the loop is freed and the reference trains the same
weights on the same batches for ``CHECK_STEPS`` steps in float32.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from kfxbench.core import bench, compare, flops, traffic, weights
from kfxbench.core.devtrace import DeviceTrace, short
from kfxbench.reference import lm as ref_lm

CHECK_STEPS = 3
# Steps the profiler covers at the end of a traced window.
TRACE_STEPS = 4


def model_config(cfg: dict, seq_len: int):
    from kubeflow_tpu_torch.models.transformer import TransformerConfig

    port = cfg["port"]
    return TransformerConfig(
        vocab_size=cfg["vocab_size"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"], head_dim=weights.head_dim(cfg),
        n_layers=cfg["num_hidden_layers"], d_ff=cfg["intermediate_size"],
        max_seq_len=seq_len, attn_impl=port["attn_impl"],
        dtype=port["dtype"], param_dtype=port["param_dtype"])


def hyper(cfg: dict) -> Dict[str, float]:
    port = cfg["port"]
    return {k: port[k] for k in ("learning_rate", "warmup_steps",
                                 "total_steps", "weight_decay", "grad_clip")}


def batches(ctx) -> List[np.ndarray]:
    cfg = ctx.config
    mix = ctx.traffic
    return bench.generator(mix["kind"]).batches(
        mix, cfg["vocab_size"], cfg["eos_token_id"], ctx.seed)


def build(ctx):
    """The program's loop holding the seeded weights."""
    from kubeflow_tpu_torch.parallel.lm_train import (LMHyperParams,
                                                      LMTrainLoop)

    hp = hyper(ctx.config)
    loop = LMTrainLoop(model_config(ctx.config, ctx.traffic["seq_len"]),
                       LMHyperParams(seed=traffic.seed64(ctx.seed), **hp),
                       device=ctx.device)
    w = weights.make(ctx.config, ctx.seed, torch.float32, ctx.device)
    loop.init_state(state_dict=w)
    return loop


def checked_steps(ctx, loop, data: List[np.ndarray]) -> dict:
    """Run the first ``CHECK_STEPS`` steps and read the program's side of
    the comparison."""
    names = [n for n, _ in loop.model.named_parameters()]
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    for i in range(CHECK_STEPS):
        loss, _ = loop.train_step(data[i])
        losses.append(loss)
        if i == 0:
            b1 = loop.opt.b1
            norms = torch._foreach_norm(loop.opt.mu)
            grad_norms = {n: float(v) / (1 - b1)
                          for n, v in zip(names, norms)}
    w0 = weights.make(ctx.config, ctx.seed, torch.float32, ctx.device)
    with torch.no_grad():
        change = {n: float((p - w0[n]).norm())
                  for n, p in loop.model.named_parameters()}
    del w0
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


def reference(ctx, data: List[np.ndarray], precision: str = "f32",
              rows=None) -> dict:
    """The reference's ``CHECK_STEPS`` steps from the same seeded weights
    and batches."""
    ref_lm.no_tf32()
    w = weights.make(ctx.config, ctx.seed, torch.float32, ctx.device)
    toks = [torch.from_numpy(b).to(ctx.device) for b in data[:CHECK_STEPS]]
    out = ref_lm.train(w, toks, hyper(ctx.config), ref_lm.Matmul(precision),
                       rows=rows)
    del w
    return out


def free() -> None:
    """Return what unreferenced objects held on the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(ctx) -> dict:
    data = batches(ctx)
    loop = build(ctx)
    t_built = time.perf_counter()
    program = checked_steps(ctx, loop, data)
    B, S = ctx.traffic["batch"], ctx.traffic["seq_len"]
    cuda = ctx.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t_open = time.perf_counter()
    setup_s = t_open - ctx.t0
    steps = bad = 0
    tracer = DeviceTrace(ctx.tmpdir) if ctx.trace and cuda else None
    i = CHECK_STEPS
    while True:
        now = time.perf_counter() - t_open
        if now >= ctx.seconds:
            break
        if tracer is not None and tracer.t_start == 0.0 and steps and \
                now + (now / steps) * TRACE_STEPS >= ctx.seconds:
            tracer.start()
        loss, _ = loop.train_step(data[i % len(data)])
        i += 1
        steps += 1
        bad += not math.isfinite(loss)
    window_s = time.perf_counter() - t_open
    if tracer is not None and tracer.t_start:
        tracer.stop()
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    del loop
    free()
    t_ref = time.perf_counter()
    ref = reference(ctx, data)
    numbers = compare.train_numbers(program, ref)
    summary = tracer.summary() if tracer is not None and tracer.t_start \
        else None
    notes = {"build_s": t_built - ctx.t0, "checked_steps_s": t_open - t_built,
             "window_steps": steps, "step_s": window_s / max(steps, 1),
             "losses": program["losses"], "reference_losses": ref["losses"],
             "reference_s": time.perf_counter() - t_ref}
    if summary is not None:
        notes["port_kernels"] = {
            short(n): [summary["counts"][n], s]
            for n, s in summary["by_name"].items()
            if short(n).startswith("kfx::")}
    return {
        "notes": notes,
        "setup_s": setup_s, "window_s": window_s,
        "attempted": steps, "failed": bad,
        "checks": compare.checks(numbers, ctx.limits),
        "memory_peak_bytes": peak,
        "trace": summary,
        "train": {"tokens": steps * B * S, "batch": B, "seq_len": S,
                  "flops_per_token": flops.train_flops_per_token(
                      ctx.config, S),
                  "heads": ctx.config["num_attention_heads"],
                  "head_dim": weights.head_dim(ctx.config),
                  "layers": ctx.config["num_hidden_layers"]},
    }
