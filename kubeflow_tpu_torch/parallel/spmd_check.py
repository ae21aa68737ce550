"""Cross-process SPMD check — port of
``kubeflow_tpu/parallel/spmd_check.py``.

The same ``LMTrainLoop`` on the same global batch, run

  (a) at world 1, one process owning one device, and
  (b) as N processes, one rank each, over a mesh of the variant's plan,
      rendezvoused through ``runners/jax_runner.initialize_distributed``,

must produce per-step losses that agree to ``RTOL``: the only legitimate
difference is the order of the cross-rank reductions.

Variants (the reference's; at 2 ranks):
  * ``tp_fsdp`` — tp=2 (fsdp on, over dp=N/2): the tensor-parallel
    all-reduces and the vocab-parallel loss cross the ranks;
  * ``cp`` — cp=2, tp=N/2: the ring attention's K/V transfers cross;
  * ``ep`` — MoE with as many experts as data ranks, over dp=N (dp=N/2
    with tp=2 from 4 ranks; the reference's rule gives dp=1 at 2 ranks,
    where no token would move): the token all-to-alls cross;
  * ``pp`` — pp=2 (tp=2 from 4 ranks), PipelinedLMTrainLoop: every
    activation and its grad crosses the stage boundary.

Data contract: the global batch is the concatenation of the plan's dp
disjoint shards (``LMDataset.batches(shard_index=d, num_shards=dp)``);
each rank feeds the shard of its "data" coordinate; the world-1 run
concatenates all of them.

The reference launches its gang through ``runtime/gang.py``, which the
port does not have yet (ROADMAP.md Queue A 8): ``run_ranks`` starts the
ranks with ``subprocess``, a free port from ``utils/net.py`` and the env
that ``initialize_distributed`` reads (``KFX_NUM_PROCESSES``,
``KFX_PROCESS_ID``, ``KFX_COORDINATOR_ADDRESS``).

    python -m kubeflow_tpu_torch.parallel.spmd_check --device cpu

runs every variant at 2 ranks against world 1 and prints one line each.
``check_attention_sharding`` (inside a rank) checks the per-rank shapes
of q/k/v, the attention mix and the residual stream: none may be
replicated beyond what the plan allows.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

CHECK_STEPS = 4
GLOBAL_BATCH = 16
VOCAB = 128
SEQ = 32
# Per-step loss agreement bound: f32 loss and grads; the only divergence
# source is the reduction order of the cross-rank collectives.
RTOL = 2e-3

VARIANTS = ("tp_fsdp", "cp", "ep", "pp")

# Model configs: the reference's tiny one, and the base preset's widths
# at 4 layers and S 2048 in f32 (the card's run: flash on FMA).
CONFIGS = {
    "tiny": (dict(vocab_size=VOCAB, d_model=32, n_heads=4, head_dim=8,
                  n_layers=2, d_ff=64, max_seq_len=SEQ, dtype="float32"),
             GLOBAL_BATCH),
    "base-l4": (dict(vocab_size=32_000, d_model=1024, n_heads=16,
                     head_dim=64, n_layers=4, d_ff=4096, max_seq_len=2048,
                     dtype="float32"), 4),
}


def variant_plan(variant: str, n: int) -> Tuple[dict, dict]:
    """(make_mesh keywords, config overrides) of ``variant`` at n ranks."""
    if variant == "tp_fsdp":
        return dict(tp=2 if n % 2 == 0 else 1, fsdp=True), {}
    if variant == "cp":
        return dict(tp=max(n // 2, 1), cp=2, fsdp=True), {}
    if variant == "ep":
        tp = 2 if n % 4 == 0 else 1
        return dict(tp=tp, fsdp=True), {"n_experts": n // tp}
    if variant == "pp":
        return dict(pp=2, tp=2 if n % 4 == 0 else 1, fsdp=True), {}
    raise ValueError(f"unknown variant {variant!r}; have {VARIANTS}")


def _dp(variant: str, n: int) -> int:
    from .mesh import _factor

    kw, _ = variant_plan(variant, n)
    return _factor(n, kw.get("tp"), kw.get("pp"), kw.get("cp"))[1]


def build_loop(variant: str, n: int, device, config: str = "tiny",
               like: Optional[int] = None):
    """The variant's loop over ``n`` ranks (n=1: the world-1 loop of the
    model the variant runs over ``like`` ranks)."""
    from ..models.transformer import TransformerConfig
    from .lm_train import LMHyperParams, LMTrainLoop
    from .mesh import make_mesh

    kw, _ = variant_plan(variant, n)
    _, over = variant_plan(variant, like or n)
    base, _ = CONFIGS[config]
    hp = LMHyperParams(total_steps=CHECK_STEPS, warmup_steps=1)
    if n == 1:
        return LMTrainLoop(TransformerConfig(**base, **over), hp, device)
    mesh, plan = make_mesh(n, device_type=device.type, **kw)
    cfg = TransformerConfig(**base, **over, cp=plan.cp)
    if plan.pp > 1:
        from .pipeline import PipelinedLMTrainLoop

        return PipelinedLMTrainLoop(cfg, hp, device, mesh, plan)
    return LMTrainLoop(cfg, hp, device, mesh, plan)


def run_losses(variant: str, n: int, device, config: str = "tiny",
               like: Optional[int] = None) -> List[float]:
    """Train CHECK_STEPS steps of ``variant`` over n ranks (this process
    is one of them; n=1: alone, the model and global batch of the run
    over ``like`` ranks) and return the per-step losses. The global
    batch is the concatenation of the dp shards of that run's plan."""
    import numpy as np

    from ..data.lm import LMDataset

    base, batch = CONFIGS[config]
    loop = build_loop(variant, n, device, config, like)
    dp = _dp(variant, like or n)
    ds = LMDataset(vocab_size=base["vocab_size"],
                   seq_len=base["max_seq_len"])
    if n == 1:
        mine = list(range(dp))
    else:
        mine = [loop.mesh.index("data") * dp // loop.plan.dp + i
                for i in range(dp // loop.plan.dp)]
    its = {d: ds.batches(batch, shard_index=d, num_shards=dp) for d in mine}
    loop.init_state()
    losses = []
    for _ in range(CHECK_STEPS):
        rows = np.concatenate([next(its[d]) for d in mine], axis=0)
        losses.append(loop.train_step(rows)[0])
    return losses


def assert_close(single: List[float], multi: List[float],
                 rtol: float = RTOL) -> None:
    if len(single) != len(multi):
        raise AssertionError(f"step counts differ: {single} vs {multi}")
    for i, (a, b) in enumerate(zip(single, multi)):
        if abs(a - b) > rtol * max(1.0, abs(a)):
            raise AssertionError(
                f"step {i}: world-1 loss {a} vs cross-process {b} "
                f"(|delta|={abs(a - b):.3e} > rtol={rtol}); "
                f"full: {single} vs {multi}")


def rank_env(n: int, rank: int, coordinator: str) -> Dict[str, str]:
    """The rendezvous env ``initialize_distributed`` reads, with the repo
    on PYTHONPATH."""
    from ..runtime.rendezvous import (ENV_COORDINATOR, ENV_NUM_PROCESSES,
                                      ENV_PROCESS_ID)

    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    prior = env.get("PYTHONPATH")
    env["PYTHONPATH"] = repo + (os.pathsep + prior if prior else "")
    env.update({ENV_NUM_PROCESSES: str(n), ENV_PROCESS_ID: str(rank),
                ENV_COORDINATOR: coordinator})
    return env


def run_ranks(argv: Sequence[str], n: int, timeout: float = 600.0,
              env: Optional[Dict[str, str]] = None, cwd: Optional[str] = None,
              check: bool = True) -> List[Tuple[int, str, str]]:
    """Start ``argv`` (a command) as ranks 0..n-1 of one process group on
    a fresh loopback port and wait for all; returns each rank's (exit
    code, stdout, stderr). With ``check``, raises RuntimeError, with
    every rank's output, if a rank fails (the others are then killed);
    a rank still running at ``timeout`` fails either way."""
    from ..utils.net import free_port

    coord = f"127.0.0.1:{free_port()}"
    procs = []
    for r in range(n):
        e = rank_env(n, r, coord)
        e.update(env or {})
        procs.append(subprocess.Popen(
            list(argv), env=e, cwd=cwd, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    deadline = time.time() + timeout
    outs: List[Tuple[int, str, str]] = []
    failed = False
    try:
        for p in procs:
            try:
                out, err = p.communicate(
                    timeout=max(deadline - time.time(), 1.0))
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                err += f"\n(killed after {timeout} s)"
                failed = True
            outs.append((p.returncode, out, err))
            if p.returncode != 0 and check:
                failed = True
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        logs = "\n".join(f"--- rank {r} rc={rc}\n{o}\n{e}"
                         for r, (rc, o, e) in enumerate(outs))
        raise RuntimeError(f"ranks of {' '.join(argv)} failed:\n{logs}")
    return outs


def cross_process_losses(variant: str, workdir: str, *, n_processes: int = 2,
                         device: str = "cpu", config: str = "tiny",
                         timeout: float = 600.0) -> List[float]:
    """``run_losses(variant)`` over ``n_processes`` ranks; returns rank
    0's per-step losses."""
    out = os.path.join(workdir, f"losses-{variant}.json")
    # Ranks on the CPU share its cores: one intra-op thread each.
    env = {"OMP_NUM_THREADS": "1"} if device == "cpu" else {}
    run_ranks([sys.executable, "-m", "kubeflow_tpu_torch.parallel.spmd_check",
               "--worker", "--variant", variant, "--out", out,
               "--device", device, "--config", config], n_processes,
              timeout, env=env)
    with open(out) as f:
        return json.load(f)["losses"]


def check(variant: str, workdir: str, *, n_processes: int = 2,
          device: str = "cpu", config: str = "tiny") -> Dict[str, list]:
    """The cross-process run against the world-1 run (in this process) on
    the same global batch."""
    import torch

    from ..device import resolve_device

    multi = cross_process_losses(variant, workdir, n_processes=n_processes,
                                 device=device, config=config)
    single = run_losses(variant, 1, resolve_device(device), config,
                        like=n_processes)
    if device == "cuda":
        torch.cuda.empty_cache()
    assert_close(single, multi)
    return {"single": single, "multi": multi}


def check_attention_sharding(mesh, plan, device, sp: bool = False,
                             batch: int = 8, seq: int = 32) -> dict:
    """Run a sharded one-layer model's forward on this rank and check
    that no activation is replicated beyond the plan: q/k/v and the
    attention mix hold 1/(dp*tp*cp) of their global size (batch over
    "data", heads over "model", S over "ctx"), and the residual stream
    1/(dp*cp), 1/(dp*tp) under sp. Returns {name: {"shape", "global",
    "shard_fraction"}}; raises AssertionError on a replicated one."""
    import math

    import torch

    from ..models import transformer as TR

    heads = 2 * plan.tp
    cfg = TR.TransformerConfig(vocab_size=64, d_model=32, n_heads=heads,
                               head_dim=8, n_layers=1, d_ff=64,
                               max_seq_len=seq, cp=plan.cp, sp=sp,
                               dtype="float32")
    gen = torch.Generator(device=device).manual_seed(0)
    model = TR.TransformerLM(cfg, device=device, generator=gen)
    model.shard(mesh, plan)
    tokens = torch.arange(batch * seq, device=device).reshape(
        batch, seq) % cfg.vocab_size
    tokens = tokens.chunk(plan.dp, 0)[mesh.index("data")]
    tokens = tokens.chunk(plan.cp, 1)[mesh.index("ctx")]
    shapes: Dict[str, tuple] = {}
    with torch.no_grad(), TR.activation_probe(
            lambda name, x: shapes.setdefault(name, tuple(x.shape))):
        model(tokens)
    head = (batch, seq, heads, cfg.head_dim)
    want = {"attn_q": head, "attn_k": head, "attn_v": head,
            "attn_mix": head, "residual": (batch, seq, cfg.d_model)}
    ways = {n: plan.dp * plan.tp * plan.cp for n in want}
    ways["residual"] = plan.dp * plan.cp * (plan.tp if cfg.sp else 1)
    report, problems = {}, []
    for name, glob in want.items():
        got = shapes.get(name)
        if got is None:
            problems.append(f"{name}: not seen")
            continue
        frac = math.prod(got) / math.prod(glob)
        report[name] = {"shape": list(got), "global": list(glob),
                        "shard_fraction": frac}
        if frac * ways[name] > 1.0 + 1e-6:
            problems.append(
                f"{name} {got} of {glob}: holds {frac:.3f} of the global "
                f"tensor, replicated beyond the 1/{ways[name]} the "
                f"dp{plan.dp}/tp{plan.tp}/cp{plan.cp} layout promises")
    if problems:
        raise AssertionError("attention activation replication check "
                             "failed:\n  " + "\n  ".join(problems))
    return report


def _worker(args) -> int:
    from ..device import resolve_device
    from ..runners.jax_runner import initialize_distributed
    from ..runtime.rendezvous import rank_world

    device = initialize_distributed(resolve_device(args.device))
    rank, world = rank_world()
    losses = run_losses(args.variant, world, device, args.config)
    print(f"spmd_check_done rank={rank} world={world} losses={losses}",
          flush=True)
    if rank == 0:
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"variant": args.variant, "losses": losses}, f)
        os.replace(tmp, args.out)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="cross-process SPMD check")
    p.add_argument("--worker", action="store_true",
                   help="run as one rank (the launcher passes this)")
    p.add_argument("--variant", choices=VARIANTS)
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--config", default="tiny", choices=sorted(CONFIGS))
    args = p.parse_args(argv)
    if args.worker:
        return _worker(args)
    import tempfile

    with tempfile.TemporaryDirectory(prefix="kfx-spmd-") as workdir:
        for variant in VARIANTS:
            t0 = time.time()
            got = check(variant, workdir, device=args.device,
                        config=args.config)
            print(f"spmd_check variant={variant} processes=2 "
                  f"config={args.config} seconds={time.time() - t0:.1f} "
                  f"world1={got['single']} multi={got['multi']} ok",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
