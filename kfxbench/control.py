"""Readings that set a cell's limits: the program's numbers over many
seeds (the lower readings), the control's (the reference in the precision
below the configuration's: float8 e4m3 products for bfloat16) and, for
training, the planted faults (the upper readings).

    python3 kfxbench/control.py --workload <name> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--seconds 45]

Prints one JSON line a seed. The benchmark's own runs never run this.

Training: every seed reads the program's three checked steps against the
float32 reference; a control seed also reads the fp8 reference and the
reference trained on half of each batch (the mean over the rest) and the
reference with the norm scales (every 1-D leaf) left undecayed, a fault
confined to the small leaves, each in the program's place. A state left
unchanged reads 1 on every gradient and change number by construction
and needs no run. Serving: every seed runs the cell (``--seconds`` of
window) and reads the program's ``logit_gap``; a control seed also reads
the gap of the tokens the fp8 reference puts first at the same
positions.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def _scales_undecayed():
    """``reference.lm.AdamW`` with the decay of every 1-D leaf undone."""
    from kfxbench.reference import lm as ref_lm

    class ScalesUndecayed(ref_lm.AdamW):
        def step(self, params, grads):
            lr = ref_lm.warmup_cosine(self.count, self.hp["learning_rate"],
                                      self.hp["warmup_steps"], self.decay)
            before = {n: p.clone() for n, p in params.items()
                      if p.dim() == 1}
            out = super().step(params, grads)
            for n, p in before.items():
                params[n].add_(p, alpha=lr * self.hp["weight_decay"])
            return out

    return ScalesUndecayed


def _worst_small(program: dict, ref: dict, n: int = 3) -> dict:
    """The leaves that set ``grad_gap_small`` and ``change_gap_small``:
    the ``n`` worst of each, with their gaps."""
    from kfxbench.core import compare

    mv = set(compare.moved(ref["raw_grad_norms"]))
    out = {}
    for key in ("grad_norms", "change_norms"):
        r, p = ref[key], program[key]
        names = [k for k in compare.below_median(r, r if key == "grad_norms"
                                                 else mv) if k in mv]
        gaps = sorted(((abs(p[k] - r[k]) / r[k], k) for k in names),
                      reverse=True)[:n]
        out[key] = [[k, g] for g, k in gaps]
    return out


def train_readings(ctx, control: bool) -> dict:
    from kfxbench.core import compare
    from kfxbench.core import bench as bench_mod

    T = bench_mod.driver("train")
    data = T.batches(ctx)
    loop = T.build(ctx)
    program = T.checked_steps(ctx, loop, data)
    del loop
    T.free()
    ref = T.reference(ctx, data)
    out = {"program": compare.train_numbers(program, ref),
           "worst_small": _worst_small(program, ref)}
    if control:
        out["fp8"] = compare.train_numbers(
            T.reference(ctx, data, "fp8"), ref)
        out["half_batch"] = compare.train_numbers(
            T.reference(ctx, data, rows=ctx.traffic["batch"] // 2), ref)
        from kfxbench.reference import lm as ref_lm

        adamw = ref_lm.AdamW
        ref_lm.AdamW = _scales_undecayed()
        try:
            out["scales_undecayed"] = compare.train_numbers(
                T.reference(ctx, data), ref)
        finally:
            ref_lm.AdamW = adamw
    return out


def serve_readings(ctx, control: bool) -> dict:
    from kfxbench.core import bench as bench_mod

    rec = bench_mod.driver("serve").run(
        ctx, precision="fp8" if control else "f32")
    out = {"program": {"logit_gap": rec["checks"]["logit_gap"]["value"]},
           "notes": rec["notes"],
           "metrics": {n: bench_mod.metric(n).read(rec) for n in (
               "serve_tokens_per_s", "engine.ttft_p95_ms", "tpot_p95_ms",
               "setup_s")}}
    if control:
        out["fp8"] = {"logit_gap": rec["control_gap"]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=45.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from kfxbench import run as harness

    harness.set_environment()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    device = torch.device("cuda", 0)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",") if s]
    seeds += sorted(control - set(seeds))
    for seed in seeds:
        t0 = time.perf_counter()
        ctx = harness.context(bench, args.workload, seed, args.seconds,
                              False, device, t0)
        reader = train_readings if ctx.config["path"] == "train" \
            else serve_readings
        out = reader(ctx, seed in control)
        out.update(seed=seed, seconds=time.perf_counter() - t0)
        print(json.dumps(out, default=str), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
