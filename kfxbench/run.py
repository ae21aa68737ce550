"""The benchmark of the PyTorch and CUDA port (``kubeflow_tpu_torch``).

    python3 kfxbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

run from the root of a checkout on a machine with the card(s) the cell
asks for. It reads the cell from ``BENCHMARK.json``, loads its
configuration, traffic mix, limits, driver and metric readers by name
(``core/bench.py``), drives the program for ``--seconds`` after set-up,
checks the program's outputs against the plain reference, and prints one
JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``; ``checks`` comes last, each number compared with its
limit, and the same numbers end standard error.

It exits non-zero without a result when there is no CUDA card or fewer
than the cell asks for, and when a module of JAX or of the JAX package
(``kubeflow_tpu``) has been loaded. Kernel caches stay in fixed
directories of the checkout (``build/kernels`` is the port's own; Triton's
is ``kfxbench/.cache/triton``); spans go under the temporary directory.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def set_environment() -> None:
    os.environ["TRITON_CACHE_DIR"] = str(BENCH_DIR / ".cache" / "triton")
    os.environ["KFX_WORKDIR"] = os.path.join(tempfile.gettempdir(),
                                             "kfxbench")
    # transformers, where a library pulls it in, must not load flax.
    os.environ["USE_FLAX"] = "0"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def context(bench: dict, workload: str, seed: int, seconds: float,
            trace: bool, device, t0: float):
    from kfxbench.core import bench as bench_mod
    from kfxbench.core import traffic

    w = bench_mod.cell(bench, workload)
    entry = bench_mod.config_entry(bench, w["config"])
    config = bench_mod.load_json(ROOT / entry["file"])
    limits = bench_mod.load_json(BENCH_DIR / "limits" / f"{workload}.json")
    return bench_mod.RunContext(
        workload=w, config=config, traffic=traffic.load(w["traffic"]),
        limits=limits, seed=seed, seconds=seconds, trace=trace,
        device=device, tmpdir=tempfile.gettempdir(), t0=t0)


def drive(bench: dict, ctx) -> dict:
    """Run the cell's driver and read its metrics: the record the result
    line is made from."""
    from kfxbench.core import bench as bench_mod

    rec = bench_mod.driver(ctx.config["path"]).run(ctx)
    section = "per_layer" if ctx.trace else "end_to_end"
    metrics = {}
    for m in bench_mod.cell_metrics(bench, ctx.workload["name"], section):
        value = bench_mod.metric(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    rec["metrics"] = metrics
    return rec


def result_line(rec: dict, ctx, device_kind: str) -> dict:
    from kfxbench.core import compare

    out = {"correct": compare.passed(rec["checks"]) and rec["failed"] == 0
           and all(math.isfinite(m["value"])
                   for m in rec["metrics"].values()),
           "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": rec["metrics"],
           "device": {"platform": "gpu", "kind": device_kind,
                      "count": ctx.workload["chips"],
                      "memory_peak_bytes": rec["memory_peak_bytes"]}}
    tr = rec.get("trace")
    if ctx.trace and tr is not None:
        out["device"]["busy_s"] = tr["busy_s"]
        out["device"]["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["checks"] = rec["checks"]
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    set_environment()
    sys.path.insert(0, str(ROOT))
    bench_path = ROOT / "BENCHMARK.json"
    with open(bench_path) as f:
        bench = json.load(f)
    from kfxbench.core import bench as bench_mod

    chips = bench_mod.cell(bench, args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ctx = context(bench, args.workload, args.seed, args.seconds,
                  bool(args.trace), device, T0)
    rec = drive(bench, ctx)
    for key, value in rec.get("notes", {}).items():
        print(f"note {key}={value}")
    line = result_line(rec, ctx, torch.cuda.get_device_name(0))
    found = bench_mod.forbidden_modules()
    if found:
        print(f"error: the run loaded {found}", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
