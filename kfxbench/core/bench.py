"""What the harness finds by name: the cell in ``BENCHMARK.json``, its
configuration, traffic mix, limits, driver and metric readers.

Each piece lives in a file of its own, so a later change adds a cell, a
configuration, a mix or a metric by adding files and entries only:

* ``configs/<config>.json``: a model configuration (its ``path`` names
  the driver);
* ``traffic/<mix>.json``: a traffic mix, whose ``kind`` names its
  generator;
* ``generators/<kind>.py``: makes a kind of mix's inputs from the seed
  (``batches`` for the ``train`` driver, ``requests`` for ``serve``);
* ``limits/<workload>.json``: the limit of each number the cell's
  comparison reads;
* ``drivers/<path>.py``: drives one path of the program (``run(ctx)``);
* ``metrics/<name>.py``: one metric; dots in the name become ``_`` in the
  file name, and the file declares ``NAME``, the name it serves.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
# Top-level module names no run may hold: the JAX package and JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "kubeflow_tpu")


@dataclasses.dataclass
class RunContext:
    """What a driver's ``run`` gets: the cell's entry, its configuration,
    traffic mix and limits as read, and the run's arguments. ``t0`` is the
    process's start on ``time.perf_counter``'s clock."""

    workload: dict
    config: dict
    traffic: dict
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: Any
    tmpdir: str
    t0: float


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_module(path: Path) -> ModuleType:
    """Import the file ``path`` as a module of its own."""
    name = "kfxbench_" + "_".join(path.relative_to(BENCH_DIR).with_suffix(
        "").parts).replace("-", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def driver(path_name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    return load_module(bench_dir / "drivers" / f"{path_name}.py")


def generator(kind: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    return load_module(bench_dir / "generators" / f"{kind}.py")


def metric(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    mod = load_module(bench_dir / "metrics" / (name.replace(".", "_")
                                              + ".py"))
    if mod.NAME != name:
        raise ValueError(f"metrics file for {name!r} declares {mod.NAME!r}")
    return mod


def cell_metrics(bench: dict, workload: str, section: str) -> List[dict]:
    """The entries of ``section`` ("end_to_end" or "per_layer") that the
    cell reports: those without ``workloads`` and those that list it."""
    return [m for m in bench[section]
            if "workloads" not in m or workload in m["workloads"]]


def forbidden_modules(modules: Dict[str, object] = None) -> List[str]:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (``kubeflow_tpu_torch`` is not ``kubeflow_tpu``)."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)
