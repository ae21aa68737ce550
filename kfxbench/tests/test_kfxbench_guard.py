"""Nothing of JAX or of the JAX package reaches a run, and the reference
imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import ROOT
from kfxbench.core import bench as bench_mod

BENCH = ROOT / "kfxbench"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


def _top(name: str) -> str:
    return name.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax_or_the_jax_package(path):
    found = {m for m in _imports(path)
             if _top(m) in bench_mod.FORBIDDEN}
    assert not found, f"{path} imports {found}"
    text = path.read_text()
    for name in ("bench.py", "chip_smoke"):
        assert f"import {name.split('.')[0]}\n" not in text


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    found = {m for m in _imports(path) if _top(m) == "kubeflow_tpu_torch"
             or _top(m) == "kfxbench"}
    assert not found, f"{path} imports {found}"


def test_guard_compares_whole_top_level_names():
    mods = {"kubeflow_tpu_torch": 1, "kubeflow_tpu_torch.serving": 1,
            "jaxtyping": 1, "numpy": 1}
    assert bench_mod.forbidden_modules(mods) == []
    mods.update({"kubeflow_tpu.api": 1, "jax.numpy": 1, "flax": 1})
    assert bench_mod.forbidden_modules(mods) == ["flax", "jax.numpy",
                                                 "kubeflow_tpu.api"]


def test_a_run_loads_nothing_forbidden():
    code = "\n".join([
        f"import sys; sys.path.insert(0, {str(BENCH / 'tests')!r})",
        "from conftest import bench, tiny_context",
        "from kfxbench import run as harness",
        "from kfxbench.core import bench as b",
        "ctx = tiny_context('dsllm7b-serve-sessions', seconds=1.0)",
        "harness.drive(bench(), ctx)",
        "print(b.forbidden_modules())"])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_means_no_result():
    out = subprocess.run(
        [sys.executable, "kfxbench/run.py", "--workload",
         "dsllm7b-serve-chat", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert "correct" not in out.stdout
