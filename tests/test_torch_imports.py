"""The port stands alone: kubeflow_tpu_torch and chip_smoke.py import no
JAX-family package, no msgpack (the card's machine has none) and nothing
of kubeflow_tpu, and call no library attention kernel or
torch.compile."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest

pytest.importorskip("jax")  # the card's machine runs these with no JAX

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "kubeflow_tpu_torch")
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack",
          "kubeflow_tpu")

_BLOCKER = f"""
import importlib, pkgutil, sys
BANNED = {BANNED!r}

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("blocked import of " + name)
        return None

for name in list(sys.modules):
    if name.split(".")[0] in BANNED:
        del sys.modules[name]
sys.meta_path.insert(0, Blocker())
sys.path.insert(0, {REPO!r})
import kubeflow_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    kubeflow_tpu_torch.__path__, "kubeflow_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = [m for m in sys.modules if m.split(".")[0] in BANNED]
assert not bad, bad
print("imported", len(names))
"""


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG], "kubeflow_tpu_torch."))


def test_every_module_imports_with_jax_blocked():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _BLOCKER], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert res.returncode == 0, res.stderr
    assert f"imported {len(_modules())}" in res.stdout
    assert len(_modules()) >= 20


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(root, f)


_IMPORT = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|jaxlib|flax|optax|orbax|msgpack|"
    r"kubeflow_tpu(?!_torch))\b|import_module\(\s*['\"]kubeflow_tpu(?!_)",
    re.M)


@pytest.mark.parametrize("path", sorted(_sources()) + [
    os.path.join(REPO, "chip_smoke.py")], ids=lambda p: os.path.relpath(
        p, REPO))
def test_source_has_no_banned_import(path):
    src = open(path).read()
    assert not _IMPORT.search(src), _IMPORT.search(src).group(0)
    if path.endswith(".py") and not path.endswith("chip_smoke.py"):
        assert "scaled_dot_product_attention" not in src
        assert "torch.compile" not in src
    if path.endswith((".cu", ".cuh")):
        # The CUDA toolkit's own headers and the port's; no torch headers
        # (plain C interface) and no library of finished kernels.
        includes = re.findall(r'#include\s*[<"]([^>"]+)[>"]', src)
        assert set(includes) <= {"cuda.h", "cuda_runtime.h", "cuda_bf16.h",
                                 "stddef.h", "stdint.h", "flash_common.cuh",
                                 "hopper.cuh"}, includes


def test_chip_smoke_names_sdpa_only_for_library_timing():
    """chip_smoke.py may call PyTorch's fused attention only as the
    library_ms yardstick, inside kernel_phase."""
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    funcs = re.split(r"^def ", src, flags=re.M)
    users = [f.split("(")[0] for f in funcs
             if "scaled_dot_product_attention" in f]
    assert users == ["kernel_phase"]
    assert "torch.compile" not in src
