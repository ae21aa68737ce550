"""The port stands alone: kubeflow_tpu_torch and chip_smoke.py import no
JAX-family package, no msgpack (the card's machine has none) and nothing
of kubeflow_tpu, and call no library attention kernel or
torch.compile. TensorFlow, scikit-learn and joblib (also absent there) are
imported only inside the host-only predictors' and runner's functions:
every module, chip_smoke.py and tests/test_torch_cuda.py import with them
blocked."""

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
HOST_ONLY = ("tensorflow", "sklearn", "joblib")

_BLOCKER = f"""
import importlib, importlib.util, pkgutil, sys
BANNED = {BANNED + HOST_ONLY!r}

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
spec = importlib.util.spec_from_file_location(
    "test_torch_cuda", {os.path.join(REPO, "tests", "test_torch_cuda.py")!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [m for m in sys.modules if m.split(".")[0] in BANNED]
assert not bad, bad
# The control plane (kfx run) imports whole, with no kubeflow_tpu module:
# neither the reference's vmeshenv (its virtual TPU mesh) nor testenv.
import kubeflow_tpu_torch.cli, kubeflow_tpu_torch.controlplane
assert "kubeflow_tpu.vmeshenv" not in sys.modules
assert "kubeflow_tpu.testenv" not in sys.modules
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
    assert len(_modules()) >= 108
    # The serving engine, its prefix keying, its usage ledger, its KV
    # transfer plane, its weight pool with the storage initializer and
    # its flight recorder are on the list, the classifier / JAXJob path,
    # and the chaos points with the runner's startup hook.
    assert {"kubeflow_tpu_torch.chaos",
            "kubeflow_tpu_torch.serving.kvtransfer",
            "kubeflow_tpu_torch.serving.weights",
            "kubeflow_tpu_torch.serving.storage",
            "kubeflow_tpu_torch.runtime",
            "kubeflow_tpu_torch.runtime.rendezvous",
            "kubeflow_tpu_torch.serving.engine",
            "kubeflow_tpu_torch.serving.prefix",
            "kubeflow_tpu_torch.serving.metering",
            "kubeflow_tpu_torch.obs.flightrec",
            "kubeflow_tpu_torch.data.synthetic",
            "kubeflow_tpu_torch.models.registry",
            "kubeflow_tpu_torch.models.layers",
            "kubeflow_tpu_torch.models.mlp",
            "kubeflow_tpu_torch.models.cnn",
            "kubeflow_tpu_torch.models.resnet",
            "kubeflow_tpu_torch.models.vit",
            "kubeflow_tpu_torch.training",
            "kubeflow_tpu_torch.training.loop",
            "kubeflow_tpu_torch.training.checkpoint",
            "kubeflow_tpu_torch.runners.jax_runner",
            "kubeflow_tpu_torch.serving.export",
            # the Kubeflow compat surface: the other framework predictors,
            # the TFJob/PyTorchJob/MPIJob workers and what they share
            "kubeflow_tpu_torch.serving.torch_server",
            "kubeflow_tpu_torch.serving.tf_server",
            "kubeflow_tpu_torch.serving.sklearn_server",
            "kubeflow_tpu_torch.runners.torch_runner",
            "kubeflow_tpu_torch.runners.tf_runner",
            "kubeflow_tpu_torch.runners.mpi_launcher",
            "kubeflow_tpu_torch.runners.mpi_jax_runner",
            "kubeflow_tpu_torch.runtime.lifetime",
            "kubeflow_tpu_torch.utils.net",
            # the LM trainer across ranks
            "kubeflow_tpu_torch.parallel.mesh",
            "kubeflow_tpu_torch.parallel.comm",
            "kubeflow_tpu_torch.parallel.ring_attention",
            "kubeflow_tpu_torch.parallel.pipeline",
            "kubeflow_tpu_torch.parallel.overlap",
            "kubeflow_tpu_torch.parallel.spmd_check",
            # the training control plane
            "kubeflow_tpu_torch.utils.proc",
            "kubeflow_tpu_torch.api",
            "kubeflow_tpu_torch.api.base",
            "kubeflow_tpu_torch.api.training",
            "kubeflow_tpu_torch.api.manifest",
            "kubeflow_tpu_torch.api.katib",
            "kubeflow_tpu_torch.api.serving",
            "kubeflow_tpu_torch.api.pipelines",
            "kubeflow_tpu_torch.api.platform",
            "kubeflow_tpu_torch.api.slo",
            "kubeflow_tpu_torch.core",
            "kubeflow_tpu_torch.core.store",
            "kubeflow_tpu_torch.core.workqueue",
            "kubeflow_tpu_torch.core.controller",
            "kubeflow_tpu_torch.runtime.gang",
            "kubeflow_tpu_torch.sched",
            "kubeflow_tpu_torch.sched.scheduler",
            "kubeflow_tpu_torch.operators",
            "kubeflow_tpu_torch.operators.training",
            "kubeflow_tpu_torch.controlplane",
            "kubeflow_tpu_torch.cli",
            # the serving tier and its SavedModel exporter
            "kubeflow_tpu_torch.serving.tf_models",
            "kubeflow_tpu_torch.serving.router",
            "kubeflow_tpu_torch.serving.autoscaler",
            "kubeflow_tpu_torch.serving.graph",
            "kubeflow_tpu_torch.obs.tsdb",
            "kubeflow_tpu_torch.operators.serving",
            # Katib and NAS
            "kubeflow_tpu_torch.hpo",
            "kubeflow_tpu_torch.hpo.algorithms",
            "kubeflow_tpu_torch.hpo.collector",
            "kubeflow_tpu_torch.hpo.jsonrpc",
            "kubeflow_tpu_torch.hpo.service",
            "kubeflow_tpu_torch.hpo.dbmanager",
            "kubeflow_tpu_torch.hpo.darts",
            "kubeflow_tpu_torch.hpo.enas",
            "kubeflow_tpu_torch.operators.hpo",
            "kubeflow_tpu_torch.runners.darts_runner",
            "kubeflow_tpu_torch.runners.enas_runner",
            # pipelines, platform and SLOs, the rule engine and the
            # timeline
            "kubeflow_tpu_torch.utils.template",
            "kubeflow_tpu_torch.operators.pipelines",
            "kubeflow_tpu_torch.operators.platform",
            "kubeflow_tpu_torch.operators.slo",
            "kubeflow_tpu_torch.obs.rules",
            "kubeflow_tpu_torch.obs.slo",
            "kubeflow_tpu_torch.obs.timeline",
            # the apiserver, kfctl and the profiler
            "kubeflow_tpu_torch.apiserver",
            "kubeflow_tpu_torch.kfctl",
            "kubeflow_tpu_torch.profiling"} <= set(_modules())


def test_hpo_turns_grpc_fork_support_off():
    """The plane forks its gangs beside live gRPC servers: importing the
    HPO seams sets GRPC_ENABLE_FORK_SUPPORT=false before grpc loads, and
    leaves a value the environment already has."""
    code = ("import os, sys; sys.path.insert(0, %r)\n"
            "import kubeflow_tpu_torch.hpo.dbmanager\n"
            "import kubeflow_tpu_torch.hpo.service\n"
            "print(os.environ.get('GRPC_ENABLE_FORK_SUPPORT'))" % REPO)
    env = {k: v for k, v in os.environ.items()
           if k != "GRPC_ENABLE_FORK_SUPPORT"}
    for preset, want in ((None, "false"), ("true", "true")):
        if preset:
            env["GRPC_ENABLE_FORK_SUPPORT"] = preset
        res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=120,
                             env=env)
        assert res.returncode == 0, res.stderr
        assert res.stdout.strip() == want


def test_plane_loads_no_nas_module():
    """The control plane reaches the HPO package for its algorithms,
    collector and services; the torch supernets (hpo.darts, hpo.enas)
    load only in a NAS trial's process."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import kubeflow_tpu_torch.cli, kubeflow_tpu_torch.hpo\n"
            "import kubeflow_tpu_torch.operators.hpo\n"
            "print(sorted(m for m in sys.modules if m.endswith(("
            "'.darts', '.enas')) or m == 'torch'))" % REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout


def test_server_and_cli_import_no_torch():
    """`kfx server` and the CLI stay torch-free processes: importing the
    apiserver, kfctl, the profiler's client and the CLI loads neither
    torch nor grpc; only a job's workers touch the card."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import kubeflow_tpu_torch.apiserver, kubeflow_tpu_torch.kfctl\n"
            "import kubeflow_tpu_torch.cli, kubeflow_tpu_torch.profiling\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'grpc')))" % REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout


def test_savedmodel_exporter_imports_no_tensorflow():
    """The exporter and its TensorFlow rebuild import TensorFlow inside
    their functions only: importing the modules loads none of it (the
    card's machine has no TensorFlow)."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import kubeflow_tpu_torch.serving.tf_server\n"
            "import kubeflow_tpu_torch.serving.tf_models\n"
            "bad = [m for m in sys.modules if m.split('.')[0] == "
            "'tensorflow']\n"
            "assert not bad, bad\n"
            "print('ok')" % REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr



def test_device_layer_imports_no_control_plane():
    """device.py sits under the kernels, the models and serving: importing
    it loads none of the control plane (runtime, api, operators, sched,
    core)."""
    code = ("import sys, kubeflow_tpu_torch.device; print(sorted("
            "m for m in sys.modules if m.split('.')[0] == "
            "'kubeflow_tpu_torch' and m.split('.')[1:2] in (['runtime'], "
            "['api'], ['operators'], ['sched'], ['core'], "
            "['controlplane'])))")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout

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
    # The reference's virtual-mesh recipe and its pytest plugin stay
    # the reference's: the port's operators launch ranks instead.
    assert not re.search(r"\b(vmeshenv|testenv|virtual_mesh_env)\b",
                         src), path
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
