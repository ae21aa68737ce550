"""MPIJob worker — port of ``kubeflow_tpu/runners/mpi_jax_runner.py``:
Horovod-era env in, torch.distributed out.

Acceptance config #3 (BASELINE.md): "MPIJob Horovod ResNet on CIFAR-10".
This adapter maps the OpenMPI rank env (set by the mpirun shim,
``runners/mpi_launcher.py``, or the MPIJob operator) onto the KFX
rendezvous contract and delegates to the port's JAXJob runner, which
trains data-parallel over ``torch.distributed``:

    python -m kubeflow_tpu_torch.runners.mpi_launcher -np 2 \\
        python -m kubeflow_tpu_torch.runners.mpi_jax_runner \\
        --model=resnet18 --dataset=cifar10 --steps=20 --batch-size=64
"""

from __future__ import annotations

import os
import sys

from .jax_runner import main as jax_main


def main(argv=None) -> int:
    rank = os.environ.get("OMPI_COMM_WORLD_RANK", "0")
    size = os.environ.get("OMPI_COMM_WORLD_SIZE", "1")
    os.environ["KFX_PROCESS_ID"] = rank
    os.environ["KFX_NUM_PROCESSES"] = size
    # The mpirun shim exports a shared rendezvous address; without one
    # (single rank) the runner stays single-process.
    if int(size) > 1 and "KFX_COORDINATOR_ADDRESS" not in os.environ:
        print("mpi_jax_runner: OMPI_COMM_WORLD_SIZE>1 but no "
              "KFX_COORDINATOR_ADDRESS (launch via the mpirun shim)",
              file=sys.stderr)
        return 2
    return jax_main(argv)


if __name__ == "__main__":
    from ..runtime.lifetime import install_parent_watch

    install_parent_watch()   # die with the gang supervisor
    sys.exit(main())
