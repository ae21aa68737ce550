"""Local mpirun shim for MPIJob launcher commands — the port's copy of
``kubeflow_tpu/runners/mpi_launcher.py`` (JAX-free; its imports come from
the port).

The reference's mpi-operator launcher runs `mpirun`, which kubexec's one
process per hostfile slot into the worker pods (SURVEY.md §2.1). This
single-host environment has no MPI runtime, so the operator rewrites
`mpirun ...` in the Launcher template to this module, which implements the
same contract locally: parse the common OpenMPI flag subset, spawn one
local process per rank with the OMPI_COMM_WORLD_* environment Horovod-era
scripts read, propagate `-x` env, forward signals, and exit non-zero if
any rank fails.

Usage (what the operator execs):
    python -m kubeflow_tpu_torch.runners.mpi_launcher -np 4 [-x VAR[=VAL]] ... \
        python train.py --args
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
from typing import Dict, List, Optional, Tuple


# Flags taking one argument that the shim accepts and ignores (placement/
# transport knobs that have no meaning for local processes).
_IGNORED_WITH_ARG = {
    "--hostfile", "-hostfile", "--machinefile", "-machinefile",
    "-H", "--host", "-host",
    "-bind-to", "--bind-to", "-map-by", "--map-by",
    "-rf", "--rankfile", "--prefix", "-wdir", "--wdir",
}
# OpenMPI's -mca takes TWO arguments (key value).
_IGNORED_WITH_TWO_ARGS = {"-mca", "--mca", "-gmca", "--gmca"}
_IGNORED_BARE = {
    "--allow-run-as-root", "--oversubscribe", "-oversubscribe",
    "--tag-output", "-tag-output", "-q", "--quiet", "--display-map",
}


def parse_argv(argv: List[str]) -> Tuple[int, Dict[str, str], List[str]]:
    """Returns (np, extra_env, command). np=0 means 'from hostfile slots or
    KFX_MPI_WORLD_SIZE'."""
    np = 0
    extra_env: Dict[str, str] = {}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-np", "-n", "--np", "-c"):
            np = int(argv[i + 1])
            i += 2
        elif a == "-x":
            spec = argv[i + 1]
            if "=" in spec:
                k, _, v = spec.partition("=")
                extra_env[k] = v
            elif spec in os.environ:
                extra_env[spec] = os.environ[spec]
            i += 2
        elif a in _IGNORED_WITH_TWO_ARGS:
            i += 3
        elif a in _IGNORED_WITH_ARG:
            i += 2
        elif a in _IGNORED_BARE:
            i += 1
        elif a.startswith("-"):
            # Unknown flag: assume it takes no argument; warn.
            print(f"mpi_launcher: ignoring unknown flag {a}", file=sys.stderr)
            i += 1
        else:
            return np, extra_env, argv[i:]
    return np, extra_env, []


def _hostfile_slots() -> int:
    path = os.environ.get("KFX_HOSTFILE") or \
        os.environ.get("OMPI_MCA_orte_default_hostfile", "")
    if not path or not os.path.exists(path):
        return 0
    total = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            slots = 1
            for tok in line.split()[1:]:
                if tok.startswith("slots="):
                    slots = int(tok.split("=", 1)[1])
            total += slots
    return total


def main(argv: Optional[List[str]] = None) -> int:
    from ..runtime import lifetime

    lifetime.install_parent_watch()  # die with the gang supervisor
    argv = sys.argv[1:] if argv is None else argv
    np, extra_env, cmd = parse_argv(argv)
    if not cmd:
        print("mpi_launcher: no command given", file=sys.stderr)
        return 2
    if np <= 0:
        np = _hostfile_slots() or int(os.environ.get("KFX_MPI_WORLD_SIZE", 1))
    if np <= 0:
        print("mpi_launcher: resolved world size is 0 (empty hostfile and "
              "no -np); refusing to vacuously succeed", file=sys.stderr)
        return 2

    # Shared torch.distributed rendezvous address for the JAXJob ranks (the
    # mpi_jax_runner adapter): allocated here so every rank sees the same
    # address before any process starts — same role as the operator's
    # KFX_COORDINATOR_ADDRESS injection for JAXJob.
    coordinator = os.environ.get("KFX_COORDINATOR_ADDRESS")
    if coordinator is None and np > 1:
        from ..utils.net import free_port

        coordinator = f"127.0.0.1:{free_port()}"

    procs: List[subprocess.Popen] = []

    def forward(signum, frame):  # pragma: no cover - signal path
        for p in procs:
            try:
                p.send_signal(signum)
            except ProcessLookupError:
                pass

    signal.signal(signal.SIGTERM, forward)
    signal.signal(signal.SIGINT, forward)

    # Ranks must die with the launcher the same way the launcher dies with
    # its gang supervisor: fresh keepalive pipe + PDEATHSIG. The gang's own
    # pipe can't be reused — install_parent_watch above consumed it (its
    # watcher thread owns the read end, now non-inheritable), and its EOF
    # means "gang supervisor died", not "launcher died".
    ka_r, ka_w = os.pipe()
    preexec = lifetime.make_child_preexec(os.getpid())
    for rank in range(np):
        env = dict(os.environ)
        env.update(extra_env)
        env.update({
            "OMPI_COMM_WORLD_RANK": str(rank),
            "OMPI_COMM_WORLD_SIZE": str(np),
            "OMPI_COMM_WORLD_LOCAL_RANK": str(rank),
            "OMPI_COMM_WORLD_LOCAL_SIZE": str(np),
            "PMI_RANK": str(rank),
            "PMI_SIZE": str(np),
            lifetime.PARENT_FD_ENV: str(ka_r),
        })
        if coordinator:
            env["KFX_COORDINATOR_ADDRESS"] = coordinator
        # Own session per rank: its EOF handler killpg(0)s only its own
        # subtree, and signal forwarding below is already explicit.
        procs.append(subprocess.Popen(cmd, env=env, pass_fds=(ka_r,),
                                      preexec_fn=preexec,
                                      start_new_session=True))

    # Poll ALL ranks so a crash in any rank aborts the job even while
    # earlier ranks are blocked in collectives (mpirun fail-fast semantics).
    import time

    rc = 0
    live = set(range(np))
    while live:
        for r in sorted(live):
            code = procs[r].poll()
            if code is None:
                continue
            live.discard(r)
            if code != 0 and rc == 0:
                rc = code
                for q in procs:
                    if q.poll() is None:
                        q.terminate()
        if live:
            time.sleep(0.05)
    return rc


if __name__ == "__main__":
    sys.exit(main())
