"""Child-process lifetime hardening: no gang member outlives its supervisor
(the port's copy of ``kubeflow_tpu/runtime/lifetime.py``).

The reference gets this from the kernel for free — kubelet kills a pod's
cgroup when the pod goes away (SURVEY.md §2.1 common lib / §5.3). With
local OS processes the failure mode is real: if the supervising process is
SIGKILLed (a supervisor's timeout, OOM killer), plain `start_new_session` children
are reparented to init and keep running. Two independent mechanisms close
it, belt and braces:

  1. **PR_SET_PDEATHSIG** (Linux): every spawned member asks the kernel to
     SIGKILL it when its parent dies. Installed via `preexec_fn` before
     exec, so it covers arbitrary container commands, not just our
     runners. Caveat the code must respect: the signal fires when the
     *forking thread* exits, not only the process — so the gang's
     supervisor thread must stay alive while any member it forked still
     runs (see Gang._supervise's linger).
  2. **Keepalive pipe** (portable): members inherit the read end of a pipe
     whose write end only the supervisor holds (KFX_PARENT_FD). Our
     runners call `install_parent_watch()`, which parks a daemon thread on
     a blocking read; EOF means the supervisor is gone and the watcher
     SIGKILLs the member's own process group (taking any grandchildren
     with it). This also covers non-Linux and the supervisor-thread-died
     edge that PDEATHSIG alone cannot distinguish from process death.
"""

from __future__ import annotations

import ctypes
import os
import signal
import threading

PR_SET_PDEATHSIG = 1

PARENT_FD_ENV = "KFX_PARENT_FD"

try:  # resolved once in the parent; calling after fork is then safe
    _libc = ctypes.CDLL(None, use_errno=True)
    _prctl = _libc.prctl
except (OSError, AttributeError):  # non-Linux libc layouts
    _prctl = None


def make_child_preexec(parent_pid: int):
    """Build the `preexec_fn` for gang members: die-with-parent via
    PR_SET_PDEATHSIG, closing the fork→prctl race by re-checking that the
    parent is still the one we were forked from.

    Known tradeoff: `preexec_fn` from a multithreaded parent is
    documented deadlock-prone (the child could block on an allocator lock
    another thread held at fork time, before exec). The body is kept to
    two pre-resolved calls to minimise the window, and the keepalive pipe
    exists precisely so correctness never rests on this path alone."""
    if _prctl is None:
        return None

    def _preexec() -> None:
        _prctl(PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0)
        if os.getppid() != parent_pid:  # parent died before prctl took hold
            os._exit(1)

    return _preexec


def install_parent_watch() -> bool:
    """Runner-side half: block a daemon thread on the inherited keepalive
    pipe; on EOF (supervisor gone) SIGKILL our own process group. Falls
    back to polling getppid() when no pipe was passed (e.g. a runner
    started by hand). Returns True if a watcher was installed."""
    fd_s = os.environ.get(PARENT_FD_ENV, "")

    def _die() -> None:
        try:
            # Take our own subtree only when we lead the group (gang
            # members are session leaders via start_new_session); a
            # hand-started runner shares its parent's group, where
            # killpg(0) would blast unrelated siblings.
            if os.getpgrp() == os.getpid():
                os.killpg(0, signal.SIGKILL)
            os.kill(os.getpid(), signal.SIGKILL)
        except Exception:
            os._exit(1)

    if fd_s:
        # Scrub the env var: in a grandchild the fd number is recycled, and
        # arming a watcher on an unrelated fd would steal its bytes and
        # kill on its EOF. Anyone re-pointing children at a fresh pipe sets
        # it explicitly (see mpi_launcher).
        os.environ.pop(PARENT_FD_ENV, None)
        try:
            fd = int(fd_s)
            os.set_inheritable(fd, False)  # don't leak into our children
        except (ValueError, OSError):
            fd = -1  # stale fd (e.g. closed by close_fds in a grandchild)

        if fd >= 0:
            def _watch_pipe() -> None:
                try:
                    while os.read(fd, 1):  # supervisor writes nothing;
                        pass                # EOF = dead
                except OSError:
                    pass
                _die()

            threading.Thread(target=_watch_pipe, name="kfx-parent-watch",
                             daemon=True).start()
            return True
        # fall through to the ppid poll: a bad fd must degrade to the
        # weaker watch, never to no watch at all

    parent = os.getppid()
    if parent <= 1:  # already orphaned, or direct child of init
        return False

    def _watch_ppid() -> None:
        import time
        while os.getppid() == parent:
            time.sleep(1.0)
        _die()

    threading.Thread(target=_watch_ppid, name="kfx-parent-watch",
                     daemon=True).start()
    return True
